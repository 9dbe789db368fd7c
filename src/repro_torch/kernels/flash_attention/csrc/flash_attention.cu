// Flash attention forward for Hopper (sm_90a): causal / sliding-window
// attention with GQA, float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (body _flash_fwd_kernel). Same function: query head h
// reads kv head h / G, masked logits are -1e30, scale 1/sqrt(hd), output
// acc / max(l, 1e-30) in q's dtype.
//
// Design. One block per (b*h, 32-row query tile), 128 threads, four threads
// per query row. The Pallas grid's sequential kv axis (m/l/acc carried in
// VMEM scratch) becomes a loop over 32-key tiles inside the block, with m, l
// and the row's hd-wide accumulator in registers (hd/4 floats per thread).
// The kernel is a template on the head dim, instantiated at 128 (qwen2-7b)
// and 256 (recurrentgemma-2b: 64 accumulator floats a thread, ~103 KB of
// shared tiles, two blocks an SM).
// Only the kv tiles the query tile can see are visited: tiles above the
// diagonal or wholly outside the window are skipped (the Pallas grid visits
// and masks them). q/k/v are read through strides in the model layout
// [B, S, H, hd] / [B, S, K, hd], so no transposed copy is made. The ragged
// tail (S not a multiple of 32) is masked.
//
// Bound on H100. At the serving prefill shape (B=4, S=512, H=28, hd=128, bf16)
// the causal work is ~7.5 GFLOP against ~34 MB of q/k/v/out: ~8 us at the
// bf16 tensor-core rate and ~10 us at the HBM rate, so the shape sits near
// the ridge; at recurrentgemma-2b's (H=10, K=1, hd=256) it is ~5.4 GFLOP
// against ~23 MB, ~5.4 us and ~6.9 us. This first version does its products with float32 FMAs on CUDA
// cores from padded shared-memory tiles (conflict-free reads), so it is
// limited by shared-memory bandwidth and the FP32 rate, far above that
// bound; moving QK^T and PV onto wgmma with TMA-fed tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;           // query rows per block
constexpr int BK = 32;           // keys per kv tile
constexpr int THREADS = 128;     // 4 threads per query row
constexpr int COLS = BK / 4;     // score columns per thread
constexpr float NEG_INF = -1e30f;

template <int HD>                // head dim: 128 or 256
constexpr int smem_floats() { return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, float scale) {
  constexpr int DPT = HD / 4;          // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD+1]  (padded: no bank conflicts)
  float* Ks = Qs + BQ * (HD + 1);      // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int r = t >> 2;                // this thread's query row in the tile
  const int c0 = t & 3;                // its first score / accumulator column
  const int qi = q0 + r;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int e = t; e < BQ * HD; e += THREADS) {
    const int row = e / HD, d = e % HD;
    const int qr = q0 + row;
    Qs[row * (HD + 1) + d] = qr < S ? to_float(qb[qr * q_ss + d]) : 0.f;
  }

  // kv tiles this query tile can see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_end = (kv_end + BK - 1) / BK;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int tile = kv_begin / BK; tile < tile_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                   // previous K/V consumed, Q stored
    for (int e = t; e < BK * HD; e += THREADS) {
      const int row = e / HD, d = e % HD;
      const int kr = k0 + row;
      const bool in = kr < S;
      Ks[row * (HD + 1) + d] = in ? to_float(kb[kr * k_ss + d]) : 0.f;
      Vs[row * HD + d] = in ? to_float(vb[kr * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * (HD + 1);
    const float* kcol = Ks + c0 * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[j] = fmaf(qd, kcol[4 * j * (HD + 1) + d], s[j]);
    }

    bool valid[COLS];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int ki = k0 + c0 + 4 * j;
      valid[j] = ki < S && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
      s[j] = valid[j] ? s[j] * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // the four threads of a row are neighbouring lanes
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = valid[j] ? expf(s[j] - m_new) : 0.f;
      rowsum += p;
      Ps[r * (BK + 1) + c0 + 4 * j] = p;
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
    l = l * alpha + rowsum;
    m = m_new;
    __syncwarp();                      // a row's P is written and read in one warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    const float* prow = Ps + r * (BK + 1);
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * HD + c0;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[c0 + 4 * j] = from_float<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   const int64_t* os, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, H / K,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o,
                              int B, int S, int H, int K, int hd, const int64_t* qs,
                              const int64_t* ks, const int64_t* vs, const int64_t* os,
                              int causal, int window, float scale, cudaStream_t st) {
  if (hd == 128)
    return launch<T, 128>(q, k, v, o, B, S, H, K, qs, ks, vs, os, causal, window, scale, st);
  if (hd == 256)
    return launch<T, 256>(q, k, v, o, B, S, H, K, qs, ks, vs, os, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 128 or 256. Strides are in elements,
// ordered (batch, seq, head); the head dim must be contiguous. Returns a cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int S, int H,
                                   int K, int hd, const int64_t* q_strides,
                                   const int64_t* k_strides,
                                   const int64_t* v_strides,
                                   const int64_t* o_strides, int causal,
                                   int window, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || B * H > 65535 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, o, B, S, H, K, hd, q_strides, k_strides,
                                         v_strides, o_strides, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, o, B, S, H, K, hd, q_strides,
                                                 k_strides, v_strides, o_strides, causal,
                                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
