// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the causal /
// sliding-window GQA attention that flash_attention.cu computes.
//
// Replaces: nothing on the TPU. The JAX package trains through XLA autodiff
// of its pure-JAX chunked_causal_attention (src/repro/models/attention.py:83)
// and has no backward kernel; the port's models run the forward kernel
// (src/repro/kernels/flash_attention/kernel.py:80, flash_attention_fwd) when
// they train, so its gradient is a kernel too.
//
// Function, in float32 whatever the inputs' dtype, with the forward's mask
// (key ki visible to query qi iff ki <= qi when causal and ki > qi - window
// when window > 0), scale 1/sqrt(hd) and kv head h / G for query head h:
//   P     = exp(Q K^T * scale - lse)        (lse: the forward's [B, H, S])
//   delta = rowsum(dO o O)
//   dV    = P^T dO,   dS = P o (dO V^T - delta)
//   dQ    = dS K * scale,   dK = dS^T Q * scale
// dq, dk and dv are written in the inputs' dtype. Layout: contiguous
// [B, S, heads, hd]; head_dim 16, 64, 128 or 256; float32 or bfloat16.
//
// Bound on H100. The work is five products over the visible (query, key)
// area, ~5 x 2 x B H S W_eff hd FLOP; at recurrentgemma-2b's training shape
// (B 1, S 3072, H 10, K 1, hd 256, window 2048) ~107 GFLOP against ~69 MB
// of q, k, v, o, dO, lse and the three gradients: 0.11 ms of bf16
// tensor-core time, 0.021 ms of HBM time, so operations bound it.
//
// Design: a first, simple version on CUDA cores (float32 FMAs; bf16 is
// widened as it is staged), two kernels on one stream, no atomics:
// * flash_bwd_dq_kernel: one block per (32-row query tile, b * H), four
//   threads a row. It computes delta for its rows (stored for the second
//   kernel), then walks the key tiles the rows can see (as the forward
//   does), recomputes P and dP for 8 key columns a thread, stores dS in
//   shared memory and accumulates dQ (hd / 4 columns a thread) in registers.
// * flash_bwd_dkdv_kernel: one block per (16-key tile, b * K), eight
//   threads a key. Its K and V rows stay in shared memory; it walks the G
//   query heads of its group and, for each, the query tiles that can see its
//   keys ([k0, k0 + 16 - 1 + window - 1] with a window), recomputing P^T and
//   dP^T for 4 query columns a thread, and accumulates dK and dV (hd / 8
//   columns each a thread) in registers. The group's heads are summed in
//   order inside the block, so a run is deterministic.
// The products read their operands from padded float tiles in shared memory
// (~1 load an FMA), so the kernels are bound by shared-memory bandwidth and
// far from the tensor-core bound. At recurrentgemma-2b's shape the dK/dV
// kernel has 192 blocks for 132 SMs (one kv head); wgmma tiles and a split
// of the query range are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qi, int ki, int S, int causal, int window) {
  return qi < S && ki < S && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
}

constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// dQ (and delta): one block per (32-row query tile, b * H)
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 32;            // query rows a block
constexpr int DQ_BK = 32;            // keys a tile
constexpr int DQ_COLS = DQ_BK / 4;   // key columns a thread

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * DQ_BQ + 2 * DQ_BK) * (HD + 1) + DQ_BQ * (DQ_BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int S, int H, int K, int causal, int window,
                    float scale) {
  constexpr int LD = HD + 1;         // padded rows: no bank conflicts
  constexpr int DPT = HD / 4;        // dQ columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][LD]
  float* dOs = Qs + DQ_BQ * LD;      // [BQ][LD]
  float* Ks = dOs + DQ_BQ * LD;      // [BK][LD]
  float* Vs = Ks + DQ_BK * LD;       // [BK][LD]
  float* dSs = Vs + DQ_BK * LD;      // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / (H / K);
  const int q0 = blockIdx.x * DQ_BQ;
  const int t = threadIdx.x, r = t >> 2, c0 = t & 3;
  const int qi = q0 + r;

  for (int e = t; e < DQ_BQ * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, qr = q0 + row;
    const int64_t idx = (((int64_t)b * S + qr) * H + h) * HD + d;
    Qs[row * LD + d] = qr < S ? to_float(q[idx]) : 0.f;
    dOs[row * LD + d] = qr < S ? to_float(dout[idx]) : 0.f;
  }
  // delta = rowsum(dO o O), the four threads of a row over interleaved columns
  float dl = 0.f;
  if (qi < S) {
    const int64_t base = (((int64_t)b * S + qi) * H + h) * HD;
    for (int d = c0; d < HD; d += 4) dl = fmaf(to_float(dout[base + d]), to_float(o[base + d]), dl);
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (qi < S && c0 == 0) delta[(int64_t)bh * S + qi] = dl;
  const float lrow = qi < S ? lse[(int64_t)bh * S + qi] : 0.f;

  // key tiles this query tile can see (the forward's range)
  const int q_last = min(q0 + DQ_BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_end = (kv_end + DQ_BK - 1) / DQ_BK;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int tile = kv_begin / DQ_BK; tile < tile_end; ++tile) {
    const int k0 = tile * DQ_BK;
    __syncthreads();                 // previous K/V and dS consumed, Q/dO stored
    for (int e = t; e < DQ_BK * HD; e += THREADS) {
      const int row = e / HD, d = e % HD, kr = k0 + row;
      const int64_t idx = (((int64_t)b * S + kr) * K + kh) * HD + d;
      Ks[row * LD + d] = kr < S ? to_float(k[idx]) : 0.f;
      Vs[row * LD + d] = kr < S ? to_float(v[idx]) : 0.f;
    }
    __syncthreads();

    float s[DQ_COLS], dp[DQ_COLS];
#pragma unroll
    for (int j = 0; j < DQ_COLS; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = Qs + r * LD;
    const float* grow = dOs + r * LD;
    const float* kcol = Ks + c0 * LD;
    const float* vcol = Vs + c0 * LD;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d], gd = grow[d];
#pragma unroll
      for (int j = 0; j < DQ_COLS; ++j) {
        s[j] = fmaf(qd, kcol[4 * j * LD + d], s[j]);
        dp[j] = fmaf(gd, vcol[4 * j * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < DQ_COLS; ++j) {
      const int ki = k0 + c0 + 4 * j;
      const float p = visible(qi, ki, S, causal, window) ? expf(fmaf(s[j], scale, -lrow)) : 0.f;
      dSs[r * (DQ_BK + 1) + c0 + 4 * j] = p * (dp[j] - dl);
    }
    __syncwarp();                    // a row's dS is written and read in one warp

    const float* srow = dSs + r * (DQ_BK + 1);
    for (int c = 0; c < DQ_BK; ++c) {
      const float ds = srow[c];
      const float* krow = Ks + c * LD + c0;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(ds, krow[4 * j], acc[j]);
    }
  }

  if (qi < S) {
    T* row = dq + (((int64_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) row[c0 + 4 * j] = from_float<T>(acc[j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block per (16-key tile, b * K), over the group's query heads
// ---------------------------------------------------------------------------

constexpr int KV_BK = 16;            // keys a block
constexpr int KV_BQ = 32;            // queries a tile
constexpr int KV_COLS = KV_BQ / 8;   // query columns a thread

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * KV_BK + 2 * KV_BQ) * (HD + 1) +
                          2 * KV_BK * (KV_BQ + 1) + 2 * KV_BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int H, int K, int causal,
                      int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / 8;        // dK and dV columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][LD]
  float* Vs = Ks + KV_BK * LD;       // [BK][LD]
  float* Qs = Vs + KV_BK * LD;       // [BQ][LD]
  float* dOs = Qs + KV_BQ * LD;      // [BQ][LD]
  float* Ps = dOs + KV_BQ * LD;      // [BK][BQ + 1]: P^T
  float* dSs = Ps + KV_BK * (KV_BQ + 1);   // [BK][BQ + 1]: dS^T
  float* Ls = dSs + KV_BK * (KV_BQ + 1);   // [BQ]: lse of the tile's queries
  float* Ds = Ls + KV_BQ;                  // [BQ]: delta

  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int k0 = blockIdx.x * KV_BK;
  const int t = threadIdx.x, kr = t >> 3, c0 = t & 7;
  const int ki = k0 + kr;

  for (int e = t; e < KV_BK * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, kk = k0 + row;
    const int64_t idx = (((int64_t)b * S + kk) * K + kh) * HD + d;
    Ks[row * LD + d] = kk < S ? to_float(k[idx]) : 0.f;
    Vs[row * LD + d] = kk < S ? to_float(v[idx]) : 0.f;
  }

  // query tiles that can see these keys
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + KV_BK - 1 + window) : S;
  const int qt_end = (q_end + KV_BQ - 1) / KV_BQ;

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t lrow = ((int64_t)b * H + h) * S;
    for (int qt = q_begin / KV_BQ; qt < qt_end; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();               // previous Q/dO, P^T and dS^T consumed
      for (int e = t; e < KV_BQ * HD; e += THREADS) {
        const int row = e / HD, d = e % HD, qr = q0 + row;
        const int64_t idx = (((int64_t)b * S + qr) * H + h) * HD + d;
        Qs[row * LD + d] = qr < S ? to_float(q[idx]) : 0.f;
        dOs[row * LD + d] = qr < S ? to_float(dout[idx]) : 0.f;
      }
      if (t < KV_BQ) {
        const int qr = q0 + t;
        Ls[t] = qr < S ? lse[lrow + qr] : 0.f;
        Ds[t] = qr < S ? delta[lrow + qr] : 0.f;
      }
      __syncthreads();

      float s[KV_COLS], dp[KV_COLS];
#pragma unroll
      for (int j = 0; j < KV_COLS; ++j) s[j] = dp[j] = 0.f;
      const float* krow = Ks + kr * LD;
      const float* vrow = Vs + kr * LD;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int j = 0; j < KV_COLS; ++j) {
          const int qc = c0 + 8 * j;
          s[j] = fmaf(kd, Qs[qc * LD + d], s[j]);
          dp[j] = fmaf(vd, dOs[qc * LD + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KV_COLS; ++j) {
        const int qc = c0 + 8 * j;
        const float p =
            visible(q0 + qc, ki, S, causal, window) ? expf(fmaf(s[j], scale, -Ls[qc])) : 0.f;
        Ps[kr * (KV_BQ + 1) + qc] = p;
        dSs[kr * (KV_BQ + 1) + qc] = p * (dp[j] - Ds[qc]);
      }
      __syncwarp();                  // a key's P^T and dS^T are written and read in one warp

      const float* prow = Ps + kr * (KV_BQ + 1);
      const float* srow = dSs + kr * (KV_BQ + 1);
      for (int qc = 0; qc < KV_BQ; ++qc) {
        const float p = prow[qc], ds = srow[qc];
        const float* grow = dOs + qc * LD + c0;
        const float* qrow = Qs + qc * LD + c0;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[j] = fmaf(p, grow[8 * j], dv_acc[j]);
          dk_acc[j] = fmaf(ds, qrow[8 * j], dk_acc[j]);
        }
      }
    }
  }

  if (ki < S) {
    const int64_t base = (((int64_t)b * S + ki) * K + kh) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[base + c0 + 8 * j] = from_float<T>(dk_acc[j] * scale);
      dv[base + c0 + 8 * j] = from_float<T>(dv_acc[j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int B, int S,
                   int H, int K, int causal, int window, float scale, cudaStream_t stream) {
  const size_t dq_bytes = dq_smem_bytes<HD>(), kv_bytes = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_bytes);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, HD><<<dim3((S + DQ_BQ - 1) / DQ_BQ, B * H), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, S, H, K,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // after the dQ kernel on the same stream: it reads the delta that one wrote
  flash_bwd_dkdv_kernel<T, HD><<<dim3((S + KV_BK - 1) / KV_BK, B * K), THREADS, kv_bytes,
                                 stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                                           static_cast<T*>(dv), S, H, K, causal, window, scale);
  return cudaGetLastError();
}

static_assert(dq_smem_bytes<256>() <= 227 * 1024, "the dQ tiles fit one block");
static_assert(dkdv_smem_bytes<256>() <= 227 * 1024, "the dK/dV tiles fit one block");

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); hd 16,
// 64, 128 or 256. q, o, dout, dq: contiguous [B, S, H, hd]; k, v, dk, dv:
// contiguous [B, S, K, hd]; lse: float32 [B, H, S] from the forward; delta:
// float32 [B, H, S] scratch that the first kernel fills. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse, void* dq,
                                   void* dk, void* dv, void* delta, int B, int S, int H, int K,
                                   int hd, int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FLASH_BWD(T, HD)                                                                     \
  return (int)launch<T, HD>(q, k, v, o, dout, l, dq, dk, dv, dl, B, S, H, K, causal, window, \
                            scale, st)
  if (dtype == 0 && hd == 16) FLASH_BWD(float, 16);
  if (dtype == 0 && hd == 64) FLASH_BWD(float, 64);
  if (dtype == 0 && hd == 128) FLASH_BWD(float, 128);
  if (dtype == 0 && hd == 256) FLASH_BWD(float, 256);
  if (dtype == 1 && hd == 16) FLASH_BWD(__nv_bfloat16, 16);
  if (dtype == 1 && hd == 64) FLASH_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) FLASH_BWD(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) FLASH_BWD(__nv_bfloat16, 256);
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
