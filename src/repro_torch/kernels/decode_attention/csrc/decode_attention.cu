// Decode attention for Hopper (sm_90a): one query token per (batch, kv head)
// against an L-slot KV cache, float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention_fwd (body _decode_kernel). Same function: the G query
// heads of a group share kv head kh; slot j is valid if slot_pos[j] >= 0,
// slot_pos[j] <= cur_pos and, with a window, slot_pos[j] > cur_pos - window;
// output acc / max(l, 1e-30) in q's dtype. The model's path always has at
// least one valid slot (the current token's); with none, this kernel writes
// 0 where the plain version averages v.
//
// Design. One block per (b, kv head), 8 warps. The G grouped query heads are
// handled together, so each k/v row is read once for the whole group. The
// warps split the L slots (warp w takes slots w, w+8, ...), four slots per
// step so that eight row loads are in flight per warp; lane i holds head-dim
// columns i, i+32, ... (coalesced rows). Each warp keeps its own running
// max, denominator and accumulator per head in registers; the Pallas grid's
// sequential kv axis becomes that loop, and the warps' partial states are
// merged once through shared memory at the end. k/v are read in place in the
// cache layout [B, L, K, hd] through strides: the JAX wrapper's transposed
// copy of the whole cache each step is gone.
//
// The kernel is a template on the head dim (128, 256) and on a bound MAXG of
// the heads a block holds. At hd 128 (qwen2-7b) a block holds its whole
// group (MAXG up to 16) with q in registers. At hd 256 (recurrentgemma-2b:
// group 10, one kv head) a lane holds 8 columns, and q, acc and the four
// slots' k/v rows in registers would be ~320 floats at MAXG 16, far past 255
// registers. So at hd 256 q sits in shared memory and a block holds at most 8
// heads: the group is split evenly over ceil(G / 8) blocks (10 -> 2 x 5),
// each of which reads the group's k/v rows. That reads the cache twice but
// doubles the blocks, which the underfilled card (B*K = 4) needs more.
//
// Bound on H100. Every cache byte is read once per token and does ~G FMAs,
// so the kernel is bound by memory bandwidth. At the serving shape
// (B=4, K=4, L=544) there are only B*K = 16 blocks for 132 SMs (8 at
// recurrentgemma-2b's, B=4, K=1): the card is underfilled, and the kernel is
// latency-bound well below the bandwidth bound. A split over L (flash-decoding with a combine pass) is the known
// remedy and is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;             // slots per warp step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD> __host__ __device__ constexpr bool q_in_smem() { return HD > 128; }

template <int HD, int MAXG>
constexpr size_t smem_bytes() {
  return sizeof(float) * (WARPS * MAXG * (HD + 2) + (q_in_smem<HD>() ? MAXG * HD : 0));
}

// Block x handles heads [c * gc, c * gc + G) of kv head kh's group, with
// x = (b * K + kh) * chunks + c and G = min(gc, group - c * gc).
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ slot_pos,
              T* __restrict__ o, int L, int K, int group, int chunks, int gc,
              int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_sl, int64_t k_sk,
              int64_t v_sb, int64_t v_sl, int64_t v_sk,
              int64_t o_sb, int64_t o_sh,
              int cur_pos, int window, float scale) {
  constexpr int DPL = HD / 32;                 // head-dim columns per lane
  constexpr bool Q_SMEM = q_in_smem<HD>();
  extern __shared__ float smem[];
  float* s_acc = smem;                         // [WARPS][MAXG][HD]
  float* s_m = s_acc + WARPS * MAXG * HD;      // [WARPS][MAXG]
  float* s_l = s_m + WARPS * MAXG;             // [WARPS][MAXG]
  float* s_q = s_l + WARPS * MAXG;             // [MAXG][HD] at hd 256

  const int c = blockIdx.x % chunks, bk = blockIdx.x / chunks;
  const int b = bk / K, kh = bk % K;
  const int h0 = kh * group + c * gc;          // this block's first query head
  const int G = min(gc, group - c * gc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float qv[Q_SMEM ? 1 : MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
  if constexpr (Q_SMEM) {
    for (int e = threadIdx.x; e < G * HD; e += THREADS)
      s_q[e] = to_float(q[b * q_sb + (h0 + e / HD) * q_sh + e % HD]);
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      if constexpr (!Q_SMEM)
        qv[g][i] = g < G ? to_float(q[b * q_sb + (h0 + g) * q_sh + lane + 32 * i]) : 0.f;
    }
  }

  const T* kb = k + b * k_sb + kh * k_sk;
  const T* vb = v + b * v_sb + kh * v_sk;
  for (int base = warp; base < L; base += WARPS * UNROLL) {
    bool valid[UNROLL];
    float kr[UNROLL][DPL], vr[UNROLL][DPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int slot = base + u * WARPS;
      const int sp = slot < L ? slot_pos[slot] : -1;
      valid[u] = sp >= 0 && sp <= cur_pos && (window <= 0 || sp > cur_pos - window);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = valid[u] ? to_float(kb[slot * k_sl + lane + 32 * i]) : 0.f;
        vr[u][i] = valid[u] ? to_float(vb[slot * v_sl + lane + 32 * i]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!valid[u]) continue;                 // uniform across the warp
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          if constexpr (Q_SMEM) part = fmaf(s_q[g * HD + lane + 32 * i], kr[u][i], part);
          else part = fmaf(qv[g][i], kr[u][i], part);
        }
        const float s = warp_sum(part) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i] * alpha);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s_acc[(warp * MAXG + g) * HD + lane + 32 * i] = acc[g][i];
    if (lane == 0) {
      s_m[warp * MAXG + g] = m[g];
      s_l[warp * MAXG + g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps' partial softmax states
  for (int e = threadIdx.x; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w * MAXG + g]);
    float denom = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = s_l[w * MAXG + g] > 0.f ? expf(s_m[w * MAXG + g] - M) : 0.f;
      denom = fmaf(s_l[w * MAXG + g], f, denom);
      num = fmaf(s_acc[(w * MAXG + g) * HD + d], f, num);
    }
    o[b * o_sb + (h0 + g) * o_sh + d] = from_float<T>(num / fmaxf(denom, 1e-30f));
  }
}

template <typename T, int HD, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos,
                   void* o, int B, int L, int K, int group, int chunks, int gc,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   const int64_t* os, int cur_pos, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, MAXG>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, MAXG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD, MAXG><<<B * K * chunks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      slot_pos, static_cast<T*>(o), L, K, group, chunks, gc, qs[0], qs[1], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], os[0], os[1], cur_pos, window, scale);
  return cudaGetLastError();
}

// hd 128: the whole group in one block. hd 256: at most 8 heads a block.
template <typename T, int HD>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* slot_pos, void* o, int B, int L, int K, int group,
                           const int64_t* qs, const int64_t* ks, const int64_t* vs,
                           const int64_t* os, int cur_pos, int window, float scale,
                           cudaStream_t st) {
  constexpr int HEADS_PER_BLOCK = q_in_smem<HD>() ? 8 : 16;
  const int chunks = (group + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK;
  const int gc = (group + chunks - 1) / chunks;
#define REPRO_DECODE_LAUNCH(MG)                                                   \
  return launch<T, HD, MG>(q, k, v, slot_pos, o, B, L, K, group, chunks, gc, qs, ks, \
                           vs, os, cur_pos, window, scale, st)
  if (gc <= 1) REPRO_DECODE_LAUNCH(1);
  if (gc <= 2) REPRO_DECODE_LAUNCH(2);
  if (gc <= 4) REPRO_DECODE_LAUNCH(4);
  if (gc <= 8) REPRO_DECODE_LAUNCH(8);
  if constexpr (HEADS_PER_BLOCK == 16)
    if (gc <= 16) REPRO_DECODE_LAUNCH(16);
#undef REPRO_DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              const int* slot_pos, void* o, int B, int L, int K, int G,
                              int hd, const int64_t* qs, const int64_t* ks,
                              const int64_t* vs, const int64_t* os, int cur_pos,
                              int window, float scale, cudaStream_t st) {
  if (hd == 128)
    return dispatch_group<T, 128>(q, k, v, slot_pos, o, B, L, K, G, qs, ks, vs, os,
                                  cur_pos, window, scale, st);
  if (hd == 256)
    return dispatch_group<T, 256>(q, k, v, slot_pos, o, B, L, K, G, qs, ks, vs, os,
                                  cur_pos, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 128 or 256; the group H / K at most
// 16. q strides (batch, head); cache strides
// (batch, slot, kv head); out strides (batch, head); all in elements, with
// the head dim contiguous. slot_pos is int32 [L] on the device. Returns a
// cudaError_t.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* slot_pos, void* o,
                                    int B, int L, int H, int K, int hd,
                                    const int64_t* q_strides,
                                    const int64_t* k_strides,
                                    const int64_t* v_strides,
                                    const int64_t* o_strides, int cur_pos,
                                    int window, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > 16 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int* sp = static_cast<const int*>(slot_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, sp, o, B, L, K, G, hd, q_strides,
                                         k_strides, v_strides, o_strides, cur_pos, window,
                                         scale, st);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, sp, o, B, L, K, G, hd, q_strides,
                                                 k_strides, v_strides, o_strides, cur_pos,
                                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
