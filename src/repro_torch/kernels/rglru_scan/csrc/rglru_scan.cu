// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t,
// elementwise over the recurrence width, with a float32 carry.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_fwd (body _rglru_kernel). Same function: a, b [B, S, W] in one
// dtype, h0 [B, W]; the carry is float32 and h is written in b's dtype.
//
// Design. One thread per (batch, channel), 64 threads a block along W, so a
// warp's loads and stores of one time step are one coalesced row segment.
// The Pallas grid's sequential seq-block axis (the carry in VMEM scratch)
// becomes the thread's own loop over S with the carry in a register. The
// loop is software-pipelined in groups of U steps: the loads of the next
// group's a_t and b_t are issued before the current group's U dependent
// FMAs, so the memory latency stays off the recurrence's dependency chain;
// each step stores its h once. The ragged tail (S not a multiple of U, W not
// a multiple of the block) is masked. Inputs are read through strides with
// a contiguous W dim.
//
// Bound on H100. Each input element is read once and each output written
// once with one FMA between them, so the kernel is bound by memory
// bandwidth: at the serving prefill shape (a, b, h float32 [4, 512, 2560],
// h0 [4, 2560]) that is ~62.9 MB, ~0.0188 ms at 3.35 TB/s. B*W = 10,240
// threads are 160 blocks of 64 on 132 SMs, a few warps per SM, so the card
// has too few loads in flight to reach that rate. Splitting S across blocks
// with a carry-propagation pass is the known remedy, left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;      // channels per block
constexpr int U = 16;            // time steps per prefetch group

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ ap, const T* __restrict__ bp,
                                           int64_t a_ss, int64_t b_ss, int t0, int S,
                                           float (&ra)[U], float (&rb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    ra[u] = t < S ? to_float(ap[t * a_ss]) : 0.f;
    rb[u] = t < S ? to_float(bp[t * b_ss]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ o, int S, int W,
                  int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                  int64_t o_sb, int64_t o_ss) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const T* ap = a + bi * a_sb + w;
  const T* bp = b + bi * b_sb + w;
  T* op = o + bi * o_sb + w;

  float h = h0[(int64_t)bi * W + w];
  float ra[U], rb[U];
  load_group(ap, bp, a_ss, b_ss, 0, S, ra, rb);
  for (int t0 = 0; t0 < S; t0 += U) {
    float na[U], nb[U];
    load_group(ap, bp, a_ss, b_ss, t0 + U, S, na, nb);   // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(ra[u], h, rb[u]);
      if (t0 + u < S) op[(t0 + u) * o_ss] = from_float<T>(h);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* o, int B, int S,
                   int W, const int64_t* as, const int64_t* bs, const int64_t* os,
                   cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(o), S, W,
      as[0], as[1], bs[0], bs[1], os[0], os[1]);
  return cudaGetLastError();
}

}  // namespace

// dtype (of a, b and the output): 0 = float32, 1 = bfloat16. h0 is float32
// [B, W], contiguous. Strides are in elements, ordered (batch, seq); the W
// dim must be contiguous. Returns a cudaError_t.
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b, const void* h0,
                              void* o, int B, int S, int W, const int64_t* a_strides,
                              const int64_t* b_strides, const int64_t* o_strides,
                              void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const float* h = static_cast<const float*>(h0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(a, b, h, o, B, S, W, a_strides, b_strides, o_strides, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, b, h, o, B, S, W, a_strides, b_strides,
                                      o_strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
