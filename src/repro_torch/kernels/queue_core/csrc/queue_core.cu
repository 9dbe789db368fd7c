// Batched WS request-queue core for Hopper (sm_90a): FIFO M/G/k(t) over many
// jobs (one job: one department's request trace under one capacity
// schedule), with the metric fold in the same launch.
//
// Replaces no Pallas kernel: it replaces the JAX package's XLA programs in
// src/repro/workloads/queueing.py:491-671 -- _kw_batched_core (constant
// capacity, the Kiefer-Wolfowitz recurrence), _pw_batched_core (piecewise
// capacity k(t), a sorted slot vector) and _device_fold (the metric fold),
// each jit(vmap(lax.scan)). Same function as ref.py in this package: t, s
// [B, n_pad] float32, per job n_valid, horizon, SLO, capacity intervals
// (cap_t, cap_k, hi_t) [B, e_pad]; out [B, 8] float32 in FOLD_COLS order.
//
// Bound on H100. The kernel reads t and s once (8 B a request), the
// capacity tables once, and writes [B, 8]: at the campaign's 16-job chunk of
// ~10k requests each that is ~1.3 MB, under a microsecond at 3.35 TB/s.
// What limits it is the recurrence: request i+1's start depends on request
// i's slot vector, so the floor is the longest job's dependency chain -- a
// few hundred cycles a request (shared-memory loads, a warp min, a sorted
// insert) times its n -- not bytes or operations.
//
// Design: one block a job, 256 threads.
//   * Warp 0 runs the job's requests in order, to the job's own n (padding
//     changes no carry). The slot vector (the job's own K = its largest k;
//     the batch's k_pad only sizes shared memory, which changes no value) and
//     the capacity tables stay in shared memory. Lanes load 32 requests at
//     a time and hand them out by shuffles. A job whose K exceeds k_pad
//     gets a NaN row and touches no shared memory past k_pad.
//   * Constant capacity: start = max(t_i, min(free)); the vector is kept
//     sorted, so min(free) is free[0], and giving the earliest-free slot the
//     finish is "drop free[0], insert fin in order" (the same multiset as
//     the argmin update). k = 0 serves nothing.
//   * Piecewise: s0 = max(t_i, prev_start); each lane takes intervals e:
//     thresh = free[clip(K - k_e, 0, K - 1)] (inf where k_e <= 0), lo =
//     max(cap_t[e], thresh, s0), a candidate if lo < hi_t[e]; start is the
//     warp's min. A served request drops free[0] and inserts fin in order
//     (a ballot finds the place, the warp shifts the prefix); an unserved
//     one with s0 < horizon sets every slot that frees before the horizon
//     to 0 (the golden oracle's heap drain).
//   * Each lane keeps the latencies of its own requests: counts, sums
//     (float64), max and violations are folded on the way; the latencies go
//     to a global scratch [B, n_pad] for the order statistics.
//   * Fold, all 8 warps: the six order statistics (floor and ceil rank of
//     p50, p95, p99) by binary search over the float32 bit space (31
//     rounds; non-negative floats order as their bits), then numpy's linear
//     rule in float32 with __fmul_rn/__fadd_rn, so no FMA contracts it and
//     every column but the two sums matches the plain version bit for bit.
// A job's row depends on that job alone, so co-batched jobs and the batch's
// padding never change a bit of it.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NRANKS = 6;                     // floor and ceil rank of 3 quantiles
constexpr int COLS = 8;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Drop free[0] and insert fin so that free[0..K) stays ascending: free[j] =
// free[j + 1] for j < pos, free[pos] = fin, where pos counts the entries of
// free[1..K) below fin (a prefix, the vector being sorted).
__device__ __forceinline__ void replace_min(float* free, int K, float fin, int lane) {
  int pos = 0;
  for (int base = 1; base < K; base += 32) {
    const int j = base + lane;
    const unsigned below = __ballot_sync(FULL, j < K && free[j] < fin);
    pos += __popc(below);
    if (below != FULL) break;
  }
  for (int base = 0; base < pos; base += 32) {
    const int j = base + lane;
    const float v = j < pos ? free[j + 1] : 0.f;
    __syncwarp();
    if (j < pos) free[j] = v;
    __syncwarp();
  }
  if (lane == 0) free[pos] = fin;
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
queue_core_kernel(int piecewise, const float* __restrict__ t, const float* __restrict__ s,
                  int64_t row, const int* __restrict__ n_valid,
                  const float* __restrict__ horizon, const float* __restrict__ slo,
                  const float* __restrict__ cap_t, const int* __restrict__ cap_k,
                  const float* __restrict__ hi_t, int E, int k_pad,
                  float* __restrict__ lat_out, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_capt = smem;                          // [E]
  float* s_hit = smem + E;                       // [E]
  int* s_capk = reinterpret_cast<int*>(smem + 2 * E);   // [E]
  float* free = smem + 3 * E;                    // [k_pad]
  __shared__ int s_K, s_served, s_viol;
  __shared__ double s_sum_lat, s_sum_wait;
  __shared__ float s_max;
  __shared__ int s_counts[WARPS][NRANKS];
  __shared__ int s_lb[NRANKS], s_ub[NRANKS], s_rank[NRANKS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = n_valid[b];
  const float hz = horizon[b];
  const float* tb = t + (int64_t)b * row;
  const float* sb = s + (int64_t)b * row;
  float* lat = lat_out + (int64_t)b * row;

  for (int e = tid; e < E; e += THREADS) {
    s_capt[e] = cap_t[(int64_t)b * E + e];
    s_hit[e] = hi_t[(int64_t)b * E + e];
    s_capk[e] = cap_k[(int64_t)b * E + e];
  }
  if (warp == 0) {
    int K;
    if (piecewise) {
      int k = 1;
      for (int e = lane; e < E; e += 32) k = max(k, cap_k[(int64_t)b * E + e]);
      for (int o = 16; o; o >>= 1) k = max(k, __shfl_xor_sync(FULL, k, o));
      K = k;
    } else {
      K = max(cap_k[(int64_t)b * E], 0);
    }
    if (K > k_pad) K = -1;                       // more slots than shared memory holds
    for (int j = lane; j < K; j += 32) free[j] = 0.f;
    if (lane == 0) s_K = K;
  }
  __syncthreads();
  if (s_K < 0) {                                 // the host checks this outside graph capture
    if (tid < COLS) out[(int64_t)b * COLS + tid] = CUDART_NAN_F;
    return;
  }

  if (warp == 0) {
    const int K = s_K;
    const float slo_t = slo[b];
    float prev = 0.f;                            // FIFO commit point (piecewise)
    int served_n = 0, viol = 0;
    double sum_lat = 0.0, sum_wait = 0.0;
    float mx = -CUDART_INF_F;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const float t_l = i < n ? tb[i] : CUDART_INF_F;
      const float s_l = i < n ? sb[i] : 0.f;
      const int cnt = min(32, n - base);
      float my_lat = CUDART_INF_F, my_wait = CUDART_INF_F;
      for (int c = 0; c < cnt; ++c) {
        const float ti = __shfl_sync(FULL, t_l, c);
        const float si = __shfl_sync(FULL, s_l, c);
        float start;
        if (piecewise) {
          const float s0 = fmaxf(ti, prev);
          float best = CUDART_INF_F;
          for (int e = lane; e < E; e += 32) {
            const int ke = s_capk[e];
            const float thresh = ke > 0 ? free[min(max(K - ke, 0), K - 1)] : CUDART_INF_F;
            const float lo = fmaxf(fmaxf(s_capt[e], thresh), s0);
            best = fminf(best, lo < s_hit[e] ? lo : CUDART_INF_F);
          }
          start = warp_min(best);
          if (!(start < hz) && s0 < hz) {        // unserved: the heap drain
            for (int j = lane; j < K; j += 32)
              if (free[j] < hz) free[j] = 0.f;
            __syncwarp();
          }
        } else {
          start = fmaxf(ti, K > 0 ? free[0] : CUDART_INF_F);
        }
        const bool served = start < hz;
        const float fin = __fadd_rn(start, si);
        if (served) {
          __syncwarp();                          // every lane has read free
          replace_min(free, K, fin, lane);
          prev = start;
        }
        if (c == lane) {
          my_lat = served ? __fsub_rn(fin, ti) : CUDART_INF_F;
          my_wait = served ? __fsub_rn(start, ti) : CUDART_INF_F;
        }
      }
      if (i < n) {
        lat[i] = my_lat;
        const bool ok = my_lat < CUDART_INF_F;
        if (ok) {
          ++served_n;
          sum_lat += (double)my_lat;
          sum_wait += (double)my_wait;
          mx = fmaxf(mx, my_lat);
        }
        viol += (!ok || my_lat > slo_t) ? 1 : 0;
      }
    }
    served_n = warp_sum(served_n);
    viol = warp_sum(viol);
    sum_lat = warp_sum(sum_lat);
    sum_wait = warp_sum(sum_wait);
    mx = warp_max(mx);
    if (lane == 0) {
      s_served = served_n;
      s_viol = viol;
      s_sum_lat = sum_lat;
      s_sum_wait = sum_wait;
      s_max = mx;
    }
  }
  __syncthreads();

  const int m = s_served;
  float* o = out + (int64_t)b * COLS;
  if (m == 0) {
    if (tid == 0) {
      o[0] = 0.f;
      o[1] = o[2] = o[3] = CUDART_INF_F;
      o[4] = 0.f;
      o[5] = -CUDART_INF_F;
      o[6] = 0.f;
      o[7] = (float)s_viol;
    }
    return;
  }

  // numpy's linear rule: pos = (m - 1) * q, the floor and ceil ranks around it
  const float mf = (float)m;
  const float qs[3] = {__fdiv_rn(50.f, 100.f), __fdiv_rn(95.f, 100.f),
                       __fdiv_rn(99.f, 100.f)};
  float pos[3];
  for (int r = 0; r < 3; ++r) pos[r] = __fmul_rn(fmaxf(__fsub_rn(mf, 1.f), 0.f), qs[r]);
  if (tid < NRANKS) {
    const int lo_r = (int)floorf(__fmul_rn(fmaxf(__fsub_rn(mf, 1.f), 0.f), qs[tid % 3]));
    s_rank[tid] = tid < 3 ? lo_r : min(lo_r + 1, m - 1);
    s_lb[tid] = -1;                              // the statistic's bits lie in (lb, ub]
    s_ub[tid] = 0x7f800000;                      // +inf
  }
  __syncthreads();

  const unsigned* bits = reinterpret_cast<const unsigned*>(lat);
  for (int round = 0; round < 31; ++round) {
    int mid[NRANKS], cnt[NRANKS];
    for (int r = 0; r < NRANKS; ++r) {
      mid[r] = s_lb[r] + ((s_ub[r] - s_lb[r]) >> 1);
      cnt[r] = 0;
    }
    for (int i = tid; i < n; i += THREADS) {
      const int v = (int)bits[i];
      for (int r = 0; r < NRANKS; ++r) cnt[r] += v <= mid[r] ? 1 : 0;
    }
    for (int r = 0; r < NRANKS; ++r) {
      cnt[r] = warp_sum(cnt[r]);
      if (lane == 0) s_counts[warp][r] = cnt[r];
    }
    __syncthreads();
    if (tid < NRANKS) {                          // s_lb, s_ub unchanged since read above
      int total = 0;
      for (int w = 0; w < WARPS; ++w) total += s_counts[w][tid];
      const int mine = s_lb[tid] + ((s_ub[tid] - s_lb[tid]) >> 1);
      if (total >= s_rank[tid] + 1) s_ub[tid] = mine;
      else s_lb[tid] = mine;
    }
    __syncthreads();
  }

  if (tid == 0) {
    o[0] = mf;
    for (int r = 0; r < 3; ++r) {
      const float lo = __int_as_float(s_ub[r]);
      const float hi = __int_as_float(s_ub[r + 3]);
      const float frac = __fsub_rn(pos[r], (float)s_rank[r]);
      o[1 + r] = __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, frac)), __fmul_rn(hi, frac));
    }
    o[4] = (float)(s_sum_lat / (double)m);
    o[5] = s_max;
    o[6] = (float)(s_sum_wait / (double)m);
    o[7] = (float)s_viol;
  }
}

}  // namespace

extern "C" int queue_core_fwd(int piecewise, const float* t, const float* s, int64_t row,
                              const int* n_valid, const float* horizon, const float* slo,
                              const float* cap_t, const int* cap_k, const float* hi_t,
                              int B, int E, int k_pad, float* lat, float* out,
                              void* stream) {
  if (B <= 0 || E <= 0 || k_pad <= 0 || row < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * E + k_pad) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  queue_core_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      piecewise, t, s, row, n_valid, horizon, slo, cap_t, cap_k, hi_t, E, k_pad, lat, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
