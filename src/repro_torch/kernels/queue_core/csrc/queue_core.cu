// Batched WS request-queue core for Hopper (sm_90a): FIFO M/G/k(t) over every
// job of a flush in one launch (one job: one department's request trace
// under one capacity schedule), with the metric fold in the same launch.
//
// Replaces no Pallas kernel: it replaces the JAX package's XLA programs in
// src/repro/workloads/queueing.py -- _kw_batched_core (:556, constant
// capacity, the Kiefer-Wolfowitz recurrence), _pw_batched_core (:598,
// piecewise capacity k(t), a sorted slot vector) and _device_fold (:491, the
// metric fold), each jit(vmap(lax.scan)) over one shape bucket. Same function
// as ref.queue_flush_reference in this package. The inputs are flat tables
// of ragged jobs of both kinds: job j's requests t, s [req_off[j], req_off[j]
// + n_j) (n_j = n_valid[j] where given, else req_off[j + 1] - req_off[j]),
// its capacity intervals (cap_t, cap_k, hi_t) [cap_off[j], cap_off[j + 1]),
// its kind (0 constant, 1 piecewise), horizon and SLO; out [J, 8] float32 in
// FOLD_COLS order.
//
// Bound on H100. Bytes: t and s once (8 B a request), the capacity tables
// and [J, 8]: ~1.6 MB for the campaign's 16-job flush, under a microsecond
// at 3.35 TB/s. What binds is the chain: request i + 1's start depends on
// request i's slot vector, so no exact sequential evaluation beats the
// longest job's n times one dependent fmaxf and one __fadd_rn (8 cycles a
// request). The design shortens the chain a request:
//   * One block a job, all jobs of a flush in one launch: a flush lasts as
//     long as its longest job, not the sum of shape buckets' longest jobs.
//   * The sorted slot vector lives in warp 0's registers: slot j in lane
//     j % 32, register j / 32, R registers a lane (a template parameter: 1,
//     2, 4, 8 or 16, so K <= 512), picked on the host from the flush's
//     largest K; slots at or past the job's own K hold +inf. The insert (drop
//     free[0], put fin in order) needs no ballot: the vector being sorted,
//     "below fin" marks a prefix, so slot j takes free[j + 1] if that is
//     below fin, else fin if j == 0 or free[j] is below fin, else keeps
//     free[j]. free[j + 1] comes by R shuffles that depend on the vector
//     alone, so only two compares and two selects a register wait for fin:
//     no shared memory and no __syncwarp on the chain.
//   * Piecewise capacity: lane e of the window [wb, wb + 32) holds interval
//     wb + e (start, end, whether it is open, and which slot g = K - k_e is
//     its threshold). The lane keeps th = free[g] in a register and applies
//     the insert's rule to it as the vector does to slot g (free[g + 1]
//     fetched by shuffles off the chain), so a request's search starts from
//     a register. For an interval that has not ended (s0 < hi), max(cap_t,
//     th, s0) < hi iff a = max(cap_t, th) < hi, so start = max(s0, the least
//     feasible a). The starts ascend from 0 (checked; a NaN row otherwise),
//     so every a is a float that is not negative, and the least is one
//     __reduce_min_sync over its bits. Every interval past the window starts
//     at or after cap_t[wb + 32], so a later window is searched only while
//     the min exceeds that: exactly the min over all intervals. The commit
//     point prev never decreases, so once it passes an interval's end no
//     later request can use it: where intervals remain past the window, the
//     window base (the cursor) moves past those. A job with at most 32
//     intervals (every campaign job) runs a loop without the cursor and the
//     later windows: one loop for both ran the campaign's first flush 1.3x
//     and the 192-job set 1.5x as long on an H100, though its extra tests
//     are false there.
//   * Constant capacity: start = max(t_i, free[0]); every lane keeps free[0]
//     as its th.
//   * t and s come 32 requests at a time, the next 32 loaded while these
//     run, and are handed out by shuffles that do not depend on the state.
//   * K > 512: the instance R = 0 keeps the slot vector in shared memory
//     ([k_max] floats) with a ballot insert and a warp min over all
//     intervals, as the first design did; the host chooses it by shape.
//   * The fold, all 8 warps: the six order statistics (floor and ceil rank of
//     p50, p95, p99) by binary search over the float32 bit space (31 rounds;
//     non-negative floats order as their bits), then numpy's linear rule in
//     float32 with __fmul_rn/__fadd_rn, so no FMA contracts it and every
//     column but the two float64 sums matches the plain version bit for bit.
// A job's row depends on that job alone: the other jobs of the flush, their
// order and the instance never change a bit of it. A job whose K exceeds
// k_max, whose interval starts descend or begin below 0, or that has no
// interval gets a NaN row.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NRANKS = 6;                     // floor and ceil rank of 3 quantiles
constexpr int COLS = 8;

// Phase clocks, compiled only with -DREPRO_QUEUE_PHASES (the diagnostic
// build of kernels/queue_core/phases.py; the served library has none of
// this). Thread 0 of each block adds up the clock() cycles of each phase as
// it sees them and at the end stores them in queue_phase_cycles[block]:
// PROLOGUE (the job's tables, K, the checks), LOADS (t and s, 32 requests at
// a time, and each 32's latencies stored and summed), SEARCH (the hand-out
// and the interval search: s0 to start), INSERT (fin, the insert or the
// drain, the cursor), FOLD (the warp sums and the order statistics).
enum Phase { PROLOGUE, LOADS, SEARCH, INSERT, FOLD, N_PHASES };
#ifdef REPRO_QUEUE_PHASES
constexpr int PHASE_BLOCKS = 4096;
__device__ unsigned queue_phase_cycles[PHASE_BLOCKS][N_PHASES];
struct PhaseClock {
  unsigned last, sum[N_PHASES];
  __device__ PhaseClock() : last((unsigned)clock()) {
#pragma unroll
    for (int p = 0; p < N_PHASES; ++p) sum[p] = 0u;
  }
  __device__ void mark(Phase p) {
    const unsigned now = (unsigned)clock();
    sum[p] += now - last;
    last = now;
  }
  __device__ void store() const {
    if (threadIdx.x == 0 && blockIdx.x < PHASE_BLOCKS)
#pragma unroll
      for (int p = 0; p < N_PHASES; ++p) queue_phase_cycles[blockIdx.x][p] = sum[p];
  }
};
#else
struct PhaseClock {
  __device__ void mark(Phase) const {}
  __device__ void store() const {}
};
#endif

// The flat tables of one flush (see the header).
struct Flush {
  const int* kind;
  const float* t;
  const float* s;
  const int* req_off;
  const int* n_valid;                          // nullptr: n_j = req_off[j + 1] - req_off[j]
  const float* cap_t;
  const int* cap_k;
  const float* hi_t;
  const int* cap_off;
  const float* horizon;
  const float* slo;
  int k_max;
  float* lat;                                  // scratch, one latency a request
  float* out;
};

// One block's job: its slices of the tables.
struct Job {
  const float* t;
  const float* s;
  float* lat;
  const float* cap_t;
  const int* cap_k;
  const float* hi_t;
  int n, E, K;
  float hz, slo;
};

struct Totals {
  int served, viol;
  double sum_lat, sum_wait;
  float mx;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The least of floats that are not negative, across the warp: with the sign
// bit cleared (-0 counts as +0) their bits order as they do, so one
// redux.sync finds it.
__device__ __forceinline__ float warp_min_nonneg(float x) {
  return __int_as_float(__reduce_min_sync(FULL, __float_as_int(x) & 0x7fffffff));
}

// ------------------------------------------------ slot vector in registers

// One level of select_reg: y[i] = y[i + W] where r has bit W.
template <int W, int R>
__device__ __forceinline__ void select_level(float (&y)[R], int r) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) y[i] = (r & W) ? y[i + W] : y[i];
    select_level<W / 2>(y, r);
  }
}

// x[r] by a tree over r's bits: log2(R) dependent selects.
template <int R>
__device__ __forceinline__ float select_reg(const float (&x)[R], int r) {
  float y[R];
#pragma unroll
  for (int i = 0; i < R; ++i) y[i] = x[i];
  select_level<R / 2>(y, r);
  return y[0];
}

// Slot src + 32 * reg of a vector spread over the warp (slot j in lane
// j % 32, register j / 32): R shuffles and a select tree.
template <int R>
__device__ __forceinline__ float fetch(const float (&v)[R], int src, int reg) {
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = __shfl_sync(FULL, v[r], src);
  return select_reg<R>(x, reg);
}

// One lane's interval of a window: start, end, open (k > 0), and where its
// threshold slot g = clip(K - k, 0, K - 1) lives (lane src, register reg;
// head: g == 0).
struct Window {
  float ct, hi;
  int src, reg;
  bool open, head;
};

__device__ __forceinline__ Window window_lane(const Job& q, int e) {
  Window w{CUDART_INF_F, CUDART_INF_F, 0, 0, false, true};
  if (e < q.E) {
    const int k = q.cap_k[e];
    const int g = min(max(q.K - k, 0), q.K - 1);
    w = Window{q.cap_t[e], q.hi_t[e], g & 31, g >> 5, k > 0, g == 0};
  }
  return w;
}

// The least a = max(cap_t, free[g]) over the window's intervals that are
// open, have not ended by s0 and have a < hi; +inf if none. Every a is at
// least its interval's start, and the starts are not negative (checked).
template <int R>
__device__ __forceinline__ float window_min(const float (&fr)[R], const Window& w, float s0) {
  const float a = fmaxf(w.ct, fetch<R>(fr, w.src, w.reg));
  return warp_min_nonneg((w.open && s0 < w.hi && a < w.hi) ? a : CUDART_INF_F);
}

// Warp 0 runs the job's requests in order. The lanes hold the sorted slot
// vector fr; each lane also holds its interval's threshold th = free[g] and
// applies the insert's rule (or the drain's) to it, as to slot g of the
// vector, so the next request's search starts from a register: the
// shuffles that fetch free[g + 1] and the vector's shift depend on the
// vector alone and overlap the search. The constant kind's "interval" is
// slot 0 in every lane. MULTI: the job has more intervals than a window
// (the cursor, later windows); else one window holds them all. Each lane
// returns the totals of the requests it kept (lane c of each 32) and stores
// their latencies.
template <int R, bool PW, bool MULTI>
__device__ Totals chain_registers(const Job& q, int lane, PhaseClock& clk) {
  float fr[R];                                  // slot r * 32 + lane; +inf past K
#pragma unroll
  for (int r = 0; r < R; ++r) fr[r] = r * 32 + lane < q.K ? 0.f : CUDART_INF_F;
  const int up_lane = (lane + 1) & 31;
  int wb = 0;                                   // the cursor: the window's first interval
  Window w = PW ? window_lane(q, lane) : Window{0.f, CUDART_INF_F, 0, 0, true, true};
  float th = fetch<R>(fr, w.src, w.reg);        // free[g]
  float prev = 0.f;                             // FIFO commit point (piecewise)
  Totals tot{0, 0, 0.0, 0.0, -CUDART_INF_F};
  float t_next = lane < q.n ? q.t[lane] : CUDART_INF_F;
  float s_next = lane < q.n ? q.s[lane] : 0.f;
  for (int base = 0; base < q.n; base += 32) {
    const float t_l = t_next, s_l = s_next;
    const int i = base + lane;
    t_next = i + 32 < q.n ? q.t[i + 32] : CUDART_INF_F;   // in flight during these 32
    s_next = i + 32 < q.n ? q.s[i + 32] : 0.f;
    const int cnt = min(32, q.n - base);
    float my_start = CUDART_INF_F;              // of request i, inf if unserved
    clk.mark(LOADS);
    for (int c = 0; c < cnt; ++c) {
      const float ti = __shfl_sync(FULL, t_l, c);
      const float si = __shfl_sync(FULL, s_l, c);
      float up[R];                              // free[j + 1], the insert's shift
      {
        float y[R + 1];                         // lane + 1's registers; lane 31 takes lane 0's next
#pragma unroll
        for (int r = 0; r < R; ++r) y[r] = __shfl_sync(FULL, fr[r], up_lane);
        y[R] = CUDART_INF_F;
#pragma unroll
        for (int r = 0; r < R; ++r) up[r] = lane < 31 ? y[r] : y[r + 1];
      }
      const float th_up = fetch<R>(up, w.src, w.reg);     // free[g + 1]
      const float s0 = fmaxf(ti, prev);
      float start;
      if constexpr (PW) {
        const float a = fmaxf(w.ct, th);
        float m = warp_min_nonneg((w.open && s0 < w.hi && a < w.hi) ? a : CUDART_INF_F);
        if constexpr (MULTI)
          for (int nb = wb + 32; nb < q.E && m > q.cap_t[nb]; nb += 32)
            m = fminf(m, window_min<R>(fr, window_lane(q, nb + lane), s0));
        start = fmaxf(s0, m);
      } else {
        start = fmaxf(ti, th);
      }
      clk.mark(SEARCH);
      const bool served = start < q.hz;
      const float fin = __fadd_rn(start, si);
      // unserved with s0 inside the horizon: every slot that frees before the
      // horizon goes to 0 (the golden oracle's heap drain; a sorted prefix)
      const bool drain = PW && !served && s0 < q.hz;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool at_or_below = (r == 0 && lane == 0) || fr[r] < fin;
        const float ins = up[r] < fin ? up[r] : (at_or_below ? fin : fr[r]);
        fr[r] = served ? ins : (drain && fr[r] < q.hz ? 0.f : fr[r]);
      }
      th = served ? (th_up < fin ? th_up : (w.head || th < fin ? fin : th))
                  : (drain && th < q.hz ? 0.f : th);
      prev = served ? start : prev;
      if constexpr (MULTI) {
        if (q.E > wb + 32) {                    // intervals past the window: move the cursor
          const unsigned ended = __ballot_sync(FULL, w.hi <= prev);
          const int lead = ended == FULL ? 32 : __ffs(~ended) - 1;
          if (lead) {
            wb += lead;
            w = window_lane(q, wb + lane);
            th = fetch<R>(fr, w.src, w.reg);
          }
        }
      }
      clk.mark(INSERT);
      my_start = c == lane ? (served ? start : CUDART_INF_F) : my_start;
    }
    if (i < q.n) {
      const bool ok = my_start < CUDART_INF_F;
      const float my_lat = ok ? __fsub_rn(__fadd_rn(my_start, s_l), t_l) : CUDART_INF_F;
      q.lat[i] = my_lat;
      if (ok) {
        ++tot.served;
        tot.sum_lat += (double)my_lat;
        tot.sum_wait += (double)__fsub_rn(my_start, t_l);
        tot.mx = fmaxf(tot.mx, my_lat);
      }
      tot.viol += (!ok || my_lat > q.slo) ? 1 : 0;
    }
  }
  return tot;
}

// ------------------------------------------ slot vector in shared memory

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

// The same chain with the slot vector free[0..K) in shared memory (K > 512).
template <bool PW>
__device__ Totals chain_shared(const Job& q, float* free, int lane, PhaseClock& clk) {
  for (int j = lane; j < q.K; j += 32) free[j] = 0.f;
  __syncwarp();
  float prev = 0.f;
  Totals tot{0, 0, 0.0, 0.0, -CUDART_INF_F};
  float t_next = lane < q.n ? q.t[lane] : CUDART_INF_F;
  float s_next = lane < q.n ? q.s[lane] : 0.f;
  for (int base = 0; base < q.n; base += 32) {
    const float t_l = t_next, s_l = s_next;
    const int i = base + lane;
    t_next = i + 32 < q.n ? q.t[i + 32] : CUDART_INF_F;
    s_next = i + 32 < q.n ? q.s[i + 32] : 0.f;
    const int cnt = min(32, q.n - base);
    float my_lat = CUDART_INF_F, my_wait = CUDART_INF_F;
    clk.mark(LOADS);
    for (int c = 0; c < cnt; ++c) {
      const float ti = __shfl_sync(FULL, t_l, c);
      const float si = __shfl_sync(FULL, s_l, c);
      const float s0 = fmaxf(ti, prev);
      float start;
      if (PW) {
        float best = CUDART_INF_F;
        for (int e = lane; e < q.E; e += 32) {
          const int ke = q.cap_k[e];
          const float thresh = ke > 0 ? free[min(max(q.K - ke, 0), q.K - 1)] : CUDART_INF_F;
          const float lo = fmaxf(fmaxf(q.cap_t[e], thresh), s0);
          best = fminf(best, lo < q.hi_t[e] ? lo : CUDART_INF_F);
        }
        start = warp_min(best);
      } else {
        start = fmaxf(ti, q.K > 0 ? free[0] : CUDART_INF_F);
      }
      clk.mark(SEARCH);
      const bool served = start < q.hz;
      const float fin = __fadd_rn(start, si);
      __syncwarp();                             // every lane has read free
      if (served) {
        replace_min(free, q.K, fin, lane);
        prev = start;
      } else if (PW && s0 < q.hz) {             // the heap drain
        for (int j = lane; j < q.K; j += 32)
          if (free[j] < q.hz) free[j] = 0.f;
        __syncwarp();
      }
      clk.mark(INSERT);
      if (c == lane) {
        my_lat = served ? __fsub_rn(fin, ti) : CUDART_INF_F;
        my_wait = served ? __fsub_rn(start, ti) : CUDART_INF_F;
      }
    }
    if (i < q.n) {
      q.lat[i] = my_lat;
      const bool ok = my_lat < CUDART_INF_F;
      if (ok) {
        ++tot.served;
        tot.sum_lat += (double)my_lat;
        tot.sum_wait += (double)my_wait;
        tot.mx = fmaxf(tot.mx, my_lat);
      }
      tot.viol += (!ok || my_lat > q.slo) ? 1 : 0;
    }
  }
  return tot;
}

// --------------------------------------------------------------- kernel

template <int R>                                // R > 0: registers a lane; 0: shared memory
__global__ void __launch_bounds__(THREADS) queue_flush_kernel(const Flush f) {
  extern __shared__ __align__(16) float slots[];    // [k_max], R == 0 only
  __shared__ int s_K, s_served, s_viol;
  __shared__ double s_sum_lat, s_sum_wait;
  __shared__ float s_max;
  __shared__ int s_counts[WARPS][NRANKS];
  __shared__ int s_lb[NRANKS], s_ub[NRANKS], s_rank[NRANKS];

  PhaseClock clk;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = f.req_off[b], e0 = f.cap_off[b];
  const bool pw = f.kind[b] != 0;
  Job q;
  q.t = f.t + r0;
  q.s = f.s + r0;
  q.lat = f.lat + r0;
  q.cap_t = f.cap_t + e0;
  q.cap_k = f.cap_k + e0;
  q.hi_t = f.hi_t + e0;
  q.n = f.n_valid ? f.n_valid[b] : f.req_off[b + 1] - r0;
  q.E = f.cap_off[b + 1] - e0;
  q.hz = f.horizon[b];
  q.slo = f.slo[b];
  float* o = f.out + (int64_t)b * COLS;

  if (warp == 0) {                              // K: the job's own slots; the checks
    int k = pw ? 1 : 0;
    bool bad = q.E < 1;
    if (!bad && pw) {
      for (int e = lane; e < q.E; e += 32) {
        k = max(k, q.cap_k[e]);
        bad |= !(q.cap_t[e] >= (e > 0 ? q.cap_t[e - 1] : 0.f));
      }
      k = __reduce_max_sync(FULL, k);
      bad = __any_sync(FULL, bad);
    } else if (!bad) {
      k = max(q.cap_k[0], 0);
    }
    if (lane == 0) s_K = bad || k > f.k_max ? -1 : k;
  }
  __syncthreads();
  q.K = s_K;
  if (q.K < 0) {
    if (tid < COLS) o[tid] = CUDART_NAN_F;
    return;
  }
  clk.mark(PROLOGUE);

  if (warp == 0) {
    Totals tot;
    if constexpr (R > 0) {
      if (!pw) tot = chain_registers<R, false, false>(q, lane, clk);
      else if (q.E > 32) tot = chain_registers<R, true, true>(q, lane, clk);
      else tot = chain_registers<R, true, false>(q, lane, clk);
    } else
      tot = pw ? chain_shared<true>(q, slots, lane, clk) : chain_shared<false>(q, slots, lane, clk);
    tot.served = warp_sum(tot.served);
    tot.viol = warp_sum(tot.viol);
    tot.sum_lat = warp_sum(tot.sum_lat);
    tot.sum_wait = warp_sum(tot.sum_wait);
    tot.mx = warp_max(tot.mx);
    if (lane == 0) {
      s_served = tot.served;
      s_viol = tot.viol;
      s_sum_lat = tot.sum_lat;
      s_sum_wait = tot.sum_wait;
      s_max = tot.mx;
    }
  }
  __syncthreads();

  const int m = s_served;
  if (m == 0) {
    if (tid == 0) {
      o[0] = 0.f;
      o[1] = o[2] = o[3] = CUDART_INF_F;
      o[4] = 0.f;
      o[5] = -CUDART_INF_F;
      o[6] = 0.f;
      o[7] = (float)s_viol;
    }
    clk.mark(FOLD);
    clk.store();
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

  const unsigned* bits = reinterpret_cast<const unsigned*>(q.lat);
  for (int round = 0; round < 31; ++round) {
    int mid[NRANKS], cnt[NRANKS];
    for (int r = 0; r < NRANKS; ++r) {
      mid[r] = s_lb[r] + ((s_ub[r] - s_lb[r]) >> 1);
      cnt[r] = 0;
    }
    for (int i = tid; i < q.n; i += THREADS) {
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
  clk.mark(FOLD);
  clk.store();
}

template <int R>
cudaError_t launch(const Flush& f, int J, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_flush_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  queue_flush_kernel<R><<<J, THREADS, smem, stream>>>(f);
  return cudaGetLastError();
}

}  // namespace

// One launch for every job of a flush. slot_regs: registers a lane of the
// slot vector (1, 2, 4, 8 or 16, 32 * slot_regs >= k_max), or 0 for the
// shared-memory instance ([k_max] floats of dynamic shared memory).
extern "C" int queue_flush_fwd(int slot_regs, const int* kind, const float* t, const float* s,
                               const int* req_off, const int* n_valid, const float* cap_t,
                               const int* cap_k, const float* hi_t, const int* cap_off,
                               const float* horizon, const float* slo, int J, int k_max,
                               float* lat, float* out, void* stream) {
  if (J <= 0 || k_max < 1 || (slot_regs > 0 && k_max > 32 * slot_regs))
    return (int)cudaErrorInvalidValue;
  const Flush f{kind, t, s, req_off, n_valid, cap_t, cap_k, hi_t, cap_off, horizon, slo,
                k_max, lat, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slot_regs) {
    case 1: return (int)launch<1>(f, J, 0, st);
    case 2: return (int)launch<2>(f, J, 0, st);
    case 4: return (int)launch<4>(f, J, 0, st);
    case 8: return (int)launch<8>(f, J, 0, st);
    case 16: return (int)launch<16>(f, J, 0, st);
    case 0: return (int)launch<0>(f, J, (size_t)k_max * sizeof(float), st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef REPRO_QUEUE_PHASES
// Copies the phase cycles of blocks [0, n) of the last launch to out, n x
// N_PHASES unsigned ints in the order of enum Phase.
extern "C" int queue_phase_cycles_read(unsigned* out, int n) {
  if (n < 0 || n > PHASE_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, queue_phase_cycles, sizeof(unsigned) * N_PHASES * n);
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
