// Backward of the chunkwise mLSTM for Hopper (sm_90a): dq, dk, dv and the
// float32 gate gradients di, df from q, k, v, the gates, the forward's h and
// dh. CUDA cores, float32 accumulation; q, k, v, h and dh in float32 or
// bfloat16.
//
// Replaces no Pallas kernel: the JAX package trains xLSTM by differentiating
// the pure-JAX repro.models.xlstm.mlstm_chunkwise through XLA (the Pallas
// mlstm_chunk_fwd, src/repro/kernels/mlstm_chunk/kernel.py, has no
// backward). The formulas are ref.mlstm_chunk_backward_reference's, with the
// stabilisers m_j and m_state held constant: h does not depend on them (every
// term of the numerator and the denominator carries exp(-m_j)), so that is
// the exact gradient.
//
// Bound on H100. At xlstm-1.3b's training layer (B 1, S 2048, H 4, dqk 512,
// dv 1024, chunk 256, bf16) the backward's own work is 41.9 GFLOP (cost.
// kernels.mlstm_backward(as_built=False): the reverse state pass, the scores
// once, dP, and the dq, dk, dv products) against 101 MB of inputs and
// outputs: bound by operations, 0.042 ms at the bf16 rate (989 TFLOP/s),
// against 0.030 ms for the bytes at 3.35 TB/s. This design does 51.6 GFLOP
// (the states recomputed, the scores twice), all of it as float32 FMAs on
// CUDA cores (67 TFLOP/s: 0.77 ms at best). The float32 scratch (the
// chunk-start states and their gradients, 2 x 64 MB at that shape) is not
// counted in the bound.
//
// Design: six launches on one stream, each grid filling the card, no atomics
// (every sum runs in a fixed order: a second call gives the same bits).
// Every product is a 64 x 64 output tile a block of 256 threads (4 x 4 a
// thread) over 16-deep slabs staged in shared memory (mma_tile).
// 1. gates, one block a (batch, head): cumsum, m_j, dec_q, dec_k, decay per
//    chunk, in the forward's operation order.
// 2. state, a block a (64 dv, 64 dqk, batch*head) tile: C_t and n_t at the
//    start of every chunk, recomputed forward from zero, to scratch.
// 3. rows, a block a (64-row query tile, chunk, batch*head): the scores once
//    for the denominator (sum_l s^2 D + dec_q q.n), N_j and dden_j (from
//    sum_e dh h); then scores and dP = dh v^T again, per 64-key tile up to
//    the diagonal: dS = D (dP / N + 2 s dden) and W = s D to scratch, and
//    dlogD's row sums and each row tile's column sums.
// 4. dstate, a block a (64 dv, 64 dqk, batch*head) tile: dC walked through
//    the chunks in reverse (dC = decay dC + (dec_q q)^T (dh / N)), each
//    chunk's dC and dn after it to scratch, and <C_t, dC> and n_t . dn
//    per tile for the decay's gradient.
// 5. grads, a block a (role and 64-column tile, 64-row tile, chunk*batch*
//    head): dq = dS k + dec_q (dh C_t^T / N + dden n_t), dk = dS^T q +
//    dec_k (v dC^T + dn), dv = W^T (dh / N) + dec_k k dC, and each d tile's
//    part of the two row sums the gates need.
// 6. gate grads, one block a (batch, head): di and df = the reverse cumsum
//    of db, summing the partials of 3 and 5 in order.
// Inputs must be contiguous [B, S, H, d] (the wrapper makes them so).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;          // rows and columns of an output tile
constexpr int KT = 16;            // depth of a shared-memory slab
constexpr int LD = TILE + 4;      // padded slab row (float4-aligned)
constexpr int MAX_C = 256;        // longest chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Slabs {
  __align__(16) float a[KT][LD];
  __align__(16) float b[KT][LD];
};

// acc[i][j] += sum_{k0 <= k < k1} A(ty * 4 + i, k) B(k, tx * 4 + j), with
// ty = tid / 16, tx = tid % 16. la(row, k) and lb(k, col) return the
// operands (zero outside the tensors); A_ROWS_FAST / B_COLS_FAST say which
// index is contiguous in memory, so that neighbouring threads load
// neighbouring addresses.
template <bool A_ROWS_FAST, bool B_COLS_FAST, class LA, class LB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], int k0, int k1, LA la, LB lb,
                                         Slabs& sm) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int kb = k0; kb < k1; kb += KT) {
    for (int e = tid; e < KT * TILE; e += THREADS) {
      const int ra = A_ROWS_FAST ? e % TILE : e / KT;
      const int ka = A_ROWS_FAST ? e / TILE : e % KT;
      sm.a[ka][ra] = kb + ka < k1 ? la(ra, kb + ka) : 0.f;
      const int cb = B_COLS_FAST ? e % TILE : e / KT;
      const int kk = B_COLS_FAST ? e / TILE : e % KT;
      sm.b[kk][cb] = kb + kk < k1 ? lb(kb + kk, cb) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// sum over the 16 threads of a tile row (one half-warp), in a fixed order
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum over the block in a fixed order; every thread must call it
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The shapes, the tensors and the float32 scratch. Positions are (bh, s) with
// bh = b * H + h; gate arrays are [BH, S], per-chunk ones [BH, T].
template <class T>
struct Args {
  const T *q, *k, *v, *h, *dh;
  const float *ig, *fg;
  T *dq, *dk, *dv;
  float *di, *df;
  int B, S, H, dqk, dv_, c, T_, R, DT, ET;
  // scratch
  float *gb, *gi, *gm, *gdq, *gdk, *gdecay;     // gates
  float *N, *dd, *rowsum, *colpart;              // rows: [BH,S] x 3, [R,BH,S]
  float *qpart, *kpart;                          // [DT,BH,S]
  float *cdot, *ndot;                            // [DT*ET,BH,T], [DT,BH,T]
  float *Cs, *ns, *Gs, *Gns;                     // [BH,T,dqk,dv], [BH,T,dqk]
  float *dS, *W;                                 // [BH,T,c,c]

  __device__ size_t row(int bh, int s) const {   // [B, S, H] row of (bh, s)
    return ((size_t)(bh / H) * S + s) * H + bh % H;
  }
  __device__ size_t pos(int bh, int s) const { return (size_t)bh * S + s; }
  __device__ size_t state(int bh, int t) const { return (size_t)bh * T_ + t; }
  __device__ size_t chunk_mat(int bh, int t, int j, int l) const {
    return (((size_t)bh * T_ + t) * c + j) * c + l;
  }
};

// 1. gates: one block a (batch, head), one thread a position of the chunk
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_gates_kernel(Args<T> a) {
  __shared__ float sf[MAX_C], si[MAX_C], sb[MAX_C], sg[MAX_C];
  __shared__ float s_mstate;
  const int bh = blockIdx.x, p = threadIdx.x, c = a.c;
  float m = 0.f;
  for (int t = 0; t < a.T_; ++t) {
    const int s = t * c + p;
    if (p < c) {
      sf[p] = a.fg[a.row(bh, s)];
      si[p] = a.ig[a.row(bh, s)];
    }
    __syncthreads();
    if (p == 0) {
      float acc = 0.f;
      for (int l = 0; l < c; ++l) sb[l] = acc += sf[l];
    }
    __syncthreads();
    const float btot = sb[c - 1];
    if (p < c) {
      const float bj = sb[p];
      float mi = -1e30f;
      for (int l = 0; l <= p; ++l) mi = fmaxf(mi, bj - sb[l] + si[l]);
      const float m_inter = bj + m;
      const float mj = fmaxf(mi, m_inter);
      a.gb[a.pos(bh, s)] = bj;
      a.gi[a.pos(bh, s)] = si[p];
      a.gm[a.pos(bh, s)] = mj;
      a.gdq[a.pos(bh, s)] = expf(m_inter - mj);
      sg[p] = btot - bj + si[p];
    }
    __syncthreads();
    if (p == 0) {
      float gmax = sg[0];
      for (int l = 1; l < c; ++l) gmax = fmaxf(gmax, sg[l]);
      const float m_state = fmaxf(btot + m, gmax);
      a.gdecay[a.state(bh, t)] = expf(btot + m - m_state);
      s_mstate = m_state;
    }
    __syncthreads();
    if (p < c) a.gdk[a.pos(bh, s)] = expf(sg[p] - s_mstate);
    m = s_mstate;
    __syncthreads();
  }
}

// 2. state: C_t, n_t at the start of every chunk, a (dv, dqk) tile a block
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_state_kernel(Args<T> a) {
  __shared__ Slabs sm;
  const int e0 = blockIdx.x * TILE, d0 = blockIdx.y * TILE, bh = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, c = a.c;
  const int dqk = a.dqk, dv = a.dv_;
  float acc[4][4];
  zero(acc);
  float n = 0.f;                                 // n[d0 + tid], tile column 0 only
  const bool n_owner = blockIdx.x == 0 && tid < TILE && d0 + tid < dqk;
  for (int t = 0; t < a.T_; ++t) {
    float* Ct = a.Cs + a.state(bh, t) * dqk * dv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + ty * 4 + i, e = e0 + tx * 4 + j;
        if (d < dqk && e < dv) Ct[(size_t)d * dv + e] = acc[i][j];
      }
    if (n_owner) a.ns[a.state(bh, t) * dqk + d0 + tid] = n;
    const float decay = a.gdecay[a.state(bh, t)];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    const int s0 = t * c;
    mma_tile<true, true>(
        acc, 0, c,
        [&](int r, int l) {
          const int d = d0 + r;
          return d < dqk ? a.gdk[a.pos(bh, s0 + l)] * to_f(a.k[a.row(bh, s0 + l) * dqk + d])
                         : 0.f;
        },
        [&](int l, int col) {
          const int e = e0 + col;
          return e < dv ? to_f(a.v[a.row(bh, s0 + l) * dv + e]) : 0.f;
        },
        sm);
    if (n_owner) {
      float kd = 0.f;
      for (int l = 0; l < c; ++l)
        kd += to_f(a.k[a.row(bh, s0 + l) * dqk + d0 + tid]) * a.gdk[a.pos(bh, s0 + l)];
      n = n * decay + kd;
    }
  }
}

// 3. rows: the denominator, N and dden of a 64-row query tile, then dS, W and
// dlogD's row and column sums over the key tiles up to the diagonal
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_rows_kernel(Args<T> a) {
  __shared__ Slabs sm;
  __shared__ float s_qn[TILE], s_dhh[TILE], s_den[TILE], s_N[TILE], s_dd[TILE];
  __shared__ float s_col[16][TILE];
  const int r = blockIdx.x, t = blockIdx.y, bh = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid & 31, warp = tid >> 5;
  const int c = a.c, dqk = a.dqk, dv = a.dv_, j0 = r * TILE, s0 = t * c;
  const float* nt = a.ns + a.state(bh, t) * dqk;

  // q_j . n_t and dh_j . h_j, a warp a row
  for (int jj = warp; jj < TILE; jj += THREADS / 32) {
    const int j = j0 + jj;
    float qn = 0.f, dhh = 0.f;
    if (j < c) {
      const size_t rw = a.row(bh, s0 + j);
      for (int d = lane; d < dqk; d += 32) qn += to_f(a.q[rw * dqk + d]) * nt[d];
      for (int e = lane; e < dv; e += 32) dhh += to_f(a.dh[rw * dv + e]) * to_f(a.h[rw * dv + e]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qn += __shfl_xor_sync(0xffffffffu, qn, o);
      dhh += __shfl_xor_sync(0xffffffffu, dhh, o);
    }
    if (lane == 0) {
      s_qn[jj] = qn;
      s_dhh[jj] = dhh;
    }
  }

  auto q_of = [&](int i, int d) {
    const int j = j0 + i;
    return j < c ? to_f(a.q[a.row(bh, s0 + j) * dqk + d]) : 0.f;
  };
  float acc[4][4];
  // sweep 1: the intra denominator sum_l s_jl^2 D_jl
  float den[4] = {0.f, 0.f, 0.f, 0.f};
  for (int lt = 0; lt <= r; ++lt) {
    const int l0 = lt * TILE;
    zero(acc);
    mma_tile<false, false>(
        acc, 0, dqk, q_of,
        [&](int d, int col) {
          const int l = l0 + col;
          return l < c ? to_f(a.k[a.row(bh, s0 + l) * dqk + d]) : 0.f;
        },
        sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + ty * 4 + i;
      if (j >= c) continue;
      const float bj = a.gb[a.pos(bh, s0 + j)], mj = a.gm[a.pos(bh, s0 + j)];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int l = l0 + tx * 4 + jj;
        if (l > j) continue;
        const float D = expf(bj - a.gb[a.pos(bh, s0 + l)] + a.gi[a.pos(bh, s0 + l)] - mj);
        den[i] += acc[i][jj] * acc[i][jj] * D;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = row_sum(den[i]);
    if (tx == 0) s_den[ty * 4 + i] = x;
  }
  __syncthreads();
  if (tid < TILE) {
    const int j = j0 + tid;
    float N = 1.f, dd = 0.f;
    if (j < c) {
      const size_t p = a.pos(bh, s0 + j);
      const float dn = s_den[tid] + s_qn[tid] * a.gdq[p];
      const float flo = expf(-a.gm[p]);
      N = fmaxf(fabsf(dn), flo);
      const float dN = -s_dhh[tid] / N;
      dd = fabsf(dn) >= flo ? dN * (float)((dn > 0.f) - (dn < 0.f)) : 0.f;
      a.N[p] = N;
      a.dd[p] = dd;
    }
    s_N[tid] = N;
    s_dd[tid] = dd;
  }
  __syncthreads();

  // sweep 2: dS, W, dlogD's sums
  float rows[4] = {0.f, 0.f, 0.f, 0.f};
  float pacc[4][4];
  for (int lt = 0; lt <= r; ++lt) {
    const int l0 = lt * TILE;
    zero(acc);
    zero(pacc);
    mma_tile<false, false>(
        acc, 0, dqk, q_of,
        [&](int d, int col) {
          const int l = l0 + col;
          return l < c ? to_f(a.k[a.row(bh, s0 + l) * dqk + d]) : 0.f;
        },
        sm);
    mma_tile<false, false>(
        pacc, 0, dv,
        [&](int i, int e) {
          const int j = j0 + i;
          return j < c ? to_f(a.dh[a.row(bh, s0 + j) * dv + e]) : 0.f;
        },
        [&](int e, int col) {
          const int l = l0 + col;
          return l < c ? to_f(a.v[a.row(bh, s0 + l) * dv + e]) : 0.f;
        },
        sm);
    float cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jl = ty * 4 + i, j = j0 + jl;
      if (j >= c) continue;
      const float bj = a.gb[a.pos(bh, s0 + j)], mj = a.gm[a.pos(bh, s0 + j)];
      const float N = s_N[jl], dd = s_dd[jl];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int l = l0 + tx * 4 + jj;
        if (l >= c) continue;
        float ds = 0.f, w = 0.f, dl = 0.f;
        if (l <= j) {
          const float D = expf(bj - a.gb[a.pos(bh, s0 + l)] + a.gi[a.pos(bh, s0 + l)] - mj);
          const float s = acc[i][jj], dp = pacc[i][jj] / N;
          ds = D * (dp + 2.f * s * dd);
          w = s * D;
          dl = D * s * (dp + s * dd);
        }
        a.dS[a.chunk_mat(bh, t, j, l)] = ds;
        a.W[a.chunk_mat(bh, t, j, l)] = w;
        rows[i] += dl;
        cols[jj] += dl;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s_col[ty][tx * 4 + jj] = cols[jj];
    __syncthreads();
    if (tid < TILE && l0 + tid < c) {
      float x = 0.f;
      for (int y = 0; y < 16; ++y) x += s_col[y][tid];
      a.colpart[((size_t)r * a.B * a.H + bh) * a.S + s0 + l0 + tid] = x;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = row_sum(rows[i]);
    const int j = j0 + ty * 4 + i;
    if (tx == 0 && j < c) a.rowsum[a.pos(bh, s0 + j)] = x;
  }
}

// 4. dstate: dC after each chunk, walked in reverse, a (dv, dqk) tile a block
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_dstate_kernel(Args<T> a) {
  __shared__ Slabs sm;
  __shared__ float red[THREADS / 32];
  const int e0 = blockIdx.x * TILE, d0 = blockIdx.y * TILE, bh = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, c = a.c;
  const int dqk = a.dqk, dv = a.dv_;
  const bool n_block = blockIdx.x == 0;
  const bool n_owner = n_block && tid < TILE && d0 + tid < dqk;
  float acc[4][4];
  zero(acc);
  float gn = 0.f;
  for (int t = a.T_ - 1; t >= 0; --t) {
    const size_t st = a.state(bh, t);
    const float* Ct = a.Cs + st * dqk * dv;
    float* Gt = a.Gs + st * dqk * dv;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + ty * 4 + i, e = e0 + tx * 4 + j;
        if (d < dqk && e < dv) {
          Gt[(size_t)d * dv + e] = acc[i][j];
          part += Ct[(size_t)d * dv + e] * acc[i][j];
        }
      }
    part = block_sum(part, red);
    if (tid == 0)
      a.cdot[((size_t)blockIdx.y * a.ET + blockIdx.x) * a.B * a.H * a.T_ + st] = part;
    if (n_block) {
      float np = 0.f;
      if (n_owner) {
        a.Gns[st * dqk + d0 + tid] = gn;
        np = a.ns[st * dqk + d0 + tid] * gn;
      }
      np = block_sum(np, red);
      if (tid == 0) a.ndot[(size_t)blockIdx.y * a.B * a.H * a.T_ + st] = np;
    }
    const float decay = a.gdecay[st];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    const int s0 = t * c;
    mma_tile<true, true>(
        acc, 0, c,
        [&](int r, int jq) {
          const int d = d0 + r;
          return d < dqk ? a.gdq[a.pos(bh, s0 + jq)] * to_f(a.q[a.row(bh, s0 + jq) * dqk + d])
                         : 0.f;
        },
        [&](int jq, int col) {
          const int e = e0 + col;
          return e < dv ? to_f(a.dh[a.row(bh, s0 + jq) * dv + e]) / a.N[a.pos(bh, s0 + jq)]
                        : 0.f;
        },
        sm);
    if (n_owner) {
      float x = 0.f;
      for (int jq = 0; jq < c; ++jq) {
        const size_t p = a.pos(bh, s0 + jq);
        x += to_f(a.q[a.row(bh, s0 + jq) * dqk + d0 + tid]) * (a.gdq[p] * a.dd[p]);
      }
      gn = decay * gn + x;
    }
  }
}

// 5. grads: blockIdx.x < DT a dq tile, < 2 DT a dk tile, else a dv tile; a
// 64-row tile of the chunk; blockIdx.z = bh * T + t
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_grads_kernel(Args<T> a) {
  __shared__ Slabs sm;
  const int x = blockIdx.x, r = blockIdx.y;
  const int t = blockIdx.z % a.T_, bh = blockIdx.z / a.T_;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = a.c, dqk = a.dqk, dv = a.dv_, j0 = r * TILE, s0 = t * c;
  const size_t st = a.state(bh, t);
  float acc[4][4], acc2[4][4];
  zero(acc);
  zero(acc2);
  if (x < a.DT) {                                         // dq
    const int d0 = x * TILE;
    const float* Ct = a.Cs + st * dqk * dv;
    const float* nt = a.ns + st * dqk;
    mma_tile<false, true>(
        acc, 0, min(c, j0 + TILE),
        [&](int i, int l) { return j0 + i < c ? a.dS[a.chunk_mat(bh, t, j0 + i, l)] : 0.f; },
        [&](int l, int col) {
          return d0 + col < dqk ? to_f(a.k[a.row(bh, s0 + l) * dqk + d0 + col]) : 0.f;
        },
        sm);
    mma_tile<false, false>(
        acc2, 0, dv,
        [&](int i, int e) {
          return j0 + i < c ? to_f(a.dh[a.row(bh, s0 + j0 + i) * dv + e]) : 0.f;
        },
        [&](int e, int col) { return d0 + col < dqk ? Ct[(size_t)(d0 + col) * dv + e] : 0.f; },
        sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + ty * 4 + i;
      float part = 0.f;
      if (j < c) {
        const size_t p = a.pos(bh, s0 + j), rw = a.row(bh, s0 + j);
        const float N = a.N[p], dd = a.dd[p], dq_ = a.gdq[p];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int d = d0 + tx * 4 + jj;
          if (d >= dqk) continue;
          const float inter = acc2[i][jj] / N + dd * nt[d];
          a.dq[rw * dqk + d] = from_f<T>(acc[i][jj] + dq_ * inter);
          part += to_f(a.q[rw * dqk + d]) * inter;
        }
      }
      part = row_sum(part);
      if (tx == 0 && j < c) a.qpart[((size_t)x * a.B * a.H + bh) * a.S + s0 + j] = part;
    }
  } else if (x < 2 * a.DT) {                              // dk
    const int dt = x - a.DT, d0 = dt * TILE;
    const float* Gt = a.Gs + st * dqk * dv;
    const float* gnt = a.Gns + st * dqk;
    mma_tile<true, true>(
        acc, j0, c,
        [&](int i, int jq) { return j0 + i < c ? a.dS[a.chunk_mat(bh, t, jq, j0 + i)] : 0.f; },
        [&](int jq, int col) {
          return d0 + col < dqk ? to_f(a.q[a.row(bh, s0 + jq) * dqk + d0 + col]) : 0.f;
        },
        sm);
    mma_tile<false, false>(
        acc2, 0, dv,
        [&](int i, int e) {
          return j0 + i < c ? to_f(a.v[a.row(bh, s0 + j0 + i) * dv + e]) : 0.f;
        },
        [&](int e, int col) { return d0 + col < dqk ? Gt[(size_t)(d0 + col) * dv + e] : 0.f; },
        sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = j0 + ty * 4 + i;
      float part = 0.f;
      if (l < c) {
        const size_t p = a.pos(bh, s0 + l), rw = a.row(bh, s0 + l);
        const float dk_ = a.gdk[p];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int d = d0 + tx * 4 + jj;
          if (d >= dqk) continue;
          const float rr = acc2[i][jj] + gnt[d];
          a.dk[rw * dqk + d] = from_f<T>(acc[i][jj] + dk_ * rr);
          part += to_f(a.k[rw * dqk + d]) * rr;
        }
      }
      part = row_sum(part);
      if (tx == 0 && l < c) a.kpart[((size_t)dt * a.B * a.H + bh) * a.S + s0 + l] = part;
    }
  } else {                                                // dv
    const int e0 = (x - 2 * a.DT) * TILE;
    const float* Gt = a.Gs + st * dqk * dv;
    mma_tile<true, true>(
        acc, j0, c,
        [&](int i, int jq) { return j0 + i < c ? a.W[a.chunk_mat(bh, t, jq, j0 + i)] : 0.f; },
        [&](int jq, int col) {
          return e0 + col < dv
                     ? to_f(a.dh[a.row(bh, s0 + jq) * dv + e0 + col]) / a.N[a.pos(bh, s0 + jq)]
                     : 0.f;
        },
        sm);
    mma_tile<false, true>(
        acc2, 0, dqk,
        [&](int i, int d) {
          return j0 + i < c ? to_f(a.k[a.row(bh, s0 + j0 + i) * dqk + d]) : 0.f;
        },
        [&](int d, int col) { return e0 + col < dv ? Gt[(size_t)d * dv + e0 + col] : 0.f; },
        sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = j0 + ty * 4 + i;
      if (l >= c) continue;
      const size_t rw = a.row(bh, s0 + l);
      const float dk_ = a.gdk[a.pos(bh, s0 + l)];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = e0 + tx * 4 + jj;
        if (e < dv) a.dv[rw * dv + e] = from_f<T>(acc[i][jj] + dk_ * acc2[i][jj]);
      }
    }
  }
}

// 6. gate grads: di and df, one block a (batch, head)
template <class T>
__global__ void __launch_bounds__(THREADS, 2) mlstm_bwd_gate_grads_kernel(Args<T> a) {
  __shared__ float sdb[MAX_C], sdg[MAX_C], sdf[MAX_C];
  const int bh = blockIdx.x, p = threadIdx.x, c = a.c;
  const size_t BH = (size_t)a.B * a.H;
  for (int t = 0; t < a.T_; ++t) {
    const int s = t * c + p;
    if (p < c) {
      const size_t q = a.pos(bh, s);
      float col = 0.f;
      for (int r = p / TILE; r < a.R; ++r) col += a.colpart[r * BH * a.S + q];
      float qs = 0.f, ks = 0.f;
      for (int dt = 0; dt < a.DT; ++dt) {
        qs += a.qpart[dt * BH * a.S + q];
        ks += a.kpart[dt * BH * a.S + q];
      }
      const float dg = a.gdk[q] * ks;
      sdb[p] = a.rowsum[q] - col - dg + a.gdq[q] * qs;
      sdg[p] = dg;
      a.di[a.row(bh, s)] = col + dg;
    }
    __syncthreads();
    if (p == 0) {
      const size_t st = a.state(bh, t);
      float dots = 0.f;
      for (int i = 0; i < a.DT * a.ET; ++i) dots += a.cdot[i * BH * a.T_ + st];
      float nd = 0.f;
      for (int i = 0; i < a.DT; ++i) nd += a.ndot[i * BH * a.T_ + st];
      float dbtot = 0.f;
      for (int l = 0; l < c; ++l) dbtot += sdg[l];
      sdb[c - 1] += dbtot + a.gdecay[st] * (dots + nd);
      float acc = 0.f;
      for (int l = c - 1; l >= 0; --l) sdf[l] = acc += sdb[l];
    }
    __syncthreads();
    if (p < c) a.df[a.row(bh, s)] = sdf[p];
    __syncthreads();
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The float32 scratch the wrapper allocates (ops.workspace_floats).
size_t workspace_floats(int B, int S, int H, int dqk, int dv, int c) {
  const size_t BH = (size_t)B * H, T = S / c;
  const size_t R = ceil_div(c, TILE), DT = ceil_div(dqk, TILE), ET = ceil_div(dv, TILE);
  return BH * S * (8 + R + 2 * DT) + BH * T * (1 + DT * ET + DT) +
         2 * BH * T * dqk * (dv + 1) + 2 * BH * S * c;
}

template <class T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ig,
                   const float* fg, const void* h, const void* dh, void* dq, void* dk,
                   void* dv, float* di, float* df, float* ws, int B, int S, int H, int dqk,
                   int dv_, int c, cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.h = static_cast<const T*>(h);
  a.dh = static_cast<const T*>(dh);
  a.ig = ig;
  a.fg = fg;
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.di = di;
  a.df = df;
  a.B = B, a.S = S, a.H = H, a.dqk = dqk, a.dv_ = dv_, a.c = c, a.T_ = S / c;
  a.R = ceil_div(c, TILE), a.DT = ceil_div(dqk, TILE), a.ET = ceil_div(dv_, TILE);
  const size_t BH = (size_t)B * H, NT = S / c;
  float* p = ws;
  auto take = [&](size_t n) { float* x = p; p += n; return x; };
  a.gb = take(BH * S), a.gi = take(BH * S), a.gm = take(BH * S);
  a.gdq = take(BH * S), a.gdk = take(BH * S), a.gdecay = take(BH * NT);
  a.N = take(BH * S), a.dd = take(BH * S), a.rowsum = take(BH * S);
  a.colpart = take(a.R * BH * S);
  a.qpart = take(a.DT * BH * S), a.kpart = take(a.DT * BH * S);
  a.cdot = take(a.DT * a.ET * BH * NT), a.ndot = take(a.DT * BH * NT);
  a.Cs = take(BH * NT * dqk * dv_), a.Gs = take(BH * NT * dqk * dv_);
  a.ns = take(BH * NT * dqk), a.Gns = take(BH * NT * dqk);
  a.dS = take(BH * S * c), a.W = take(BH * S * c);

  const dim3 tiles(a.ET, a.DT, B * H);
  mlstm_bwd_gates_kernel<T><<<B * H, THREADS, 0, stream>>>(a);
  mlstm_bwd_state_kernel<T><<<tiles, THREADS, 0, stream>>>(a);
  mlstm_bwd_rows_kernel<T><<<dim3(a.R, a.T_, B * H), THREADS, 0, stream>>>(a);
  mlstm_bwd_dstate_kernel<T><<<tiles, THREADS, 0, stream>>>(a);
  mlstm_bwd_grads_kernel<T><<<dim3(2 * a.DT + a.ET, a.R, B * H * a.T_), THREADS, 0, stream>>>(a);
  mlstm_bwd_gate_grads_kernel<T><<<B * H, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v, h, dh, dq, dk, dv); float32 gates
// [B, S, H] and di, df; every tensor contiguous. ws: workspace_floats(...)
// float32 scratch (ws_floats must equal it). Returns a cudaError_t.
extern "C" int mlstm_chunk_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ig, const float* fg, const void* h,
                               const void* dh, void* dq, void* dk, void* dv, float* di,
                               float* df, float* ws, int64_t ws_floats, int B, int S, int H,
                               int dqk, int dv_, int c, void* stream) {
  if (c <= 0 || c > MAX_C || S <= 0 || S % c != 0 || dqk <= 0 || dv_ <= 0 || B * H <= 0 ||
      B * H > 65535 || (int64_t)B * H * (S / c) > 65535 ||
      (size_t)ws_floats != workspace_floats(B, S, H, dqk, dv_, c))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, ig, fg, h, dh, dq, dk, dv, di, df, ws, B, S, H, dqk,
                              dv_, c, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, ig, fg, h, dh, dq, dk, dv, di, df, ws, B, S,
                                      H, dqk, dv_, c, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
