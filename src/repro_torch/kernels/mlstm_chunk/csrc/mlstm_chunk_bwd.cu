// Backward of the chunkwise mLSTM for Hopper (sm_90a): dq, dk, dv and the
// float32 gate gradients di, df from q, k, v, the gates, the forward's h and
// dh; q, k, v, h and dh in float32 or bfloat16.
//
// Replaces no Pallas kernel: the JAX package trains xLSTM by differentiating
// the pure-JAX repro.models.xlstm.mlstm_chunkwise through XLA (the Pallas
// mlstm_chunk_fwd, src/repro/kernels/mlstm_chunk/kernel.py, has no
// backward). The formulas are ref.mlstm_chunk_backward_reference's, with the
// stabilisers m_j and m_state held constant: h does not depend on them (every
// term of the numerator and the denominator carries exp(-m_j)), so that is
// the exact gradient. Per chunk t, with s = q k^T, D = exp(logD - m_j), N =
// max(|den|, e^{-m_j}), dden, C_t the state at the chunk's start and G_t the
// gradient of the state after it:
//   dS = D (dh v^T / N + 2 s dden),  W' = s D / N,
//   dq = dS k + dec_q (dh C_t^T / N + dden n_t),
//   dk = dS^T q + dec_k (v G_t^T + dn_t),  dv = W'^T dh + dec_k k G_t,
//   G_{t-1} = decay G_t + (dec_q q / N)^T dh.
//
// Bound on H100. At xlstm-1.3b's training layer (B 1, S 2048, H 4, dqk 512,
// dv 1024, chunk 256, bf16) the backward's own work is 41.9 GFLOP (cost.
// kernels.mlstm_backward(as_built=False): the reverse state pass, the scores
// once, dP, and the dq, dk, dv products) against 101 MB of inputs and
// outputs: bound by operations, 0.042 ms at the bf16 rate (989 TFLOP/s),
// against 0.030 ms for the bytes at 3.35 TB/s.
//
// Two paths, chosen by the wrapper on dtype and shape alone (ops.backward_path):
//
// * bfloat16 with 64 <= dqk <= 512 and dv >= 64 -> five launches, every
//   product on the tensor cores (wgmma m64nNk16, bf16 operands, float32
//   accumulators), every operand tile fed by TMA through mbarrier rings
//   (common/hopper.cuh; q, k, v, dh planned by kernels/_tma.py, the scratch
//   maps built here; ragged dqk and dv boxes are filled with zeros by TMA):
//   1. state, grid (ceil(dv / 256), ceil(dqk / 64), B H): C_t at the start
//      of every chunk (the forward's state pass: a float32 m64n256 tile
//      walked through the chunks, C += (dec_k k)^T v), to scratch, and
//      n_t; its warp 0 also forms the gate terms (cumsum, m_j by a prefix
//      max, dec_q, dec_k, decay) that the later passes read;
//   2. rows, grid (ceil(c / 64), T, B H): per 64 query rows, S = q k^T once
//      per key tile up to the diagonal (kept in shared memory), the
//      denominator, N and dden; then dP = dh v^T per key tile, dS and W' as
//      [c, c] tiles of the chunk to scratch, dlogD's row and column sums;
//   3. dstate, grid as 1: G_t walked back through the chunks (a float32
//      m64n256 tile, G += (dec_q q / N)^T dh), to scratch, with dn_t,
//      <C_t, G_t> and n_t . dn_t per tile;
//   4. grads, grid (2 ceil(dqk / 256) + ceil(dv / 256), ceil(c / 64), B H T):
//      a 64 x 256 tile of dq, dk or dv; its inter term first (dh C_t^T, v
//      G_t^T or k G_t over dv or dqk), then the row-wise terms, then the
//      intra term (dS k, dS^T q or W'^T dh over the chunk), shaped as
//      flash_attention_bwd.cu's dQ and dK/dV kernels;
//   5. gate grads, grid (T, B H): di and df by warp scans.
//   Precision: q, k, v and dh are bf16 already; every float32 value that
//   enters a product (dec_k k and dec_q q / N in the walks, C_t, G_t, dS and
//   W') is split into bf16 hi + lo = bf16(x - hi), one product each, which
//   leaves ~2^-17 a term. One rounding (2^-9) of any one of them broke
//   grad_tol's elementwise bound (an emulation of the roundings on the CPU,
//   then the card: worst elements at 1.1-13.8 of it at the check shapes),
//   where rows with a small N make a few terms large and the sum cancels.
//   The splits double the walks', the inter terms' and the intra dS / W'
//   products (cost.kernels.mlstm_backward counts them).
//   Scratch (tc_workspace_floats): the gate terms, N, dden and the partial
//   sums per position; C_t and G_t as bf16 hi and lo (4 B H (T - 1) dqk dv
//   bytes each: 58.7 MB at the training shape); dS and W' as bf16 hi and
//   lo (4 B H T cp^2 bytes each, cp = c rounded up to 64: 8.4 MB).
// * float32, and bfloat16 with dqk or dv outside those widths -> six
//   launches on CUDA cores (float32 FMAs; bf16 is widened as it is loaded):
//   wgmma in float32 would be TF32, which breaks the float32 tolerance, and a
//   row narrower than 64 is below one swizzle box. Every product is a 64 x
//   64 output tile a block of 256 threads (4 x 4 a thread) over 16-deep
//   slabs staged in shared memory (mma_tile).
//   1. gates, one block a (batch, head): cumsum, m_j, dec_q, dec_k, decay per
//      chunk, in the forward's operation order.
//   2. state, a block a (64 dv, 64 dqk, batch*head) tile: C_t and n_t at the
//      start of every chunk, recomputed forward from zero, to scratch.
//   3. rows, a block a (64-row query tile, chunk, batch*head): the scores once
//      for the denominator (sum_l s^2 D + dec_q q.n), N_j and dden_j (from
//      sum_e dh h); then scores and dP = dh v^T again, per 64-key tile up to
//      the diagonal: dS = D (dP / N + 2 s dden) and W = s D to scratch, and
//      dlogD's row sums and each row tile's column sums.
//   4. dstate, a block a (64 dv, 64 dqk, batch*head) tile: dC walked through
//      the chunks in reverse (dC = decay dC + (dec_q q)^T (dh / N)), each
//      chunk's dC and dn after it to scratch, and <C_t, dC> and n_t . dn
//      per tile for the decay's gradient.
//   5. grads, a block a (role and 64-column tile, 64-row tile, chunk*batch*
//      head): dq = dS k + dec_q (dh C_t^T / N + dden n_t), dk = dS^T q +
//      dec_k (v dC^T + dn), dv = W^T (dh / N) + dec_k k dC, and each d tile's
//      part of the two row sums the gates need.
//   6. gate grads, one block a (batch, head): di and df = the reverse cumsum
//      of db, summing the partials of 3 and 5 in order.
//   Its float32 scratch holds the chunk-start states and their gradients (2
//   x 64 MB at the training shape) and dS, W [c, c] per chunk.
// No atomics on either path: every sum runs in a fixed order, so a second
// call gives the same bits. Inputs must be contiguous [B, S, H, d] (the
// wrapper makes them so).

#include "common/hopper.cuh"                  // mbarriers, TMA, wgmma
#include "mlstm_chunk/csrc/mlstm_gates.cuh"   // chunk_gates, next_m (shared with the forward)

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

// ---------------------------------------------------------------------------
// bfloat16 at 64 <= dqk <= 512 and dv >= 64: the tensor-core path
// ---------------------------------------------------------------------------

constexpr int WG = 128;                  // threads in a warpgroup
constexpr int TC_THREADS = WG + 32;      // a consumer warpgroup and a producer warp
constexpr int BOX = 64 * 128;            // one [64 rows x 64 columns] bf16 TMA box
constexpr int TC_N = 256;                // columns of an m64n256 wgmma tile
constexpr int TC_MAX_DQK = 512;
constexpr int PLAN = TMA_PLAN_VALUES;    // int64 values of one tensor-map plan
constexpr int BAR_WG = 1;                // named barrier of the consumer warpgroup

// The shapes, the tensors and the scratch of the tensor-core path. Positions
// are (bh, s) with bh = b * H + h; gate arrays are [BH, S], per-chunk ones
// [BH, T]. C_t (t >= 1) and G_t (t <= T - 2) live in slots bh * (T - 1) + t - 1
// and bh * (T - 1) + t of [2, BH (T - 1), dqk, dv], dS and W' of chunk t in
// slot bh * T + t of [2, BH T, cp, cp]: bf16 hi in the first half, lo =
// bf16(x - hi) in the second.
struct Tc {
  const __nv_bfloat16 *q, *k, *h, *dh;
  const float *ig, *fg;
  __nv_bfloat16 *dq, *dk, *dv;
  float *di, *df;
  int B, S, H, dqk, dv_, c, T, R, DH, EH, DT, cp;
  float *gb, *gi, *gm, *gdq, *gdk, *gdecay;   // b, i, m_j, dec_q, dec_k [BH,S]; decay [BH,T]
  float *N, *dd, *rowsum, *colpart;           // [BH,S] x 3, [R,BH,S]
  float *qpart, *kpart;                       // [DH,BH,S]
  float *cdot, *ndot;                         // [DT*EH,BH,T], [DT,BH,T]
  float *ns, *gns;                            // n_t, dn_t [BH*(T-1), dqk]
  __nv_bfloat16 *cs, *gs;                     // C_t, G_t [2, BH*(T-1), dqk, dv]
  __nv_bfloat16 *ds, *w;                      // dS, W' [2, BH*T, cp, cp]

  __device__ size_t row(int bh, int s) const {  // [B, S, H] row of (bh, s)
    return ((size_t)(bh / H) * S + s) * H + bh % H;
  }
  __device__ size_t pos(int bh, int s) const { return (size_t)bh * S + s; }
};

__device__ __forceinline__ void wg_sync() { named_bar_sync(BAR_WG, WG); }

// sum over the consumer warpgroup in a fixed order; all 128 threads call it
__device__ __forceinline__ float wg_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  wg_sync();
  const float s = (red[0] + red[1]) + (red[2] + red[3]);
  wg_sync();
  return s;
}

// 1024-aligned base of the dynamic shared memory: (shared address, pointer)
__device__ __forceinline__ uint32_t smem_base(unsigned char*& ptr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  ptr = smem_raw + (base - raw);
  return base;
}

__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, WG);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Producer side of a ring: wait until stage `item % stages` is free, arm its
// barrier for `bytes`; returns the stage.
__device__ __forceinline__ int ring_stage(uint32_t full0, uint32_t empty0, int stages, int item,
                                          uint32_t bytes) {
  const int s = item % stages;
  if (item >= stages) mbar_wait(empty0 + 8 * s, ((item / stages) & 1) ^ 1);
  mbar_expect_tx(full0 + 8 * s, bytes);
  return s;
}

__device__ __forceinline__ void split_pair(float x0, float x1, __nv_bfloat162& hi,
                                           __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x0, x1);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x0 - h.x, x1 - h.y);
}

// Consumer side of a ring whose products stay one group in flight: after the
// group reading stage s is committed, wait for the group before it and free
// that group's stage. drain() waits for all and frees the last stage.
struct Pipe {
  uint32_t empty0;
  int prev = -1;
  __device__ __forceinline__ void committed(int s) {
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
    prev = -1;
  }
};

// The m64n256 accumulator of a consumer thread: register 4 i + 2 half + e
// is row r0 + 8 half, column 8 i + cq + e. Stores the tile at rows d0.., columns
// e0.. of a row-major [rows, width] bf16 matrix as hi (at dst) and lo (at dst
// + lo_off), inside rows x width only.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, size_t lo_off, const float* acc,
                                           int d0, int e0, int rows, int width, int r0, int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = d0 + r0 + 8 * half;
    if (d >= rows) continue;
#pragma unroll
    for (int i = 0; i < TC_N / 8; ++i) {
      const int col = e0 + 8 * i + cq;
      if (col < width) {
        __nv_bfloat162 hi, lo;
        split_pair(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1], hi, lo);
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)d * width + col) = hi;
        *reinterpret_cast<__nv_bfloat162*>(dst + lo_off + (size_t)d * width + col) = lo;
      }
    }
  }
}

// sum over the thread's part of the tile of acc times a [rows, width] matrix
// stored as store_tile stores it (hi + lo)
__device__ __forceinline__ float tile_dot(const __nv_bfloat16* src, size_t lo_off, const float* acc,
                                          int d0, int e0, int rows, int width, int r0, int cq) {
  float part = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = d0 + r0 + 8 * half;
    if (d >= rows) continue;
#pragma unroll
    for (int i = 0; i < TC_N / 8; ++i) {
      const int col = e0 + 8 * i + cq;
      if (col < width) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)d * width + col));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(src + lo_off + (size_t)d * width + col));
        part = fmaf(x.x + y.x, acc[4 * i + 2 * half], part);
        part = fmaf(x.y + y.y, acc[4 * i + 2 * half + 1], part);
      }
    }
  }
  return part;
}

// --- the state and dstate passes -------------------------------------------

constexpr int WK_STAGES = 4;
constexpr int WK_STAGE_BYTES = 6 * BOX;  // the scaled rows (hi), their lo part, 4 boxes of the other operand

struct WalkLayout {                      // byte offsets from the 1024-aligned base
  static constexpr int F_OFF = WK_STAGES * WK_STAGE_BYTES;
  static constexpr int FLOATS = 4 * MAX_C + 8 + 16 * 64;  // b, i, two row scales, scalars, n sums
  static constexpr int BAR_OFF = F_OFF + 4 * FLOATS;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * WK_STAGES + 1024;
};

// One walk over the chunks of a (64 dqk rows, 256 dv columns, bh) tile with
// the tile as a float32 m64n256 accumulator X. Forward (the state pass, X =
// C): at chunk t, X = C_t goes to cs (t >= 1); then X = decay X + (dec_k
// k)^T v. Reverse (the dstate pass, X = G): at chunk t, X = G_t goes to gs
// (t <= T - 2) and <C_t, G_t> to cdot; then X = decay X + (dec_q q / N)^T dh.
// The rows of A arrive through TMA and are scaled in shared memory (the
// 128-byte swizzle moves whole 16-byte chunks within a row, so a row scale
// ignores it), split into bf16 hi and lo = bf16(x - hi), and both run against
// the 4 boxes of B (A as the MN-major operand, B MN-major). X is stored as
// hi + lo. The dv-tile-0 blocks carry the n vectors on CUDA
// cores: n += sum_l dec_k k_l, dn += sum_j dec_q dden q_j.
template <bool REVERSE>
__device__ __forceinline__ void walk(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                     const Tc& a) {
  using L = WalkLayout;
  unsigned char* gbase;
  const uint32_t base = smem_base(gbase);
  float* s_b = reinterpret_cast<float*>(gbase + L::F_OFF);   // [MAX_C]
  float* s_i = s_b + MAX_C;                                  // [MAX_C]
  float* s_sa = s_i + MAX_C;       // [MAX_C] the product's row scale, 0 past c
  float* s_sn = s_sa + MAX_C;      // [MAX_C] the n vector's row scale
  float* s_scal = s_sn + MAX_C;    // decay, m_state, -, -, block sums [4]
  float* s_nsum = s_scal + 8;      // [16][64]
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * WK_STAGES;

  const int e0 = blockIdx.x * TC_N, d0 = blockIdx.y * 64, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, c = a.c, T = a.T, dqk = a.dqk, dv = a.dv_;
  const int BH = a.B * a.H;
  const int slabs = (c + 63) / 64;
  const int nvb = min(4, (dv - e0 + 63) / 64);              // B boxes inside dv
  const bool keeps_n = blockIdx.x == 0;
  const size_t lo_off = (size_t)BH * (T - 1) * dqk * dv;    // from a hi state to its lo part

  if (threadIdx.x == 0) init_ring(full0, empty0, WK_STAGES);
  __syncthreads();

  if (threadIdx.x >= WG) {             // producer: chunk rows in the order of the walk
    if (threadIdx.x != WG) return;
    int item = 0;
    for (int u = 0; u + 1 < T; ++u) {
      const int t = REVERSE ? T - 1 - u : u;
      for (int i = 0; i < slabs; ++i, ++item) {
        const int s = ring_stage(full0, empty0, WK_STAGES, item, (1 + nvb) * BOX);
        const uint32_t full = full0 + 8 * s, st = base + s * WK_STAGE_BYTES;
        const int row = t * c + 64 * i;
        tma_load_4d(st, tm_a, full, d0, h, row, b);
        for (int x = 0; x < nvb; ++x)
          tma_load_4d(st + (2 + x) * BOX, tm_b, full, e0 + 64 * x, h, row, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int cc = tid % 8;              // the 16-byte chunk of a row this thread scales
  const float* ib = a.ig + (size_t)b * a.S * a.H + h;
  const float* fb = a.fg + (size_t)b * a.S * a.H + h;

  float acc[TC_N / 2];
#pragma unroll
  for (int i = 0; i < TC_N / 2; ++i) acc[i] = 0.f;
  float n_part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m_prev = 0.f;

  // n (or dn) of the block's 64 dqk rows: written to dst where given; returns
  // the block's sum of it times dot_with (where given), in every thread
  auto reduce_n = [&](float* dst, const float* dot_with) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s_nsum[(tid / 8) * 64 + cc * 8 + e] = n_part[e];
    wg_sync();
    float part = 0.f;
    if (tid < 64 && d0 + tid < dqk) {
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += s_nsum[r * 64 + tid];
      if (dst) dst[d0 + tid] = sum;
      if (dot_with) part = sum * dot_with[d0 + tid];
    }
    return wg_sum(part, s_scal + 4);
  };

  int item = 0;
  Pipe pipe{empty0};
  for (int u = 0; u < T; ++u) {
    const int t = REVERSE ? T - 1 - u : u;
    const int s0 = t * c;
    // the chunk's row scales and decay
    if constexpr (!REVERSE) {
      if (warp == 0) {
        const float btot = chunk_gates(ib, fb, a.H, a.H, s0, c, s_b, s_i, lane);
        const float m_state = next_m(s_b, s_i, c, btot, m_prev, lane);
        float z[8];
        chunk_stabilisers(s_b, s_i, c, m_prev, lane, z);
        const bool writes = blockIdx.x == 0 && blockIdx.y == 0;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int r = 8 * lane + v;
          const float dk = r < c ? expf(btot - s_b[r] + s_i[r] - m_state) : 0.f;
          s_sa[r] = dk;
          if (writes && r < c) {
            const size_t p = a.pos(bh, s0 + r);
            const float mj = s_b[r] + z[v];
            a.gb[p] = s_b[r];
            a.gi[p] = s_i[r];
            a.gm[p] = mj;
            a.gdq[p] = expf(s_b[r] + m_prev - mj);
            a.gdk[p] = dk;
          }
        }
        if (lane == 0) {
          const float decay = expf(btot + m_prev - m_state);
          s_scal[0] = decay;
          s_scal[1] = m_state;
          if (writes) a.gdecay[(size_t)bh * T + t] = decay;
        }
      }
    } else {
      for (int r = tid; r < MAX_C; r += WG) {
        float sa = 0.f, sn = 0.f;
        if (r < c) {
          const size_t p = a.pos(bh, s0 + r);
          const float g = a.gdq[p];
          sa = g / a.N[p];
          sn = g * a.dd[p];
        }
        s_sa[r] = sa;
        s_sn[r] = sn;
      }
      if (tid == 0) s_scal[0] = a.gdecay[(size_t)bh * T + t];
    }
    wg_sync();
    const float decay = s_scal[0];

    // the state at this point of the walk
    if constexpr (!REVERSE) {
      if (t > 0) {
        const size_t slot = (size_t)bh * (T - 1) + t - 1;
        store_tile(a.cs + slot * dqk * dv, lo_off, acc, d0, e0, dqk, dv, r0, cq);
        if (keeps_n) reduce_n(a.ns + slot * dqk, nullptr);
      }
    } else {
      const size_t slot_c = (size_t)bh * (T - 1) + t - 1, slot_g = (size_t)bh * (T - 1) + t;
      float part = 0.f;
      if (t > 0 && t < T - 1)
        part = tile_dot(a.cs + slot_c * dqk * dv, lo_off, acc, d0, e0, dqk, dv, r0, cq);
      part = wg_sum(part, s_scal + 4);
      if (tid == 0)
        a.cdot[(((size_t)blockIdx.y * a.EH + blockIdx.x) * BH + bh) * T + t] = part;
      if (t < T - 1) store_tile(a.gs + slot_g * dqk * dv, lo_off, acc, d0, e0, dqk, dv, r0, cq);
      if (keeps_n) {
        const float np = reduce_n(t < T - 1 ? a.gns + slot_g * dqk : nullptr,
                                  t > 0 && t < T - 1 ? a.ns + slot_c * dqk : nullptr);
        if (tid == 0) a.ndot[((size_t)blockIdx.y * BH + bh) * T + t] = np;
      }
    }
    if (u == T - 1) break;             // no product after the walk's last chunk

#pragma unroll
    for (int i = 0; i < TC_N / 2; ++i) acc[i] *= decay;
#pragma unroll
    for (int e = 0; e < 8; ++e) n_part[e] *= decay;
    for (int i = 0; i < slabs; ++i, ++item) {
      const int s = item % WK_STAGES;
      mbar_wait(full0 + 8 * s, (item / WK_STAGES) & 1);
      unsigned char* ast = gbase + s * WK_STAGE_BYTES;
      for (int rr = tid / 8; rr < 64; rr += WG / 8) {
        const float sa = s_sa[64 * i + rr];
        const float sn = REVERSE ? s_sn[64 * i + rr] : sa;
        const int off = rr * 128 + ((cc ^ (rr & 7)) * 16);
        float x[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(ast + off), x);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float p0 = x[e] * sa, p1 = x[e + 1] * sa;
          n_part[e] = fmaf(x[e], sn, n_part[e]);
          n_part[e + 1] = fmaf(x[e + 1], sn, n_part[e + 1]);
          const __nv_bfloat162 hv = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hv);
          const __nv_bfloat162 lv = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
          hi[e / 2] = *reinterpret_cast<const uint32_t*>(&hv);
          lo[e / 2] = *reinterpret_cast<const uint32_t*>(&lv);
        }
        *reinterpret_cast<uint4*>(ast + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(ast + BOX + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync();

      const uint32_t st = base + s * WK_STAGE_BYTES;
      fence_regs<TC_N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t db = smem_desc(st + 2 * BOX + j * 16 * 128, BOX / 16, 64);
        wgmma_ss_n256<1, 1>(acc, smem_desc(st + j * 16 * 128, BOX / 16, 64), db, 1);
        wgmma_ss_n256<1, 1>(acc, smem_desc(st + BOX + j * 16 * 128, BOX / 16, 64), db, 1);
      }
      wgmma_commit();
      pipe.committed(s);               // the next slab is scaled while this one runs
      fence_regs<TC_N / 2>(acc);
    }
    pipe.drain();
    fence_regs<TC_N / 2>(acc);
    if constexpr (!REVERSE) m_prev = s_scal[1];
  }
}

// Grid (ceil(dv / 256), ceil(dqk / 64), B * H). Also the gate terms: each
// block's warp 0 recomputes them per chunk (cumsum, m_j by a prefix max,
// dec_q, dec_k, decay, in the forward's operations), block (0, 0) writes them.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_bwd_tc_state_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ Tc a) {
  walk<false>(&tm_k, &tm_v, a);
}

// Grid as the state pass; reads N and dden from the rows pass.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_bwd_tc_dstate_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_dh, const __grid_constant__ Tc a) {
  walk<true>(&tm_q, &tm_dh, a);
}

// --- the rows pass -----------------------------------------------------------

constexpr int RW_STAGES = 4;
constexpr int RW_STAGE_BYTES = 2 * BOX;  // 2 boxes of K, or a box of dh and one of V

struct RowsLayout {
  static constexpr int S_OFF = TC_MAX_DQK / 64 * BOX;           // after the Q tile
  static constexpr int RING_OFF = S_OFF + 4 * 32 * WG * 4;      // S of 4 key tiles, float
  static constexpr int F_OFF = RING_OFF + RW_STAGES * RW_STAGE_BYTES;
  static constexpr int FLOATS = 2 * MAX_C + TC_MAX_DQK + 8 * 64;   // b, i; n_t; row terms, column sums
  static constexpr int BAR_OFF = F_OFF + 4 * FLOATS;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * RW_STAGES) + 1024;
};

// Grid (R, T, B * H): 64 query rows j0.. of chunk t. Q (64 x dqk) arrives once;
// K (2 boxes an item) and then dh, V pairs stream through a 4-stage ring.
//   1. dh_j . h_j and q_j . n_t on CUDA cores;
//   2. sweep 1, per key tile kt <= r: S = Q K^T (wgmma m64n64 over dqk), kept
//      in shared memory in fragment order, and sum_l s^2 D of each row;
//   3. N_j = max(|den_j|, e^{-m_j}) and dden_j (0 where the floor wins), to
//      scratch for the later passes;
//   4. sweep 2, per key tile: dP = dh V^T (wgmma over dv), then dS = D (dP /
//      N + 2 s dden) and W' = s D / N written as bf16 hi + lo [j][l] tiles
//      (0 above the diagonal and past c), and dlogD = D s (dP / N + s dden):
//      its row sums and the tile's column sums to scratch.
// The scores are formed once.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_bwd_tc_rows_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_dh, const __grid_constant__ Tc a) {
  using L = RowsLayout;
  unsigned char* gbase;
  const uint32_t base = smem_base(gbase);
  float* stash = reinterpret_cast<float*>(gbase + L::S_OFF);   // [4][32][WG]
  float* s_b = reinterpret_cast<float*>(gbase + L::F_OFF);     // [MAX_C]
  float* s_i = s_b + MAX_C;                                    // [MAX_C]
  float* s_n = s_i + MAX_C;                                    // [TC_MAX_DQK] n_t
  float* s_mj = s_n + TC_MAX_DQK;                              // [64] m_j
  float* s_dq = s_mj + 64;                                     // [64] dec_q
  float* s_qn = s_dq + 64;                                     // [64] q_j . n_t
  float* s_dhh = s_qn + 64;                                    // [64] dh_j . h_j
  float* s_col = s_dhh + 64;                                   // [4][64] column sums
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * RW_STAGES;

  const int r = blockIdx.x, t = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, c = a.c, T = a.T, dqk = a.dqk, dv = a.dv_;
  const int BH = a.B * a.H, j0 = 64 * r, s0 = t * c;
  const int na = (dqk + 63) / 64, ne = (dv + 63) / 64, nk_items = (na + 1) / 2;
  const int n_kt = r + 1;                                      // key tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    init_ring(full0, empty0, RW_STAGES);
  }
  __syncthreads();

  if (threadIdx.x >= WG) {
    if (threadIdx.x != WG) return;
    mbar_expect_tx(q_full, na * BOX);
    for (int x = 0; x < na; ++x) tma_load_4d(base + x * BOX, &tm_q, q_full, 64 * x, h, s0 + j0, b);
    int item = 0;
    for (int kt = 0; kt < n_kt; ++kt)
      for (int u = 0; u < nk_items; ++u, ++item) {
        const int nb = min(2, na - 2 * u);
        const int s = ring_stage(full0, empty0, RW_STAGES, item, nb * BOX);
        const uint32_t st = base + L::RING_OFF + s * RW_STAGE_BYTES;
        for (int x = 0; x < nb; ++x)
          tma_load_4d(st + x * BOX, &tm_k, full0 + 8 * s, 64 * (2 * u + x), h, s0 + 64 * kt, b);
      }
    for (int kt = 0; kt < n_kt; ++kt)
      for (int e = 0; e < ne; ++e, ++item) {
        const int s = ring_stage(full0, empty0, RW_STAGES, item, 2 * BOX);
        const uint32_t st = base + L::RING_OFF + s * RW_STAGE_BYTES;
        tma_load_4d(st, &tm_dh, full0 + 8 * s, 64 * e, h, s0 + j0, b);
        tma_load_4d(st + BOX, &tm_v, full0 + 8 * s, 64 * e, h, s0 + 64 * kt, b);
      }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);

  // 1. the chunk's gate terms, n_t, dh . h
  for (int l = tid; l < c; l += WG) {
    const size_t p = a.pos(bh, s0 + l);
    s_b[l] = a.gb[p];
    s_i[l] = a.gi[p];
  }
  if (tid < 64) {
    const int j = j0 + tid;
    s_mj[tid] = j < c ? a.gm[a.pos(bh, s0 + j)] : 0.f;
    s_dq[tid] = j < c ? a.gdq[a.pos(bh, s0 + j)] : 0.f;
  }
  if (t > 0)
    for (int d = tid; d < na * 64; d += WG)
      s_n[d] = d < dqk ? a.ns[((size_t)bh * (T - 1) + t - 1) * dqk + d] : 0.f;
  {
    const int rr = tid / 2, hh = tid % 2, j = j0 + rr;      // two threads a row
    float x = 0.f;
    if (j < c) {
      const size_t rw = a.row(bh, s0 + j) * dv;
      const uint4* dp = reinterpret_cast<const uint4*>(a.dh + rw);
      const uint4* hp = reinterpret_cast<const uint4*>(a.h + rw);
      for (int ch = hh; ch < dv / 8; ch += 2) {
        float xd[8], xh[8];
        bf16x8_to_float(dp[ch], xd);
        bf16x8_to_float(hp[ch], xh);
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(xd[e], xh[e], x);
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (hh == 0) s_dhh[rr] = x;
  }
  wg_sync();
  mbar_wait(q_full, 0);
  {
    const int rr = tid / 2, hh = tid % 2;
    float qn = 0.f;
    if (t > 0)
      for (int x = 0; x < na; ++x) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ch = 4 * hh + u;
          float xq[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(
                              gbase + x * BOX + rr * 128 + ((ch ^ (rr & 7)) * 16)), xq);
          const float* nn = s_n + x * 64 + ch * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) qn = fmaf(xq[e], nn[e], qn);
        }
      }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    if (hh == 0) s_qn[rr] = qn;
  }
  wg_sync();

  // D of the register i of key tile kt (0 outside l <= j < c)
  auto gate = [&](int kt, int i) {
    const int jl = r0 + 8 * ((i % 4) / 2), j = j0 + jl;
    const int l = 64 * kt + 8 * (i / 4) + cq + (i % 2);
    return (l <= j && j < c) ? expf(s_b[j] - s_b[l] + s_i[l] - s_mj[jl]) : 0.f;
  };

  // 2. sweep 1: S and the intra denominator
  float den[2] = {0.f, 0.f};
  int item = 0;
  Pipe pipe{empty0};
  for (int kt = 0; kt < n_kt; ++kt) {
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    for (int u = 0; u < nk_items; ++u, ++item) {
      const int s = item % RW_STAGES;
      mbar_wait(full0 + 8 * s, (item / RW_STAGES) & 1);
      const uint32_t ks = base + L::RING_OFF + s * RW_STAGE_BYTES;
      const int nkk = 4 * min(2, na - 2 * u);
      fence_regs<32>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nkk) break;
        const int g = 8 * u + kk;                           // k16 step over dqk
        wgmma_ss_n64(sc, smem_desc(base + (g / 4) * BOX + (g % 4) * 32, 1, 64),
                     smem_desc(ks + (kk / 4) * BOX + (kk % 4) * 32, 1, 64), 1);
      }
      wgmma_commit();
      pipe.committed(s);
      fence_regs<32>(sc);
    }
    pipe.drain();
    fence_regs<32>(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      den[(i % 4) / 2] = fmaf(sc[i] * sc[i], gate(kt, i), den[(i % 4) / 2]);
      stash[(kt * 32 + i) * WG + tid] = sc[i];
    }
  }

  // 3. N and dden of rows r0, r0 + 8 (each of the row's four lanes)
  float Nr[2], ddr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = den[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int jl = r0 + 8 * half, j = j0 + jl;
    float N = 1.f, dd = 0.f;
    if (j < c) {
      const float dn = x + s_qn[jl] * s_dq[jl];
      const float flo = expf(-s_mj[jl]);
      N = fmaxf(fabsf(dn), flo);
      const float dN = -s_dhh[jl] / N;
      dd = fabsf(dn) >= flo ? dN * (float)((dn > 0.f) - (dn < 0.f)) : 0.f;
      if (lane % 4 == 0) {
        const size_t p = a.pos(bh, s0 + j);
        a.N[p] = N;
        a.dd[p] = dd;
      }
    }
    Nr[half] = N;
    ddr[half] = dd;
  }

  // 4. sweep 2: dP, then dS, W' and dlogD's sums
  float rows[2] = {0.f, 0.f};
  const size_t mat = (size_t)a.cp * a.cp, lo_off = (size_t)BH * T * mat;
  __nv_bfloat16* ds_m = a.ds + ((size_t)bh * T + t) * mat;
  __nv_bfloat16* w_m = a.w + ((size_t)bh * T + t) * mat;
  for (int kt = 0; kt < n_kt; ++kt) {
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    for (int e = 0; e < ne; ++e, ++item) {
      const int s = item % RW_STAGES;
      mbar_wait(full0 + 8 * s, (item / RW_STAGES) & 1);
      const uint32_t st = base + L::RING_OFF + s * RW_STAGE_BYTES;
      fence_regs<32>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(dp, smem_desc(st + kk * 32, 1, 64), smem_desc(st + BOX + kk * 32, 1, 64), 1);
      wgmma_commit();
      pipe.committed(s);
      fence_regs<32>(dp);
    }
    pipe.drain();
    fence_regs<32>(dp);
    float cols[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) cols[m] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i % 4) / 2, jl = r0 + 8 * half;
      float ds[2], w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D = gate(kt, i + e);
        const float s = stash[(kt * 32 + i + e) * WG + tid];
        const float dpn = dp[i + e] / Nr[half];
        ds[e] = D * (dpn + 2.f * s * ddr[half]);
        w[e] = s * D / Nr[half];
        const float dl = D * s * (dpn + s * ddr[half]);
        rows[half] += dl;
        cols[2 * (i / 4) + e] += dl;
      }
      const size_t at = (size_t)(j0 + jl) * a.cp + 64 * kt + 8 * (i / 4) + cq;
      __nv_bfloat162 hi, lo;
      split_pair(ds[0], ds[1], hi, lo);
      *reinterpret_cast<__nv_bfloat162*>(ds_m + at) = hi;
      *reinterpret_cast<__nv_bfloat162*>(ds_m + lo_off + at) = lo;
      split_pair(w[0], w[1], hi, lo);
      *reinterpret_cast<__nv_bfloat162*>(w_m + at) = hi;
      *reinterpret_cast<__nv_bfloat162*>(w_m + lo_off + at) = lo;
    }
    // column sums: the warp's 16 rows (lanes of equal lane % 4), then the 4 warps in order
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      float x = cols[m];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) s_col[warp * 64 + 8 * (m / 2) + cq + (m % 2)] = x;
    }
    wg_sync();
    if (tid < 64 && 64 * kt + tid < c)
      a.colpart[((size_t)r * BH + bh) * a.S + s0 + 64 * kt + tid] =
          (s_col[tid] + s_col[64 + tid]) + (s_col[128 + tid] + s_col[192 + tid]);
    wg_sync();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = rows[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int j = j0 + r0 + 8 * half;
    if (lane % 4 == 0 && j < c) a.rowsum[a.pos(bh, s0 + j)] = x;
  }
}

// --- the grads pass ----------------------------------------------------------

constexpr int GR_STAGES = 4;
constexpr int GR_STAGE_BYTES = 5 * BOX;  // an A box and the 4 boxes of a 256-column B

struct GradsLayout {
  static constexpr int F_OFF = GR_STAGES * GR_STAGE_BYTES;
  static constexpr int FLOATS = TC_N + 3 * 64;   // n_t or dn_t of the tile's columns; row terms
  static constexpr int BAR_OFF = F_OFF + 4 * FLOATS;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * GR_STAGES + 1024;
};

// Grid (2 DH + EH, R, B * H * T): block x < DH owns 64 query rows and 256 dqk
// columns of dq, x < 2 DH 64 key rows and 256 columns of dk, else 64 key rows
// and 256 columns of dv, of chunk t = z % T. One m64n256 float32 accumulator;
// every item of the ring is an A box and up to 4 B boxes, each K step twice:
// against C_t or G_t hi and lo (the same A box), and dS or W' hi and lo
// against the same B boxes. First the chunk's inter term (wgmma over dv or
// dqk), then a row-wise epilogue, then the intra term (wgmma over the keys or
// queries of the chunk):
//   dq: X = dh C_t^T (C_t K-major); inter = X / N + dden n_t, whose row dot
//       with q goes to qpart; X = dec_q inter; X += dS K (K MN-major);
//   dk: X = v G_t^T; r = X + dn_t, whose row dot with k goes to kpart; X =
//       dec_k r; X += dS^T Q (dS MN-major: its columns are the keys);
//   dv: X = k G_t (G_t MN-major); X = dec_k X; X += W'^T dh.
// Chunk 0 has no inter term for dq (C_0 = 0), chunk T - 1 none for dk and dv
// (G_{T-1} = 0).
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_bwd_tc_grads_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_dh,
                          const __grid_constant__ CUtensorMap tm_c,
                          const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_ds,
                          const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ Tc a) {
  using L = GradsLayout;
  unsigned char* gbase;
  const uint32_t base = smem_base(gbase);
  float* s_vec = reinterpret_cast<float*>(gbase + L::F_OFF);   // [256]
  float* s_inv = s_vec + TC_N;                                 // [64] 1 / N
  float* s_dd = s_inv + 64;                                    // [64] dden
  float* s_g = s_dd + 64;                                      // [64] dec_q or dec_k
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * GR_STAGES;

  const int x = blockIdx.x, r = blockIdx.y;
  const int T = a.T, t = blockIdx.z % T, bh = blockIdx.z / T;
  const int b = bh / a.H, h = bh % a.H, c = a.c, dqk = a.dqk, dv = a.dv_;
  const int BH = a.B * a.H, s0 = t * c, row0 = 64 * r;
  const int role = x < a.DH ? 0 : x < 2 * a.DH ? 1 : 2;       // dq, dk, dv
  const int xt = role == 0 ? x : role == 1 ? x - a.DH : x - 2 * a.DH;
  const int col0 = TC_N * xt, width = role == 2 ? dv : dqk;
  const int nb = min(4, (width - col0 + 63) / 64);             // B boxes inside the width
  const bool inter = role == 0 ? t > 0 : t < T - 1;
  const int slot_c = bh * (T - 1) + t - 1, slot_g = bh * (T - 1) + t, slot_m = bh * T + t;
  const int n_inter = !inter ? 0 : role == 2 ? (dqk + 63) / 64 : (dv + 63) / 64;
  const int n_intra = role == 0 ? r + 1 : a.R - r;

  if (threadIdx.x == 0) init_ring(full0, empty0, GR_STAGES);
  __syncthreads();

  if (threadIdx.x >= WG) {
    if (threadIdx.x != WG) return;
    const int lo_c = BH * (T - 1), lo_m = BH * T;              // slot offsets of the lo parts
    for (int u = 0; u < 2 * (n_inter + n_intra); ++u) {
      const int v = u / 2, lo = u % 2;
      const int s = ring_stage(full0, empty0, GR_STAGES, u, (1 + nb) * BOX);
      const uint32_t full = full0 + 8 * s, sa = base + s * GR_STAGE_BYTES, sb = sa + BOX;
      if (v < n_inter) {
        const CUtensorMap* ta = role == 0 ? &tm_dh : role == 1 ? &tm_v : &tm_k;
        tma_load_4d(sa, ta, full, 64 * v, h, s0 + row0, b);
        for (int y = 0; y < nb; ++y) {
          if (role == 0)
            tma_load_4d(sb + y * BOX, &tm_c, full, 64 * v, 0, col0 + 64 * y, slot_c + lo * lo_c);
          else if (role == 1)
            tma_load_4d(sb + y * BOX, &tm_g, full, 64 * v, 0, col0 + 64 * y, slot_g + lo * lo_c);
          else
            tma_load_4d(sb + y * BOX, &tm_g, full, col0 + 64 * y, 0, 64 * v, slot_g + lo * lo_c);
        }
      } else {
        const int tile = role == 0 ? v - n_inter : r + v - n_inter;   // key (dq) or query tile
        if (role == 0) tma_load_4d(sa, &tm_ds, full, 64 * tile, 0, row0, slot_m + lo * lo_m);
        else tma_load_4d(sa, role == 1 ? &tm_ds : &tm_w, full, row0, 0, 64 * tile, slot_m + lo * lo_m);
        const CUtensorMap* tb = role == 0 ? &tm_k : role == 1 ? &tm_q : &tm_dh;
        for (int y = 0; y < nb; ++y)
          tma_load_4d(sb + y * BOX, tb, full, col0 + 64 * y, h, s0 + 64 * tile, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  if (tid < 64) {
    const int j = row0 + tid;
    float inv = 0.f, dd = 0.f, g = 0.f;
    if (j < c) {
      const size_t p = a.pos(bh, s0 + j);
      if (role == 0) {
        inv = 1.f / a.N[p];
        dd = a.dd[p];
        g = a.gdq[p];
      } else {
        g = a.gdk[p];
      }
    }
    s_inv[tid] = inv;
    s_dd[tid] = dd;
    s_g[tid] = g;
  }
  for (int d = tid; d < TC_N; d += WG) {
    const int col = col0 + d;
    float y = 0.f;
    if (col < dqk && inter && role == 0) y = a.ns[(size_t)slot_c * dqk + col];
    if (col < dqk && inter && role == 1) y = a.gns[(size_t)slot_g * dqk + col];
    s_vec[d] = y;
  }
  wg_sync();

  float acc[TC_N / 2];
#pragma unroll
  for (int i = 0; i < TC_N / 2; ++i) acc[i] = 0.f;
  int item = 0;
  Pipe pipe{empty0};
  for (int u = 0; u < 2 * n_inter; ++u, ++item) {
    const int s = item % GR_STAGES;
    mbar_wait(full0 + 8 * s, (item / GR_STAGES) & 1);
    const uint32_t sa = base + s * GR_STAGE_BYTES, sb = sa + BOX;
    fence_regs<TC_N / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (role == 2)
        wgmma_ss_n256<0, 1>(acc, smem_desc(sa + kk * 32, 1, 64),
                            smem_desc(sb + kk * 16 * 128, BOX / 16, 64), 1);
      else
        wgmma_ss_n256<0, 0>(acc, smem_desc(sa + kk * 32, 1, 64), smem_desc(sb + kk * 32, 1, 64), 1);
    }
    wgmma_commit();
    pipe.committed(s);
    fence_regs<TC_N / 2>(acc);
  }
  pipe.drain();
  fence_regs<TC_N / 2>(acc);

  // the row-wise epilogue of the inter term
  const __nv_bfloat16* rows_in = role == 0 ? a.q : a.k;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jl = r0 + 8 * half, j = row0 + jl;
    const float g = s_g[jl];
    if (role == 2) {
#pragma unroll
      for (int i = 0; i < TC_N / 8; ++i) {
        acc[4 * i + 2 * half] *= g;
        acc[4 * i + 2 * half + 1] *= g;
      }
      continue;
    }
    const float inv = s_inv[jl], dd = s_dd[jl];
    const __nv_bfloat16* qrow = rows_in + (j < c ? a.row(bh, s0 + j) * dqk : 0);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < TC_N / 8; ++i) {
      const int cl = 8 * i + cq, col = col0 + cl;
      float y0, y1;
      if (role == 0) {
        y0 = fmaf(acc[4 * i + 2 * half], inv, dd * s_vec[cl]);
        y1 = fmaf(acc[4 * i + 2 * half + 1], inv, dd * s_vec[cl + 1]);
      } else {
        y0 = acc[4 * i + 2 * half] + s_vec[cl];
        y1 = acc[4 * i + 2 * half + 1] + s_vec[cl + 1];
      }
      if (j < c && col < dqk) {
        const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + col));
        part = fmaf(qv.x, y0, part);
        part = fmaf(qv.y, y1, part);
      }
      acc[4 * i + 2 * half] = g * y0;
      acc[4 * i + 2 * half + 1] = g * y1;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (lane % 4 == 0 && j < c)
      (role == 0 ? a.qpart : a.kpart)[((size_t)xt * BH + bh) * a.S + s0 + j] = part;
  }

  for (int u = 0; u < 2 * n_intra; ++u, ++item) {
    const int s = item % GR_STAGES;
    mbar_wait(full0 + 8 * s, (item / GR_STAGES) & 1);
    const uint32_t sa = base + s * GR_STAGE_BYTES, sb = sa + BOX;
    fence_regs<TC_N / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint64_t db = smem_desc(sb + jj * 16 * 128, BOX / 16, 64);
      if (role == 0)
        wgmma_ss_n256<0, 1>(acc, smem_desc(sa + jj * 32, 1, 64), db, 1);
      else
        wgmma_ss_n256<1, 1>(acc, smem_desc(sa + jj * 16 * 128, BOX / 16, 64), db, 1);
    }
    wgmma_commit();
    pipe.committed(s);
    fence_regs<TC_N / 2>(acc);
  }
  pipe.drain();
  fence_regs<TC_N / 2>(acc);

  __nv_bfloat16* out = role == 0 ? a.dq : role == 1 ? a.dk : a.dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = row0 + r0 + 8 * half;
    if (j >= c) continue;
    __nv_bfloat16* orow = out + a.row(bh, s0 + j) * width;
#pragma unroll
    for (int i = 0; i < TC_N / 8; ++i) {
      const int col = col0 + 8 * i + cq;
      if (col < width)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
}

// --- the gate gradients ------------------------------------------------------

// Grid (T, B * H), a thread a position of the chunk: db from the rows pass's
// row and column sums and the grads pass's row dots; the chunk's last
// position adds sum dg and decay (<C_t, G_t> + n_t . dn_t); df is the
// suffix sum of db over the chunk (a warp scan, then the warps in order).
__global__ void __launch_bounds__(MAX_C) mlstm_bwd_tc_gate_grads_kernel(const __grid_constant__ Tc a) {
  __shared__ float red[MAX_C / 32], red2[MAX_C / 32];
  __shared__ float s_tail;
  const int t = blockIdx.x, bh = blockIdx.y, p = threadIdx.x, lane = p % 32, warp = p / 32;
  const int c = a.c, T = a.T, BH = a.B * a.H, S = a.S;
  const int s = t * c + p;
  float db = 0.f, dg = 0.f;
  if (p < c) {
    const size_t q = a.pos(bh, s);
    float col = 0.f;
    for (int rr = p / 64; rr < a.R; ++rr) col += a.colpart[((size_t)rr * BH + bh) * S + s];
    float qs = 0.f, ks = 0.f;
    for (int x = 0; x < a.DH; ++x) {
      qs += a.qpart[((size_t)x * BH + bh) * S + s];
      ks += a.kpart[((size_t)x * BH + bh) * S + s];
    }
    dg = a.gdk[q] * ks;
    db = a.rowsum[q] - col - dg + a.gdq[q] * qs;
    a.di[a.row(bh, s)] = col + dg;
  }
  float x = dg;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const size_t st = (size_t)bh * T + t;
    float y = 0.f;
    for (int i = lane; i < a.DT * a.EH; i += 32) y += a.cdot[i * (size_t)BH * T + st];
    for (int i = lane; i < a.DT; i += 32) y += a.ndot[i * (size_t)BH * T + st];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
    if (lane == 0) {
      float dbtot = 0.f;
      for (int w = 0; w < MAX_C / 32; ++w) dbtot += red[w];
      s_tail = dbtot + a.gdecay[st] * y;
    }
  }
  __syncthreads();
  if (p == c - 1) db += s_tail;
  // suffix sum within the warp, then the later warps' totals
  float v = p < c ? db : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += y;
  }
  if (lane == 0) red2[warp] = v;
  __syncthreads();
  float later = 0.f;
  for (int w = MAX_C / 32 - 1; w > warp; --w) later += red2[w];
  if (p < c) a.df[a.row(bh, s)] = v + later;
}

size_t align32(size_t n) { return (n + 31) & ~(size_t)31; }

// The tensor-core path's scratch in floats (ops.workspace_floats), carved in
// this order by launch_tc, each part 128-byte aligned.
size_t tc_workspace_floats(int B, int S, int H, int dqk, int dv, int c) {
  const size_t BH = (size_t)B * H, T = S / c, R = ceil_div(c, 64), cp = 64 * R;
  const size_t DH = ceil_div(dqk, TC_N), EH = ceil_div(dv, TC_N), DT = ceil_div(dqk, 64);
  return 8 * align32(BH * S) + align32(BH * T) + align32(R * BH * S) + 2 * align32(DH * BH * S) +
         align32(DT * EH * BH * T) + align32(DT * BH * T) + 2 * align32(BH * (T - 1) * dqk) +
         2 * align32(BH * (T - 1) * dqk * dv) + 2 * align32(BH * T * cp * cp);
}

// the plan of a contiguous bf16 scratch [n, rows, cols] viewed as [n, rows, 1, cols]
void scratch_plan(int64_t* plan, int cols, int rows, int64_t n) {
  const int64_t v[PLAN] = {cols, 1, rows, n, 2ll * cols, 2ll * cols, 2ll * cols * rows,
                           TMA_BOX_COLS, 1, 64, 1};
  for (int i = 0; i < PLAN; ++i) plan[i] = v[i];
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* ig,
                      const float* fg, const void* h, const void* dh, void* dq, void* dk,
                      void* dv, float* di, float* df, float* ws, int B, int S, int H, int dqk,
                      int dv_, int c, const int64_t* plans, cudaStream_t stream) {
  Tc a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.dh = static_cast<const __nv_bfloat16*>(dh);
  a.ig = ig;
  a.fg = fg;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.di = di;
  a.df = df;
  a.B = B, a.S = S, a.H = H, a.dqk = dqk, a.dv_ = dv_, a.c = c, a.T = S / c;
  a.R = ceil_div(c, 64), a.DH = ceil_div(dqk, TC_N), a.EH = ceil_div(dv_, TC_N);
  a.DT = ceil_div(dqk, 64), a.cp = 64 * a.R;
  const size_t BH = (size_t)B * H, T = a.T;
  float* p = ws;
  auto take = [&](size_t n) { float* x = p; p += align32(n); return x; };
  a.gb = take(BH * S), a.gi = take(BH * S), a.gm = take(BH * S), a.gdq = take(BH * S);
  a.gdk = take(BH * S), a.N = take(BH * S), a.dd = take(BH * S), a.rowsum = take(BH * S);
  a.gdecay = take(BH * T), a.colpart = take(a.R * BH * S);
  a.qpart = take(a.DH * BH * S), a.kpart = take(a.DH * BH * S);
  a.cdot = take(a.DT * a.EH * BH * T), a.ndot = take(a.DT * BH * T);
  a.ns = take(BH * (T - 1) * dqk), a.gns = take(BH * (T - 1) * dqk);
  a.cs = reinterpret_cast<__nv_bfloat16*>(take(BH * (T - 1) * dqk * dv_));   // hi, lo
  a.gs = reinterpret_cast<__nv_bfloat16*>(take(BH * (T - 1) * dqk * dv_));
  a.ds = reinterpret_cast<__nv_bfloat16*>(take(BH * T * a.cp * a.cp));
  a.w = reinterpret_cast<__nv_bfloat16*>(take(BH * T * a.cp * a.cp));

  CUtensorMap tm_q, tm_k, tm_v, tm_dh, tm_c = {}, tm_g = {}, tm_ds, tm_w;
  cudaError_t err;
  if ((err = encode_map(&tm_q, q, plans, dqk, H, S, B, 64)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_k, k, plans + PLAN, dqk, H, S, B, 64)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_v, v, plans + 2 * PLAN, dv_, H, S, B, 64)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_dh, dh, plans + 3 * PLAN, dv_, H, S, B, 64)) != cudaSuccess) return err;
  int64_t plan[PLAN];
  if (T > 1) {
    const int n = (int)(2 * BH * (T - 1));
    scratch_plan(plan, dv_, dqk, n);
    if ((err = encode_map(&tm_c, a.cs, plan, dv_, 1, dqk, n, 64)) != cudaSuccess) return err;
    if ((err = encode_map(&tm_g, a.gs, plan, dv_, 1, dqk, n, 64)) != cudaSuccess) return err;
  }
  const int n = (int)(2 * BH * T);
  scratch_plan(plan, a.cp, a.cp, n);
  if ((err = encode_map(&tm_ds, a.ds, plan, a.cp, 1, a.cp, n, 64)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_w, a.w, plan, a.cp, 1, a.cp, n, 64)) != cudaSuccess) return err;

  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  static uint64_t configured = 0;                 // once per device
  if (!(configured >> device & 1)) {
    const void* fns[4] = {(const void*)mlstm_bwd_tc_state_kernel,
                          (const void*)mlstm_bwd_tc_dstate_kernel,
                          (const void*)mlstm_bwd_tc_rows_kernel,
                          (const void*)mlstm_bwd_tc_grads_kernel};
    const int bytes[4] = {WalkLayout::BYTES, WalkLayout::BYTES, RowsLayout::BYTES,
                          GradsLayout::BYTES};
    for (int i = 0; i < 4; ++i)
      if ((err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      bytes[i])) != cudaSuccess)
        return err;
    configured |= 1ull << device;
  }
  const dim3 walk_grid(a.EH, a.DT, B * H);
  mlstm_bwd_tc_state_kernel<<<walk_grid, TC_THREADS, WalkLayout::BYTES, stream>>>(tm_k, tm_v, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_tc_rows_kernel<<<dim3(a.R, a.T, B * H), TC_THREADS, RowsLayout::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_dh, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_tc_dstate_kernel<<<walk_grid, TC_THREADS, WalkLayout::BYTES, stream>>>(tm_q, tm_dh, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_tc_grads_kernel<<<dim3(2 * a.DH + a.EH, a.R, B * H * a.T), TC_THREADS,
                              GradsLayout::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_dh, tm_c, tm_g,
                                                            tm_ds, tm_w, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_tc_gate_grads_kernel<<<dim3(a.T, B * H), MAX_C, 0, stream>>>(a);
  return cudaGetLastError();
}

static_assert(WalkLayout::BYTES <= 232448 && RowsLayout::BYTES <= 232448 &&
                  GradsLayout::BYTES <= 232448,
              "each pass fits one block's shared memory");

}  // namespace

// The CUDA-core path. dtype 0: float32, 1: bfloat16 (q, k, v, h, dh, dq, dk,
// dv); float32 gates [B, S, H] and di, df; every tensor contiguous. ws: workspace_floats(...)
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

// The tensor-core path: bfloat16 q, k, v, h, dh, dq, dk, dv with 64 <= dqk <=
// 512, dv >= 64, both multiples of 8; float32 gates [B, S, H] and di, df;
// every tensor contiguous. plans: 4 * 11 int64, the tensor maps of q, k, v
// and dh (64-row boxes; see encode_map). ws: tc_workspace_floats(...) float32
// scratch (ws_floats must equal it). Returns a cudaError_t.
extern "C" int mlstm_chunk_bwd_bf16(const void* q, const void* k, const void* v,
                                    const float* ig, const float* fg, const void* h,
                                    const void* dh, void* dq, void* dk, void* dv, float* di,
                                    float* df, float* ws, int64_t ws_floats, int B, int S,
                                    int H, int dqk, int dv_, int c, const int64_t* plans,
                                    void* stream) {
  if (c <= 0 || c > MAX_C || S <= 0 || S % c != 0 || dqk < 64 || dqk > TC_MAX_DQK ||
      dqk % 8 != 0 || dv_ < 64 || dv_ % 8 != 0 || B * H <= 0 || B * H > 65535 ||
      (int64_t)B * H * (S / c) > 65535 ||
      (size_t)ws_floats != tc_workspace_floats(B, S, H, dqk, dv_, c))
    return (int)cudaErrorInvalidValue;
  return (int)launch_tc(q, k, v, ig, fg, h, dh, dq, dk, dv, di, df, ws, B, S, H, dqk, dv_, c,
                        plans, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
