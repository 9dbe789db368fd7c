// The sLSTM recurrence of one layer over a whole sequence, forward and
// backward, for Hopper (sm_90a): one launch a call, float32 FMAs on the CUDA
// cores.
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as an XLA
// lax.scan of _slstm_cell (src/repro/models/xlstm.py:306, the cell at :268),
// one device loop per layer. Same function: the gate inputs xz, xi, xf, xo
// float32 [B, S, H, dh], the block-diagonal recurrent weights rec float32
// [4, H, dh, dh] (gates z, i, f, o), the state (h, c, n [B, H, dh], m [B, H]).
// Per step and head: r_g = h_{t-1} rec[g]; z = tanh(xz + r_z), o =
// sigmoid(xo + r_o); the head's scalar gates i_log = mean(xi + r_i) and
// f_log = log_sigmoid(mean(xf + r_f)); m_t = max(f_log + m_{t-1}, i_log);
// c, n and h = o c / max(n, 1e-6) as ref.py writes them.
//
// Bound on H100. The work is tiny for the card (8 B S H dh^2 FLOPs of
// products: 0.51 ms at float32's 67 TFLOP/s at [4, 512, 4, 512]) and the
// bytes tinier (0.03 ms); what bounds it is the chain: step t needs every
// column of h_{t-1}, so S steps run one after another, and a step whose
// head spans several blocks costs at least the cross-block barriers it
// waits at (two a forward step, one a backward step: the chain bound that
// chip_smoke.py measures with slstm_barrier_kernel).
//
// Design (forward, slstm_scan_kernel). Grid H x P blocks of 256 threads,
// all resident at once (the host checks the occupancy and refuses a grid
// that is not: the blocks of a head wait on each other). Block (head, p)
// owns C columns e of its head for all four gates (ops.scan_plan: a whole
// head, P = 1, where its weights fit in shared memory; else C = 16 at
// xlstm-1.3b's dh 512, P = 32, 128 blocks), so it updates c, n and h of its
// columns itself. Its slice of rec (4 gates x dh rows x C columns, 128 KB
// at dh 512) is loaded into shared memory once and stays for the sequence.
// Each step:
//   * stage h_{t-1} of the head, every row b, from global memory (L2), 8
//     loads in flight a thread;
//   * the block's 4C products for every row (passes of up to 4 rows), each
//     split over K row slices of rec that are summed in a fixed order;
//   * z, o and the pre-activations of i and f of its columns; its partial
//     sums of the i and f pre-activations (a warp a row) to global scratch;
//   * barrier among the head's blocks; every block sums the P partials in
//     one fixed order (lane q of a row's warp takes partials q, q + 32, ...,
//     then a butterfly of shuffles: the same bits in every lane and block)
//     and updates m, ibar, fbar;
//   * c, n and h of its columns; h_t to the output (and, when training, c,
//     n, z, o and the head's i_log, f_raw, m for the backward);
//   * barrier, after which h_t is visible to the head's blocks.
// The barrier is a counter per head in global memory: each block adds one
// (after a fence) and waits until the count reaches the number of blocks
// times the barriers so far (ld.acquire); data crossing blocks is written
// and read at L2 (st.cg / ld.cg). The partial sums are double-buffered by
// the step's parity. A head of one block waits at __syncthreads only.
//
// Backward (slstm_scan_bwd_kernel). Replaces nothing on the TPU: the JAX
// package differentiates the lax.scan through XLA. The same grid and
// columns; the block keeps rows pC.. of rec's z and o gates (the recurrent
// gradient dh_{t-1}[d] = sum_g sum_e dpre_g[e] rec[g, d, e] needs rows, not
// columns) and the row sums of its i and f gates, whose dpre is one value a
// head. It walks t from S - 1 to 0 from the forward's saved values:
//   * dh_t of its columns = the output gradient + the recurrent term left by
//     step t + 1; dpre_z and dpre_o of its columns, written to dxz, dxo;
//     its partial sums of d ibar and d fbar (sums over the head's columns);
//   * one barrier among the head's blocks; the P partials summed in block
//     order; the scalar gates' gradients through both arms of the max and
//     the log_sigmoid (dxi, dxf = their value / dh in every column);
//   * dpre_z and dpre_o of every column of the head (read at L2) times the
//     block's rows of rec, plus the row sums times the scalars: the
//     recurrent term for step t - 1.
// drec = sum h_{t-1}^T dpre is one float32 torch.matmul in ops.py.
// No atomics on floats: every sum has one order, so a second call gives the
// same bits.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;     // threads a block, both kernels
constexpr int WARPS = THREADS / 32;
constexpr int BT = 4;            // batch rows a pass of a block's products
constexpr float FLOOR = 1e-6f;   // the normaliser's floor

__host__ __device__ inline int slices(int outputs) {
  return outputs < THREADS ? THREADS / outputs : 1;
}

// Shared floats of a forward block with C columns (ops.forward_smem_floats).
struct FwdSmem {
  int w, hs, part, r, zz, oo, pi, pf, cs, ns, sc, total;
  __host__ __device__ FwdSmem(int B, int dh, int C) {
    const int O = 4 * C;
    w = 0;                              // [dh][4C]: rec[g, head, d, col0 + c] at [d][g C + c]
    hs = w + 4 * dh * C;                // [B][dh]: h_{t-1} of the head
    part = hs + B * dh;                 // [K][BT][O]: the products' row-slice sums
    r = part + slices(O) * BT * O;      // [B][O]: the recurrent pre-activations
    zz = r + B * O;                     // [B][C] each: z, o, pre_i, pre_f, c, n
    oo = zz + B * C;
    pi = oo + B * C;
    pf = pi + B * C;
    cs = pf + B * C;
    ns = cs + B * C;
    sc = ns + B * C;                    // [B][4]: m, ibar, fbar
    total = sc + 4 * B;
  }
};

// Shared floats of a backward block with C rows (ops.backward_smem_floats).
struct BwdSmem {
  int w, rs, dp, part, dc, dn, dhr, ti, tf, sc, total;
  __host__ __device__ BwdSmem(int B, int dh, int C) {
    w = 0;                              // [2 dh][C]: rec[0 | 3, head, row0 + c, e]
    rs = w + 2 * dh * C;                // [2][C]: row sums of rec[1], rec[2]
    dp = rs + 2 * C;                    // [B][2 dh]: dpre_z, dpre_o of the head
    part = dp + B * 2 * dh;             // [K][BT][C]
    dc = part + slices(C) * BT * C;     // [B][C] each: the carried dc, dn, the
    dn = dc + B * C;                    // recurrent term, the columns' d ibar
    dhr = dn + B * C;                   // and d fbar terms
    ti = dhr + B * C;
    tf = ti + B * C;
    sc = tf + B * C;                    // [B][8]: dm, ibar, fbar, i_log, f_log + m_prev,
    total = sc + 8 * B;                 // f_raw, d pre_i, d pre_f
  }
};

__device__ __forceinline__ size_t at(int b, int t, int head, int e, int S, int H, int dh) {
  return ((static_cast<size_t>(b) * S + t) * H + head) * dh + e;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The sum of a warp's 32 values, in every lane: a butterfly, whose adds
// pair the same two values in each lane, so every lane holds the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy n floats (src(i), i < n) into shared dst with UNROLL loads in flight
// a thread: a step's staging waits for one round trip to L2, not n / 256.
constexpr int UNROLL = 8;
template <typename Src>
__device__ __forceinline__ void stage(float* dst, int n, Src src) {
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      v[u] = i < n ? src(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) dst[i] = v[u];
    }
  }
}

// A block's products for NB rows: out[j][o] = sum_d x[j][d] w[d][o] over
// d < len, each output split over K slices of d (slice k takes d = k, k + K,
// ...) whose sums go to part[k][j][o]; the caller sums the slices in order.
template <int NB>
__device__ __forceinline__ void products(const float* w, const float* x, float* part,
                                         int outputs, int K, int len, int x_stride) {
  for (int wi = threadIdx.x; wi < outputs * K; wi += THREADS) {
    const int o = wi % outputs, k = wi / outputs;
    float acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = 0.f;
    for (int d = k; d < len; d += K) {
      const float wv = w[d * outputs + o];
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j] = fmaf(x[j * x_stride + d], wv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) part[(k * BT + j) * outputs + o] = acc[j];
  }
}

// products<NB> for the nb = min(BT, rows left) rows of a pass.
__device__ __forceinline__ void products_rows(int nb, const float* w, const float* x, float* part,
                                              int outputs, int K, int len, int x_stride) {
  switch (nb) {
    case 1: products<1>(w, x, part, outputs, K, len, x_stride); break;
    case 2: products<2>(w, x, part, outputs, K, len, x_stride); break;
    case 3: products<3>(w, x, part, outputs, K, len, x_stride); break;
    default: products<BT>(w, x, part, outputs, K, len, x_stride);
  }
}

// Barrier among the P blocks of one head: the n-th call of a launch waits
// until the head's counter reaches n P. Every thread of the block calls it.
// A wait of 2^36 cycles (~35 s) traps: a grid that is not resident fails
// its launch instead of hanging the card.
__device__ __forceinline__ void head_barrier(unsigned* count, unsigned target, int P) {
  __syncthreads();
  if (P == 1) return;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long start = clock64();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (clock64() - start > (1ll << 36)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) slstm_scan_kernel(
    const float* __restrict__ xz, const float* __restrict__ xi, const float* __restrict__ xf,
    const float* __restrict__ xo, const float* __restrict__ rec, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ n0, const float* __restrict__ m0,
    float* hout, float* __restrict__ hN, float* __restrict__ cN, float* __restrict__ nN,
    float* __restrict__ mN, float* __restrict__ c_all, float* __restrict__ n_all,
    float* __restrict__ z_all, float* __restrict__ o_all, float* __restrict__ gates,
    unsigned* count, float* partials, int B, int S, int H, int dh, int C, int P) {
  extern __shared__ float smem[];
  const FwdSmem L(B, dh, C);
  float* w = smem + L.w;
  float* hs = smem + L.hs;
  float* part = smem + L.part;
  float* r = smem + L.r;
  float *zz = smem + L.zz, *oo = smem + L.oo, *pi = smem + L.pi, *pf = smem + L.pf;
  float *cs = smem + L.cs, *ns = smem + L.ns, *sc = smem + L.sc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.x / P, p = blockIdx.x % P;
  const int col0 = p * C, Cb = min(C, dh - col0), O = 4 * C, K = slices(O);

  for (int i = tid; i < 4 * dh * C; i += THREADS) {
    const int d = i / O, g = i % O / C, c = i % C;
    w[i] = c < Cb ? rec[((static_cast<size_t>(g) * H + head) * dh + d) * dh + col0 + c] : 0.f;
  }
  for (int i = tid; i < B * C; i += THREADS) {
    const int b = i / C, c = i % C;
    const size_t s = (static_cast<size_t>(b) * H + head) * dh + col0 + c;
    cs[i] = c < Cb ? c0[s] : 0.f;
    ns[i] = c < Cb ? n0[s] : 0.f;
  }
  if (tid < B) sc[tid * 4] = m0[tid * H + head];

  unsigned barriers = 0;
  const bool first = tid < B * C && tid % C < Cb;   // the thread's first column exists
  for (int t = 0; t < S; ++t) {
    // the gate inputs of the thread's first column, loaded with h_{t-1} so
    // that the two trips to memory overlap
    float gx[4] = {0.f, 0.f, 0.f, 0.f};
    if (first) {
      const size_t x = at(tid / C, t, head, col0 + tid % C, S, H, dh);
      gx[0] = xz[x];
      gx[1] = xi[x];
      gx[2] = xf[x];
      gx[3] = xo[x];
    }
    stage(hs, B * dh, [&](int i) {
      const int b = i / dh, d = i % dh;
      return t == 0 ? h0[(static_cast<size_t>(b) * H + head) * dh + d]
                    : __ldcg(hout + at(b, t - 1, head, d, S, H, dh));
    });
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += BT) {
      products_rows(min(BT, B - b0), w, hs + b0 * dh, part, O, K, dh, dh);
      __syncthreads();
      for (int wi = tid; wi < BT * O; wi += THREADS) {
        const int j = wi / O, o = wi % O;
        if (b0 + j < B) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s += part[(k * BT + j) * O + o];
          r[(b0 + j) * O + o] = s;
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < B * C; i += THREADS) {
      const int b = i / C, c = i % C;
      if (c >= Cb) continue;
      if (i != tid) {
        const size_t x = at(b, t, head, col0 + c, S, H, dh);
        gx[0] = xz[x];
        gx[1] = xi[x];
        gx[2] = xf[x];
        gx[3] = xo[x];
      }
      const float* rb = r + b * O;
      zz[i] = tanhf(gx[0] + rb[c]);
      pi[i] = gx[1] + rb[C + c];
      pf[i] = gx[2] + rb[2 * C + c];
      oo[i] = sigmoid(gx[3] + rb[3 * C + c]);
    }
    __syncthreads();
    const size_t par = t & 1;
    for (int b = warp; b < B; b += WARPS) {      // the block's sums, a warp a row
      float si = 0.f, sf = 0.f;
      for (int c = lane; c < Cb; c += 32) {
        si += pi[b * C + c];
        sf += pf[b * C + c];
      }
      si = warp_sum(si);
      sf = warp_sum(sf);
      if (lane == 0) {
        float* slot = partials + (((par * H + head) * P + p) * B + b) * 2;
        __stcg(slot, si);
        __stcg(slot + 1, sf);
      }
    }
    head_barrier(count + head, ++barriers * P, P);
    for (int b = warp; b < B; b += WARPS) {      // the head's: the P blocks' sums
      float si = 0.f, sf = 0.f;
      for (int q = lane; q < P; q += 32) {
        const float* slot = partials + (((par * H + head) * P + q) * B + b) * 2;
        si += __ldcg(slot);
        sf += __ldcg(slot + 1);
      }
      si = warp_sum(si);
      sf = warp_sum(sf);
      if (lane == 0) {
        const float il = si / dh, fr = sf / dh, fl = log_sigmoid(fr), m = sc[b * 4];
        const float mn = fmaxf(fl + m, il);
        sc[b * 4] = mn;
        sc[b * 4 + 1] = expf(il - mn);
        sc[b * 4 + 2] = expf(fl + m - mn);
        if (gates != nullptr && p == 0) {
          float* gv = gates + ((static_cast<size_t>(b) * S + t) * H + head) * 3;
          gv[0] = il;
          gv[1] = fr;
          gv[2] = mn;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < B * C; i += THREADS) {
      const int b = i / C, c = i % C;
      if (c >= Cb) continue;
      const float ib = sc[b * 4 + 1], fb = sc[b * 4 + 2];
      const float cn = fb * cs[i] + ib * zz[i];
      const float nn = fb * ns[i] + ib;
      const float hv = oo[i] * cn / fmaxf(nn, FLOOR);
      cs[i] = cn;
      ns[i] = nn;
      const size_t x = at(b, t, head, col0 + c, S, H, dh);
      __stcg(hout + x, hv);
      if (c_all != nullptr) {
        c_all[x] = cn;
        n_all[x] = nn;
        z_all[x] = zz[i];
        o_all[x] = oo[i];
      }
      if (t == S - 1) {
        const size_t s = (static_cast<size_t>(b) * H + head) * dh + col0 + c;
        hN[s] = hv;
        cN[s] = cn;
        nN[s] = nn;
      }
    }
    head_barrier(count + head, ++barriers * P, P);
  }
  if (p == 0 && tid < B) mN[tid * H + head] = sc[tid * 4];
}


__global__ void __launch_bounds__(THREADS) slstm_scan_bwd_kernel(
    const float* __restrict__ rec, const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, const float* __restrict__ c_all,
    const float* __restrict__ n_all, const float* __restrict__ z_all,
    const float* __restrict__ o_all, const float* __restrict__ gates,
    const float* __restrict__ dy, float* dxz, float* __restrict__ dxi, float* __restrict__ dxf,
    float* dxo, unsigned* count, float* partials, int B, int S, int H, int dh, int C, int P) {
  extern __shared__ float smem[];
  const BwdSmem L(B, dh, C);
  float *w = smem + L.w, *rs = smem + L.rs, *dp = smem + L.dp, *part = smem + L.part;
  float *dc = smem + L.dc, *dn = smem + L.dn, *dhr = smem + L.dhr;
  float *ti = smem + L.ti, *tf = smem + L.tf, *sc = smem + L.sc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.x / P, p = blockIdx.x % P;
  const int row0 = p * C, Cb = min(C, dh - row0), K = slices(C), D2 = 2 * dh;

  for (int i = tid; i < D2 * C; i += THREADS) {
    const int j = i / C, c = i % C, g = j < dh ? 0 : 3;
    w[i] = c < Cb ? rec[((static_cast<size_t>(g) * H + head) * dh + row0 + c) * dh + j % dh]
                  : 0.f;
  }
  for (int i = tid; i < 2 * C; i += THREADS) {
    const int c = i % C, g = i < C ? 1 : 2;
    float s = 0.f;
    if (c < Cb) {
      const float* row = rec + ((static_cast<size_t>(g) * H + head) * dh + row0 + c) * dh;
      for (int e = 0; e < dh; ++e) s += row[e];
    }
    rs[i] = s;
  }
  for (int i = tid; i < B * C; i += THREADS) dc[i] = dn[i] = dhr[i] = 0.f;
  if (tid < B) sc[tid * 8] = 0.f;

  unsigned barriers = 0;
  for (int t = S - 1; t >= 0; --t) {
    if (tid < B) {
      const float* gv = gates + ((static_cast<size_t>(tid) * S + t) * H + head) * 3;
      const float mp = t ? gates[((static_cast<size_t>(tid) * S + t - 1) * H + head) * 3 + 2]
                         : m0[tid * H + head];
      const float fl = log_sigmoid(gv[1]);
      float* s = sc + tid * 8;
      s[1] = expf(gv[0] - gv[2]);
      s[2] = expf(fl + mp - gv[2]);
      s[3] = gv[0];
      s[4] = fl + mp;
      s[5] = gv[1];
    }
    __syncthreads();
    for (int i = tid; i < B * C; i += THREADS) {
      const int b = i / C, c = i % C;
      if (c >= Cb) continue;
      const size_t x = at(b, t, head, row0 + c, S, H, dh);
      const size_t s0 = (static_cast<size_t>(b) * H + head) * dh + row0 + c;
      const size_t back = static_cast<size_t>(H) * dh;
      const float ib = sc[b * 8 + 1], fb = sc[b * 8 + 2];
      const float g = dy[x] + dhr[i];
      const float cv = c_all[x], nv = n_all[x], zv = z_all[x], ov = o_all[x];
      const float cp = t ? c_all[x - back] : c0[s0];
      const float np = t ? n_all[x - back] : n0[s0];
      const float nd = fmaxf(nv, FLOOR);
      const float dov = g * cv / nd;
      const float dct = dc[i] + g * ov / nd;
      const float share = nv > FLOOR ? 1.f : (nv == FLOOR ? 0.5f : 0.f);
      const float dnt = dn[i] + -g * ov * cv / (nd * nd) * share;
      ti[i] = dct * zv + dnt;
      tf[i] = dct * cp + dnt * np;
      dc[i] = dct * fb;
      dn[i] = dnt * fb;
      __stcg(dxz + x, dct * ib * (1.f - zv * zv));
      __stcg(dxo + x, dov * ov * (1.f - ov));
    }
    __syncthreads();
    const size_t par = t & 1;
    for (int b = warp; b < B; b += WARPS) {
      float si = 0.f, sf = 0.f;
      for (int c = lane; c < Cb; c += 32) {
        si += ti[b * C + c];
        sf += tf[b * C + c];
      }
      si = warp_sum(si);
      sf = warp_sum(sf);
      if (lane == 0) {
        float* slot = partials + (((par * H + head) * P + p) * B + b) * 2;
        __stcg(slot, si);
        __stcg(slot + 1, sf);
      }
    }
    head_barrier(count + head, ++barriers * P, P);
    for (int b = warp; b < B; b += WARPS) {
      float dib = 0.f, dfb = 0.f;
      for (int q = lane; q < P; q += 32) {
        const float* slot = partials + (((par * H + head) * P + q) * B + b) * 2;
        dib += __ldcg(slot);
        dfb += __ldcg(slot + 1);
      }
      dib = warp_sum(dib);
      dfb = warp_sum(dfb);
      if (lane == 0) {
        float* s = sc + b * 8;
        const float di = dib * s[1], df = dfb * s[2];
        const float dmn = s[0] - di - df;
        const float arm = s[4] > s[3] ? 1.f : (s[4] == s[3] ? 0.5f : 0.f);
        const float dil = di + dmn * (1.f - arm);
        const float dfl = df + dmn * arm;
        s[0] = df + dmn * arm;
        s[6] = dil / dh;
        s[7] = dfl * sigmoid(-s[5]) / dh;
      }
    }
    stage(dp, B * D2, [&](int i) {
      const int b = i / D2, j = i % D2;
      return __ldcg((j < dh ? dxz : dxo) + at(b, t, head, j % dh, S, H, dh));
    });
    __syncthreads();
    for (int i = tid; i < B * C; i += THREADS) {
      const int b = i / C, c = i % C;
      if (c >= Cb) continue;
      const size_t x = at(b, t, head, row0 + c, S, H, dh);
      dxi[x] = sc[b * 8 + 6];
      dxf[x] = sc[b * 8 + 7];
    }
    if (t == 0) break;
    for (int b0 = 0; b0 < B; b0 += BT) {
      products_rows(min(BT, B - b0), w, dp + b0 * D2, part, C, K, D2, D2);
      __syncthreads();
      for (int wi = tid; wi < BT * C; wi += THREADS) {
        const int j = wi / C, c = wi % C, b = b0 + j;
        if (b < B) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s += part[(k * BT + j) * C + c];
          dhr[b * C + c] = s + sc[b * 8 + 6] * rs[c] + sc[b * 8 + 7] * rs[C + c];
        }
      }
      __syncthreads();
    }
  }
}

// n barriers among the P blocks of each of H heads, with the forward's
// shared memory so that the blocks sit one an SM as the forward's do: one
// barrier's cost, the chain bound's unit.
__global__ void __launch_bounds__(THREADS) slstm_barrier_kernel(unsigned* count, int P, int n) {
  const int head = blockIdx.x / P;
  for (int i = 1; i <= n; ++i) head_barrier(count + head, static_cast<unsigned>(i) * P, P);
}

bool shape_ok(int B, int S, int H, int dh, int C, int P) {
  return B >= 1 && B <= THREADS && S >= 1 && H >= 1 && dh >= 1 && C >= 1 && C <= dh &&
         P == (dh + C - 1) / C && static_cast<int64_t>(H) * P <= (1 << 30) &&
         static_cast<int64_t>(B) * S * H * dh < (int64_t(1) << 40);
}

// Blocks of `kernel` an SM at `smem` bytes, after raising its shared memory
// limit to them.
cudaError_t resident(const void* kernel, size_t smem, int* per_sm, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem);
}

// Zero the heads' barrier counters and check that a grid of H P blocks is
// resident at once where the heads' blocks wait on each other (P > 1).
cudaError_t prepare(const void* kernel, size_t smem, int H, int P, unsigned* count,
                    cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = resident(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || (P > 1 && static_cast<int64_t>(per_sm) * sms < static_cast<int64_t>(H) * P))
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaMemsetAsync(count, 0, sizeof(unsigned) * H, stream);
}

}  // namespace

// Scratch (`ws`) of both entry points: H unsigned barrier counters, then the
// partial sums, float [2][H][P][B][2] (ops.workspace_words).

// The forward: xz, xi, xf, xo float32 [B, S, H, dh] and rec [4, H, dh, dh],
// all contiguous; the state h0, c0, n0 [B, H, dh] and m0 [B, H]; out: h
// [B, S, H, dh] and the final state hN, cN, nN, mN. c_all, n_all, z_all,
// o_all [B, S, H, dh] and gates [B, S, H, 3] are written when c_all is not
// null (training). C columns a block, P = ceil(dh / C) blocks a head
// (ops.scan_plan). Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge
// where the grid cannot be resident at once).
extern "C" int slstm_scan_fwd(const void* xz, const void* xi, const void* xf, const void* xo,
                              const void* rec, const void* h0, const void* c0, const void* n0,
                              const void* m0, void* h, void* hN, void* cN, void* nN, void* mN,
                              void* c_all, void* n_all, void* z_all, void* o_all, void* gates,
                              void* ws, int B, int S, int H, int dh, int C, int P,
                              void* stream) {
  if (!shape_ok(B, S, H, dh, C, P)) return (int)cudaErrorInvalidValue;
  if ((c_all == nullptr) != (gates == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * FwdSmem(B, dh, C).total;
  unsigned* count = static_cast<unsigned*>(ws);
  cudaError_t err = prepare(reinterpret_cast<const void*>(slstm_scan_kernel), smem, H, P,
                            count, st);
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  slstm_scan_kernel<<<H * P, THREADS, smem, st>>>(
      f(xz), f(xi), f(xf), f(xo), f(rec), f(h0), f(c0), f(n0), f(m0), o(h), o(hN), o(cN),
      o(nN), o(mN), o(c_all), o(n_all), o(z_all), o(o_all), o(gates), count,
      reinterpret_cast<float*>(count + H), B, S, H, dh, C, P);
  return (int)cudaGetLastError();
}

// The backward: rec, the initial c0, n0 [B, H, dh] and m0 [B, H], the
// forward's saved c, n, z, o [B, S, H, dh] and gates [B, S, H, 3], and dy,
// the gradient of h; out: dxz, dxi, dxf, dxo [B, S, H, dh]. The same plan
// and scratch as the forward. Returns a cudaError_t.
extern "C" int slstm_scan_bwd(const void* rec, const void* c0, const void* n0, const void* m0,
                              const void* c_all, const void* n_all, const void* z_all,
                              const void* o_all, const void* gates, const void* dy, void* dxz,
                              void* dxi, void* dxf, void* dxo, void* ws, int B, int S, int H,
                              int dh, int C, int P, void* stream) {
  if (!shape_ok(B, S, H, dh, C, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * BwdSmem(B, dh, C).total;
  unsigned* count = static_cast<unsigned*>(ws);
  cudaError_t err = prepare(reinterpret_cast<const void*>(slstm_scan_bwd_kernel), smem, H, P,
                            count, st);
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  slstm_scan_bwd_kernel<<<H * P, THREADS, smem, st>>>(
      f(rec), f(c0), f(n0), f(m0), f(c_all), f(n_all), f(z_all), f(o_all), f(gates), f(dy),
      o(dxz), o(dxi), o(dxf), o(dxo), count, reinterpret_cast<float*>(count + H), B, S, H, dh,
      C, P);
  return (int)cudaGetLastError();
}

// A block's shared bytes (forward: fwd = 1, backward: 0) at B rows, dh and
// C columns, and how many such blocks an SM holds and the card's SMs.
// Returns a cudaError_t.
extern "C" int slstm_scan_residency(int fwd, int B, int dh, int C, int* smem, int* per_sm,
                                    int* sms) {
  if (B < 1 || dh < 1 || C < 1 || C > dh) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (fwd ? FwdSmem(B, dh, C).total : BwdSmem(B, dh, C).total);
  *smem = static_cast<int>(bytes);
  const void* kernel = fwd ? reinterpret_cast<const void*>(slstm_scan_kernel)
                           : reinterpret_cast<const void*>(slstm_scan_bwd_kernel);
  return (int)resident(kernel, bytes, per_sm, sms);
}

// n head barriers on a grid of H P blocks with `smem` dynamic shared bytes
// each (the forward's, ops.forward_smem_floats), on `ws` (H counters).
extern "C" int slstm_barrier_probe(void* ws, int H, int P, int n, int smem, void* stream) {
  if (H < 1 || P < 1 || n < 1 || smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* count = static_cast<unsigned*>(ws);
  cudaError_t err = prepare(reinterpret_cast<const void*>(slstm_barrier_kernel),
                            static_cast<size_t>(smem), H, P, count, st);
  if (err != cudaSuccess) return (int)err;
  slstm_barrier_kernel<<<H * P, THREADS, smem, st>>>(count, P, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
