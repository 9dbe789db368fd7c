// The sLSTM recurrence of one layer over a whole sequence, forward and
// backward, for Hopper (sm_90a): one launch a call, float32 FMAs on the CUDA
// cores, one thread-block cluster a head and group of batch rows.
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
// Bound on H100. The work is tiny for the card (4 B S H dh^2 FLOPs of the z
// and o products: 0.26 ms at float32's 67 TFLOP/s at [4, 512, 4, 512]) and
// the bytes tinier; what bounds it is the chain: step t needs every column
// of h_{t-1}, so S steps run one after another, and a step whose head spans
// several blocks costs at least the one cluster barrier it waits at (the
// chain bound chip_smoke.py measures with slstm_barrier_kernel).
//
// The i and f gates factored. i_log = mean_e(xi_e + sum_d h_d rec[1, d, e])
// = sum_e xi_e / dh + sum_d h_d rho_i[d], rho_i = rec[1]'s row means over e
// (the same for f). So a step needs full products only for z and o, and the
// head's scalars are sums of per-block partials sum_{e in block} (xi_e / dh
// + h_e rho_i[e]). Reordered float32 sums only: at [1, 2048, 4, 512] with
// chip_smoke's inputs the factored recurrence is 3.15e-7 from float64, as
// the plain one is (tests/test_torch_slstm_cluster.py run as a script), far
// inside the checks' 1e-5.
//
// Design (forward, slstm_scan_kernel). A cluster of P blocks of 256 threads
// serves one head for a group of Bc batch rows; block rank p owns C = dh / P
// columns e (ops.scan_plan: P the smallest power of two up to 16 whose
// blocks fit in shared memory, 16 blocks of 32 columns at xlstm-1.3b's dh
// 512, a non-portable cluster; Bc up to 8 rows). The grid is H x ceil(B /
// Bc) clusters; clusters never wait on one another, so it need not be
// resident at once (the H100 runs 7 of these 16-block clusters at a time).
// The block keeps rec's z and o columns [dh, 2C] in shared memory (128 KB
// at dh 512), computes rho_i, rho_f of its rows once, and per step t:
//   * sums the P blocks' partials of its row in rank order (the same bits in
//     every block), then i_log, f_raw, m, ibar, fbar;
//   * its 2C products over h_{t-1} of the whole head, which sits in its own
//     shared memory (8 warps over slices of d, summed in slice order);
//   * z, o, c, n and h_t of its columns; stores h_t into every block of the
//     cluster (st.shared::cluster), double-buffered by the step's parity;
//   * its partials for step t + 1 (a butterfly within the row), stored the
//     same way; arrives at the cluster barrier, writes h_t (and, training,
//     c, n, z, o and the head's i_log, f_raw, m) to global memory, waits.
// One cluster barrier a step (the prologue adds two); nothing on the chain
// goes through global memory. The gate inputs arrive by 4-byte cp.async,
// RING - 1 steps ahead, each thread its own into its own slots. Storing
// h_t before the butterfly, not after, overlaps the stores with it; reading
// the peers' slices over distributed shared memory after the barrier
// instead, 16-byte stores of a quad's columns, batched loads of the partials
// and the next step's xi / dh computed ahead were each slower on the H100
// (PERF.md).
//
// Backward (slstm_scan_bwd_kernel). Replaces nothing on the TPU: the JAX
// package differentiates the lax.scan through XLA. The same plan; block p
// keeps rows pC.. of rec's z and o gates [2 dh, C] (the recurrent gradient
// dh_{t-1}[d] = sum_g sum_e dpre_g[e] rec[g, d, e] needs rows, not columns)
// and the row sums of its i and f gates, whose dpre is one value a head. It
// walks t from S - 1 to 0 from the forward's saved values:
//   * dh_t of its columns = the output gradient + the recurrent term left by
//     step t + 1; dpre_z and dpre_o of its columns; its partials of d ibar
//     and d fbar;
//   * stores dpre_z and dpre_o, then (after the row's butterfly) the
//     partials into every block of the cluster, arrives, writes dxz, dxo,
//     waits: one cluster barrier;
//   * the P partials summed in rank order; the scalar gates' gradients
//     through both arms of the max and the log_sigmoid (dxi, dxf = their
//     value / dh in every column);
//   * dpre_z and dpre_o of the head times the block's rows, plus the row
//     sums times the scalars: the recurrent term for step t - 1.
// drec = sum h_{t-1}^T dpre is one float32 torch.matmul in ops.py.
// No atomics on floats: every sum has one order, so a second call gives the
// same bits.
//
// The diagnostic build of phases.py (-DREPRO_SLSTM_PHASES) adds phase
// clocks; the served library has none of them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;     // threads a block, both kernels
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // blocks a cluster: Hopper's non-portable maximum
constexpr int MAX_ROWS = 8;      // batch rows a cluster
constexpr int RING = 4;          // steps of inputs a thread keeps in flight, plus one
constexpr float FLOOR = 1e-6f;   // the normaliser's floor

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared floats of a forward block (ops.forward_smem_floats): Bc rows, C
// columns, P blocks a cluster. Every region starts at a multiple of 16 bytes.
struct FwdSmem {
  int w, h, prod, part, rho, red, ring, total;
  __host__ __device__ FwdSmem(int Bc, int dh, int C, int P) {
    const int D4 = round4(dh), O = 2 * C;
    w = 0;                                 // [D4][2C]: rec[0 | 3, head, d, col0 + c]
    h = w + D4 * O;                        // [2][Bc][D4]: h_{t-1} of the head, by parity
    prod = h + 2 * Bc * D4;                // [WARPS][Bc][2C]: the products' slice sums
    part = prod + round4(WARPS * Bc * O);  // [2][P][Bc][2]: the blocks' i, f partials
    rho = part + round4(4 * P * Bc);       // [2][C]: rho_i, rho_f of the block's rows
    red = rho + round4(2 * C);             // [2][Bc C]: a row's terms where C is not a
    ring = red + round4(2 * Bc * C);       //   power of two up to 32
    total = ring + RING * 4 * THREADS;     // [RING][4][THREADS]: xz, xi, xf, xo a step
  }
};

// Shared floats of a backward block (ops.backward_smem_floats).
struct BwdSmem {
  int w, rs, dp, prod, part, red, ring, total;
  __host__ __device__ BwdSmem(int Bc, int dh, int C, int P) {
    const int D4 = round4(dh);
    w = 0;                                 // [2 D4][C]: rec[0 | 3, head, row0 + c, e]
    rs = w + 2 * D4 * C;                   // [2][C]: row sums of rec[1], rec[2]
    dp = rs + round4(2 * C);               // [2][Bc][2 D4]: dpre_z, dpre_o, by parity
    prod = dp + 4 * Bc * D4;               // [WARPS][Bc][C]
    part = prod + round4(WARPS * Bc * C);  // [2][P][Bc][2]: d ibar, d fbar partials
    red = part + round4(4 * P * Bc);       // [2][Bc C]
    ring = red + round4(2 * Bc * C);       // [RING][8][THREADS]: c, n, z, o, dy, i_log,
    total = ring + RING * 8 * THREADS;     //   f_raw, m a step
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stores into block `rank`'s shared memory at the address of `p` in this
// block's (distributed shared memory).
__device__ __forceinline__ uint32_t peer(const void* p, unsigned rank) {
  uint32_t a = smem_addr(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(a) : "r"(rank));
  return a;
}
__device__ __forceinline__ void st_peer(const float* p, unsigned rank, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(peer(p, rank)), "f"(x) : "memory");
}
__device__ __forceinline__ void st_peer2(const float* p, unsigned rank, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" :: "r"(peer(p, rank)), "f"(x),
               "f"(y) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster calls these, in turns.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 2) : "memory");
}

// Phase clocks, compiled only with -DREPRO_SLSTM_PHASES (the diagnostic
// build of kernels/slstm_scan/phases.py; the served library has none of
// this). Thread 0 of each block adds up the clock() cycles of each phase as
// it sees them and at the end stores them in slstm_phase_cycles[kernel][block].
enum Phase { PROLOGUE, INPUTS, SCALARS, PRODUCTS, GATES, STORES, WAIT, N_PHASES };
#ifdef REPRO_SLSTM_PHASES
constexpr int PHASE_BLOCKS = 1024;
__device__ unsigned slstm_phase_cycles[2][PHASE_BLOCKS][N_PHASES];
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
  __device__ void store(int kernel) const {
    if (threadIdx.x == 0 && blockIdx.x < PHASE_BLOCKS)
#pragma unroll
      for (int p = 0; p < N_PHASES; ++p) slstm_phase_cycles[kernel][blockIdx.x][p] = sum[p];
  }
};
#else
struct PhaseClock {
  __device__ void mark(Phase) const {}
  __device__ void store(int) const {}
};
#endif

// A block's products for NB rows: part[k][j][o] = sum_{d in slice k} x[j][d]
// w[d][o] for o < O, where warp k takes the k-th of WARPS slices of d < len
// (len and the row stride xs multiples of 4) and each lane VEC adjacent
// outputs; the caller sums the slices in order.
template <int NB, int VEC>
__device__ __forceinline__ void products(const float* __restrict__ w, int O,
                                         const float* __restrict__ x, int xs, int len,
                                         float* __restrict__ part) {
  const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (len / 4 + WARPS - 1) / WARPS * 4;
  const int d0 = k * per, d1 = min(len, d0 + per);
  for (int o = lane * VEC; o < O; o += 32 * VEC) {
    float acc[NB][VEC];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][v] = 0.f;
#pragma unroll 4
    for (int d = d0; d < d1; d += 4) {
      float4 xv[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) xv[j] = *reinterpret_cast<const float4*>(x + j * xs + d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float wv[VEC];
        if constexpr (VEC == 2) {
          const float2 t = *reinterpret_cast<const float2*>(w + (d + u) * O + o);
          wv[0] = t.x;
          wv[1] = t.y;
        } else {
          wv[0] = w[(d + u) * O + o];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float xu = u == 0 ? xv[j].x : u == 1 ? xv[j].y : u == 2 ? xv[j].z : xv[j].w;
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[j][v] = fmaf(xu, wv[v], acc[j][v]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[(k * NB + j) * O + o + v] = acc[j][v];
  }
}

// The P blocks' partials (a, f) of row b in rank order, from part
// [P][Bc][2].
__device__ __forceinline__ float2 rank_sums(const float* part, int P, int Bc, int b) {
  float2 s = make_float2(0.f, 0.f);
  for (int q = 0; q < P; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(part + (q * Bc + b) * 2);
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

// products<NB, VEC> for the nb (<= MAX_ROWS) rows of a cluster's group.
template <int VEC>
__device__ __forceinline__ void products_rows(int nb, const float* w, int O, const float* x,
                                              int xs, int len, float* part) {
  switch (nb) {
    case 1: products<1, VEC>(w, O, x, xs, len, part); break;
    case 2: products<2, VEC>(w, O, x, xs, len, part); break;
    case 3: products<3, VEC>(w, O, x, xs, len, part); break;
    case 4: products<4, VEC>(w, O, x, xs, len, part); break;
    case 5: products<5, VEC>(w, O, x, xs, len, part); break;
    case 6: products<6, VEC>(w, O, x, xs, len, part); break;
    case 7: products<7, VEC>(w, O, x, xs, len, part); break;
    default: products<8, VEC>(w, O, x, xs, len, part);
  }
}

// The sums of a and f over the C columns of the thread's row (thread tid =
// row C + column), in every thread of the row: a butterfly within the row's
// lanes where C is a power of two up to 32, else through `red` (2 x n
// floats, n = rows C), each thread adding its row's terms in column order.
// Every thread of the block calls it; a thread without a column gives 0.
__device__ __forceinline__ void row_sums(float& a, float& f, float* red, int C, int n) {
  if ((C & (C - 1)) == 0 && C <= 32) {
    for (int off = C >> 1; off; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      f += __shfl_xor_sync(0xffffffffu, f, off);
    }
    return;
  }
  const int tid = threadIdx.x;
  if (tid < n) {
    red[tid] = a;
    red[n + tid] = f;
  }
  __syncthreads();
  if (tid < n) {
    const int r0 = tid / C * C;
    a = 0.f;
    f = 0.f;
    for (int j = 0; j < C; ++j) {
      a += red[r0 + j];
      f += red[n + r0 + j];
    }
  }
}

// rs[r] = scale x the sum over e < dh of rec[g, head, row0 + r % C, e] (g =
// 1 for r < C, else 2) for the block's rows, a warp a row (lanes in order,
// then a butterfly); 0 past dh.
__device__ __forceinline__ void row_sums_of_rec(float* rs, const float* __restrict__ rec, int H,
                                                int head, int dh, int row0, int C, int Cb,
                                                float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 2 * C; r += WARPS) {
    const int g = r < C ? 1 : 2, c = r % C;
    float s = 0.f;
    if (c < Cb) {
      const float* row = rec + ((static_cast<size_t>(g) * H + head) * dh + row0 + c) * dh;
      for (int e = lane; e < dh; e += 32) s += row[e];
    }
    s = warp_sum(s);
    if (lane == 0) rs[r] = s * scale;
  }
}

__global__ void __launch_bounds__(THREADS, 1) slstm_scan_kernel(
    const float* __restrict__ xz, const float* __restrict__ xi, const float* __restrict__ xf,
    const float* __restrict__ xo, const float* __restrict__ rec, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ hout, float* __restrict__ hN, float* __restrict__ cN,
    float* __restrict__ nN, float* __restrict__ mN, float* __restrict__ c_all,
    float* __restrict__ n_all, float* __restrict__ z_all, float* __restrict__ o_all,
    float* __restrict__ gates, int B, int S, int H, int dh, int C, int P, int Bc) {
  extern __shared__ __align__(16) float smem[];
  PhaseClock phase;
  const FwdSmem L(Bc, dh, C, P);
  float *w = smem + L.w, *hb = smem + L.h, *prod = smem + L.prod, *part = smem + L.part;
  float *rho = smem + L.rho, *red = smem + L.red, *ring = smem + L.ring;
  const int tid = threadIdx.x;
  const unsigned p = cluster_rank();
  const int cl = blockIdx.x / P, head = cl % H, b0 = cl / H * Bc, Bg = min(Bc, B - b0);
  const int col0 = p * C, Cb = max(0, min(C, dh - col0)), D4 = round4(dh), O = 2 * C;
  const int b = tid / C, c = tid % C, e = col0 + c;
  const bool on = b < Bg && c < Cb;      // the thread holds column e of row b

  for (int i = tid; i < D4 * O; i += THREADS) {
    const int d = i / O, g = i % O < C ? 0 : 3, cc = i % C;
    w[i] = d < dh && cc < Cb ? rec[((static_cast<size_t>(g) * H + head) * dh + d) * dh + col0 + cc]
                             : 0.f;
  }
  row_sums_of_rec(rho, rec, H, head, dh, col0, C, Cb, 1.f / dh);
  for (int i = tid; i < 2 * Bc * D4; i += THREADS) {   // h_{-1} = h0 at parity 0, zero padding
    const int j = i / D4 % Bc, d = i % D4;
    hb[i] = i < Bc * D4 && j < Bg && d < dh
                ? h0[(static_cast<size_t>(b0 + j) * H + head) * dh + d] : 0.f;
  }
  float cs = 0.f, ns = 0.f, m = 0.f;
  if (on) {
    const size_t s = (static_cast<size_t>(b0 + b) * H + head) * dh + e;
    cs = c0[s];
    ns = n0[s];
  }
  if (b < Bg) m = m0[(b0 + b) * H + head];
  // the thread's own gate inputs of step s into ring slot s % RING
  auto fetch = [&](int s) {
    if (on && s < S) {
      const size_t x = at(b0 + b, s, head, e, S, H, dh);
      float* slot = ring + (s % RING) * 4 * THREADS + tid;
      cp_async4(slot, xz + x);
      cp_async4(slot + THREADS, xi + x);
      cp_async4(slot + 2 * THREADS, xf + x);
      cp_async4(slot + 3 * THREADS, xo + x);
    }
    cp_commit();
  };
  for (int s = 0; s < RING - 1; ++s) fetch(s);
  __syncthreads();
  cluster_arrive_relaxed();              // the block has started: peers may store into it
  cp_wait_ring();                        // step 0's inputs
  // partials of step 0: sum over the block's columns of xi / dh + h0 rho
  float si = 0.f, sf = 0.f;
  if (on) {
    const float hv = hb[b * D4 + e];
    si = fmaf(hv, rho[c], ring[THREADS + tid] / dh);
    sf = fmaf(hv, rho[C + c], ring[2 * THREADS + tid] / dh);
  }
  row_sums(si, sf, red, C, Bc * C);
  cluster_wait();
  if (b < Bg)
    for (int q = c; q < P; q += C) st_peer2(part + ((0 * P + p) * Bc + b) * 2, q, si, sf);
  cluster_arrive();
  cluster_wait();
  phase.mark(PROLOGUE);

  for (int t = 0; t < S; ++t) {
    const int par = t & 1;
    fetch(t + RING - 1);
    cp_wait_ring();                      // steps <= t + 1
    phase.mark(INPUTS);
    // the head's scalars of the thread's row: the P partials in rank order
    float ib = 0.f, fb = 0.f, il = 0.f, fr = 0.f;
    if (b < Bg) {
      const float2 sums = rank_sums(part + par * P * Bc * 2, P, Bc, b);
      il = sums.x;
      fr = sums.y;
      const float fl = log_sigmoid(fr), mn = fmaxf(fl + m, il);
      ib = expf(il - mn);
      fb = expf(fl + m - mn);
      m = mn;
    }
    phase.mark(SCALARS);
    products_rows<2>(Bg, w, O, hb + par * Bc * D4, D4, D4, prod);
    __syncthreads();
    phase.mark(PRODUCTS);
    float hv = 0.f, zv = 0.f, ov = 0.f;
    const float* cur = ring + (t % RING) * 4 * THREADS + tid;
    if (on) {
      float zp = 0.f, op = 0.f;
      for (int k = 0; k < WARPS; ++k) {
        zp += prod[(k * Bg + b) * O + c];
        op += prod[(k * Bg + b) * O + C + c];
      }
      zv = tanhf(cur[0] + zp);
      ov = sigmoid(cur[3 * THREADS] + op);
      cs = fb * cs + ib * zv;
      ns = fb * ns + ib;
      hv = ov * cs / fmaxf(ns, FLOOR);
    }
    const bool more = t + 1 < S;
    phase.mark(GATES);
    if (more && on) {                    // h_t into every block's h buffer of step t + 1
      float* hnext = hb + (par ^ 1) * Bc * D4 + b * D4 + e;
      for (int q = 0; q < P; ++q) st_peer(hnext, q, hv);
    }
    phase.mark(STORES);
    si = 0.f;
    sf = 0.f;
    if (more) {                          // partials of step t + 1
      if (on) {
        const float* nxt = ring + ((t + 1) % RING) * 4 * THREADS + tid;
        si = fmaf(hv, rho[c], nxt[THREADS] / dh);
        sf = fmaf(hv, rho[C + c], nxt[2 * THREADS] / dh);
      }
      row_sums(si, sf, red, C, Bc * C);
    }
    phase.mark(GATES);
    if (more) {
      if (b < Bg)
        for (int q = c; q < P; q += C)
          st_peer2(part + (((par ^ 1) * P + p) * Bc + b) * 2, q, si, sf);
      cluster_arrive();
    }
    if (on) {                            // outputs, off the chain
      const size_t x = at(b0 + b, t, head, e, S, H, dh);
      hout[x] = hv;
      if (c_all != nullptr) {
        c_all[x] = cs;
        n_all[x] = ns;
        z_all[x] = zv;
        o_all[x] = ov;
        if (p == 0 && c == 0) {
          float* gv = gates + ((static_cast<size_t>(b0 + b) * S + t) * H + head) * 3;
          gv[0] = il;
          gv[1] = fr;
          gv[2] = m;
        }
      }
      if (!more) {
        const size_t s = (static_cast<size_t>(b0 + b) * H + head) * dh + e;
        hN[s] = hv;
        cN[s] = cs;
        nN[s] = ns;
        if (p == 0 && c == 0) mN[(b0 + b) * H + head] = m;
      }
    }
    phase.mark(STORES);
    if (more) cluster_wait();
    phase.mark(WAIT);
  }
  phase.store(0);
}

__global__ void __launch_bounds__(THREADS, 1) slstm_scan_bwd_kernel(
    const float* __restrict__ rec, const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, const float* __restrict__ c_all,
    const float* __restrict__ n_all, const float* __restrict__ z_all,
    const float* __restrict__ o_all, const float* __restrict__ gates,
    const float* __restrict__ dy, float* __restrict__ dxz, float* __restrict__ dxi,
    float* __restrict__ dxf, float* __restrict__ dxo, int B, int S, int H, int dh, int C, int P,
    int Bc) {
  extern __shared__ __align__(16) float smem[];
  PhaseClock phase;
  const BwdSmem L(Bc, dh, C, P);
  float *w = smem + L.w, *rs = smem + L.rs, *dp = smem + L.dp, *prod = smem + L.prod;
  float *part = smem + L.part, *red = smem + L.red, *ring = smem + L.ring;
  const int tid = threadIdx.x;
  const unsigned p = cluster_rank();
  const int cl = blockIdx.x / P, head = cl % H, b0 = cl / H * Bc, Bg = min(Bc, B - b0);
  const int row0 = p * C, Cb = max(0, min(C, dh - row0)), D4 = round4(dh), D8 = 2 * D4;
  const int b = tid / C, c = tid % C, e = row0 + c;
  const bool on = b < Bg && c < Cb;

  for (int i = tid; i < D8 * C; i += THREADS) {
    const int j = i / C, cc = i % C, g = j < D4 ? 0 : 3, d = j % D4;
    w[i] = cc < Cb && d < dh
               ? rec[((static_cast<size_t>(g) * H + head) * dh + row0 + cc) * dh + d] : 0.f;
  }
  row_sums_of_rec(rs, rec, H, head, dh, row0, C, Cb, 1.f);
  for (int i = tid; i < 2 * Bc * D8; i += THREADS) dp[i] = 0.f;   // zero padding
  float c_init = 0.f, n_init = 0.f, m_init = 0.f;
  if (on) {
    const size_t s = (static_cast<size_t>(b0 + b) * H + head) * dh + e;
    c_init = c0[s];
    n_init = n0[s];
    m_init = m0[(b0 + b) * H + head];
  }
  // the thread's own saved values of step s into ring slot s % RING
  auto fetch = [&](int s) {
    if (on && s >= 0) {
      const size_t x = at(b0 + b, s, head, e, S, H, dh);
      const float* g = gates + ((static_cast<size_t>(b0 + b) * S + s) * H + head) * 3;
      float* slot = ring + (s % RING) * 8 * THREADS + tid;
      cp_async4(slot, c_all + x);
      cp_async4(slot + THREADS, n_all + x);
      cp_async4(slot + 2 * THREADS, z_all + x);
      cp_async4(slot + 3 * THREADS, o_all + x);
      cp_async4(slot + 4 * THREADS, dy + x);
      cp_async4(slot + 5 * THREADS, g);
      cp_async4(slot + 6 * THREADS, g + 1);
      cp_async4(slot + 7 * THREADS, g + 2);
    }
    cp_commit();
  };
  for (int s = S - 1; s > S - RING; --s) fetch(s);
  cluster_arrive();                      // every block of the cluster has started, and
  cluster_wait();                        //   its zeros of dp land before any peer's stores
  phase.mark(PROLOGUE);

  float dc = 0.f, dn = 0.f, dhr = 0.f, dm = 0.f;
  for (int t = S - 1; t >= 0; --t) {
    const int par = t & 1;
    fetch(t - RING + 1);
    cp_wait_ring();                      // steps >= t - 1
    phase.mark(INPUTS);
    const float* cur = ring + (t % RING) * 8 * THREADS + tid;
    const float* prv = ring + ((t + RING - 1) % RING) * 8 * THREADS + tid;
    float ib = 0.f, fb = 0.f, il = 0.f, flm = 0.f, fr = 0.f;
    float ti = 0.f, tf = 0.f, dpz = 0.f, dpo = 0.f;
    if (on) {
      il = cur[5 * THREADS];
      fr = cur[6 * THREADS];
      const float mt = cur[7 * THREADS], mp = t ? prv[7 * THREADS] : m_init;
      const float cp = t ? prv[0] : c_init, np = t ? prv[THREADS] : n_init;
      const float fl = log_sigmoid(fr);
      ib = expf(il - mt);
      fb = expf(fl + mp - mt);
      flm = fl + mp;
      const float cv = cur[0], nv = cur[THREADS], zv = cur[2 * THREADS], ov = cur[3 * THREADS];
      const float g = cur[4 * THREADS] + dhr;
      const float nd = fmaxf(nv, FLOOR);
      const float dov = g * cv / nd;
      const float dct = dc + g * ov / nd;
      const float share = nv > FLOOR ? 1.f : (nv == FLOOR ? 0.5f : 0.f);
      const float dnt = dn + -g * ov * cv / (nd * nd) * share;
      ti = dct * zv + dnt;
      tf = dct * cp + dnt * np;
      dc = dct * fb;
      dn = dnt * fb;
      dpz = dct * ib * (1.f - zv * zv);
      dpo = dov * ov * (1.f - ov);
    }
    phase.mark(GATES);
    if (on && t > 0) {                   // dpre_z, dpre_o into every block
      float* slot = dp + (par * Bc + b) * D8 + e;
      for (int q = 0; q < P; ++q) {
        st_peer(slot, q, dpz);
        st_peer(slot + D4, q, dpo);
      }
    }
    phase.mark(STORES);
    row_sums(ti, tf, red, C, Bc * C);
    phase.mark(GATES);
    if (b < Bg)
      for (int q = c; q < P; q += C) st_peer2(part + ((par * P + p) * Bc + b) * 2, q, ti, tf);
    cluster_arrive();
    const size_t x = at(b0 + b, t, head, e, S, H, dh);
    if (on) {
      dxz[x] = dpz;
      dxo[x] = dpo;
    }
    phase.mark(STORES);
    cluster_wait();
    phase.mark(WAIT);
    float dpi = 0.f, dpf = 0.f;
    if (on) {
      const float2 sums = rank_sums(part + par * P * Bc * 2, P, Bc, b);
      const float di = sums.x * ib, df = sums.y * fb;
      const float dmn = dm - di - df;
      const float arm = flm > il ? 1.f : (flm == il ? 0.5f : 0.f);
      const float dil = di + dmn * (1.f - arm);
      const float dfl = df + dmn * arm;
      dm = df + dmn * arm;
      dpi = dil / dh;
      dpf = dfl * sigmoid(-fr) / dh;
      dxi[x] = dpi;
      dxf[x] = dpf;
    }
    phase.mark(SCALARS);
    if (t == 0) break;
    products_rows<1>(Bg, w, C, dp + par * Bc * D8, D8, D8, prod);
    __syncthreads();
    if (on) {
      float s = 0.f;
      for (int k = 0; k < WARPS; ++k) s += prod[(k * Bg + b) * C + c];
      dhr = s + dpi * rs[c] + dpf * rs[C + c];
    }
    phase.mark(PRODUCTS);
  }
  phase.store(1);
}

// n cluster barriers on the kernels' grid: one barrier's cost, the chain
// bound's unit.
__global__ void __launch_bounds__(THREADS, 1) slstm_barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) {
    cluster_arrive();
    cluster_wait();
  }
}

bool plan_ok(int B, int S, int H, int dh, int C, int P, int Bc) {
  return B >= 1 && S >= 1 && H >= 1 && dh >= 1 && P >= 1 && P <= MAX_CLUSTER &&
         (P & (P - 1)) == 0 && C == (dh + P - 1) / P && Bc >= 1 && Bc <= MAX_ROWS &&
         Bc * C <= THREADS &&
         static_cast<int64_t>(H) * ((B + Bc - 1) / Bc) * P < (int64_t(1) << 31) &&
         static_cast<int64_t>(B) * S * H * dh < (int64_t(1) << 40);
}

// Raise `kernel`'s dynamic shared memory to `smem` bytes and allow clusters
// past the portable 8 blocks.
cudaError_t configure(const void* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A launch of `clusters` clusters of P blocks.
void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int clusters, int P,
                   size_t smem, cudaStream_t stream) {
  *cfg = {};
  cfg->gridDim = dim3(clusters * P);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

size_t smem_bytes(bool fwd, int Bc, int dh, int C, int P) {
  return sizeof(float) * (fwd ? FwdSmem(Bc, dh, C, P).total : BwdSmem(Bc, dh, C, P).total);
}

const void* kernel_of(bool fwd) {
  return fwd ? reinterpret_cast<const void*>(slstm_scan_kernel)
             : reinterpret_cast<const void*>(slstm_scan_bwd_kernel);
}

}  // namespace

// The forward: xz, xi, xf, xo float32 [B, S, H, dh] and rec [4, H, dh, dh],
// all contiguous; the state h0, c0, n0 [B, H, dh] and m0 [B, H]; out: h
// [B, S, H, dh] and the final state hN, cN, nN, mN. c_all, n_all, z_all,
// o_all [B, S, H, dh] and gates [B, S, H, 3] are written when c_all is not
// null (training). The plan (ops.scan_plan): clusters of P blocks of C =
// ceil(dh / P) columns, Bc batch rows a cluster. Returns a cudaError_t.
extern "C" int slstm_scan_fwd(const void* xz, const void* xi, const void* xf, const void* xo,
                              const void* rec, const void* h0, const void* c0, const void* n0,
                              const void* m0, void* h, void* hN, void* cN, void* nN, void* mN,
                              void* c_all, void* n_all, void* z_all, void* o_all, void* gates,
                              int B, int S, int H, int dh, int C, int P, int Bc, void* stream) {
  if (!plan_ok(B, S, H, dh, C, P, Bc)) return (int)cudaErrorInvalidValue;
  if ((c_all == nullptr) != (gates == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(true, Bc, dh, C, P);
  cudaError_t err = configure(kernel_of(true), smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, H * ((B + Bc - 1) / Bc), P, smem, static_cast<cudaStream_t>(stream));
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  err = cudaLaunchKernelEx(&cfg, slstm_scan_kernel, f(xz), f(xi), f(xf), f(xo), f(rec), f(h0),
                           f(c0), f(n0), f(m0), o(h), o(hN), o(cN), o(nN), o(mN), o(c_all),
                           o(n_all), o(z_all), o(o_all), o(gates), B, S, H, dh, C, P, Bc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward: rec, the initial c0, n0 [B, H, dh] and m0 [B, H], the
// forward's saved c, n, z, o [B, S, H, dh] and gates [B, S, H, 3], and dy,
// the gradient of h; out: dxz, dxi, dxf, dxo [B, S, H, dh]. The same plan
// as the forward. Returns a cudaError_t.
extern "C" int slstm_scan_bwd(const void* rec, const void* c0, const void* n0, const void* m0,
                              const void* c_all, const void* n_all, const void* z_all,
                              const void* o_all, const void* gates, const void* dy, void* dxz,
                              void* dxi, void* dxf, void* dxo, int B, int S, int H, int dh,
                              int C, int P, int Bc, void* stream) {
  if (!plan_ok(B, S, H, dh, C, P, Bc)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(false, Bc, dh, C, P);
  cudaError_t err = configure(kernel_of(false), smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, H * ((B + Bc - 1) / Bc), P, smem, static_cast<cudaStream_t>(stream));
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  err = cudaLaunchKernelEx(&cfg, slstm_scan_bwd_kernel, f(rec), f(c0), f(n0), f(m0), f(c_all),
                           f(n_all), f(z_all), f(o_all), f(gates), f(dy), o(dxz), o(dxi),
                           o(dxf), o(dxo), B, S, H, dh, C, P, Bc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A forward (fwd = 1) or backward (0) block's shared bytes at the plan (Bc,
// dh, C, P), and how many clusters of P such blocks the card runs at once
// (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
extern "C" int slstm_scan_residency(int fwd, int Bc, int dh, int C, int P, int* smem,
                                    int* clusters) {
  if (!plan_ok(1, 1, 1, dh, C, P, Bc)) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(fwd != 0, Bc, dh, C, P);
  *smem = static_cast<int>(bytes);
  cudaError_t err = configure(kernel_of(fwd != 0), bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, 1, P, bytes, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel_of(fwd != 0), &cfg);
}

// n cluster barriers on a grid of `clusters` clusters of P blocks with
// `smem` dynamic shared bytes each (the forward's, ops.forward_smem_floats).
extern "C" int slstm_barrier_probe(int clusters, int P, int smem, int n, void* stream) {
  if (clusters < 1 || P < 1 || P > MAX_CLUSTER || n < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(slstm_barrier_kernel);
  cudaError_t err = configure(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, clusters, P, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, slstm_barrier_kernel, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef REPRO_SLSTM_PHASES
// Copies the phase cycles of blocks [0, n) of the last launch of the
// forward (kernel 0) or backward (1) to out, n x N_PHASES unsigned ints in
// the order of enum Phase.
extern "C" int slstm_phase_cycles_read(int kernel, unsigned* out, int n) {
  if (kernel < 0 || kernel > 1 || n < 0 || n > PHASE_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, slstm_phase_cycles,
                                   sizeof(unsigned) * N_PHASES * n,
                                   sizeof(unsigned) * N_PHASES * PHASE_BLOCKS * kernel);
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
