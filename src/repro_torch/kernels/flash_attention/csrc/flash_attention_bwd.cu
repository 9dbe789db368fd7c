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
// Two families, chosen by dtype and head dim as the forward chooses:
//
// * bfloat16 at head_dim 64, 128 or 256 -> three kernels on one stream, the
//   products on the tensor cores (wgmma m64nNk16, bf16 in, float32
//   accumulate), every tile fed by TMA (4-D maps over q, k, v and dO with
//   64-row boxes and the 128-byte swizzle, planned by kernels/_tma.py):
//   - flash_bwd_tc_dq_kernel<HD>, grid (ceil(S / 64), B * H): one consumer
//     warpgroup owns a 64-row query tile of one head; a producer warp loads
//     Q and dO once and streams the visible 64-key K/V tiles through a ring
//     of 2 mbarrier-guarded stages. Per tile: S = Q K^T and dP = dO V^T
//     (ss products), P = exp2(S scale log2e - lse log2e) and dS = P o (dP -
//     delta) in registers, masked per accumulator register's (row, column)
//     on the diagonal, window-edge and past-S tiles, then dQ += dS K with dS
//     as bf16 A fragments and K as the MN-major B operand. Before the loop
//     it computes its rows' delta (16-byte loads of O and dO) and writes
//     delta and lse log2e, rows padded to a multiple of 64 (+inf past S, so
//     P = 0 there), for the next kernel. Registers: dQ hd / 2 floats a
//     thread, S and dP 32 each (5 warps: up to 255 a thread, no spill at hd
//     256); shared memory 6 tiles, 192 KB at hd 256 (one block an SM).
//   - flash_bwd_tc_dkdv_kernel<HD>, grid (ceil(S / 64), B * H): a block owns
//     64 keys of one kv head for ONE query head of its group, so
//     recurrentgemma-2b's B 1, K 1, S 3072 gets 480 blocks where one per kv
//     head would give 48 for 132 SMs. K and V arrive once; the query tiles
//     that see the keys stream through a 2-stage Q/dO ring, their lse and
//     delta rows by bulk copies. Two warpgroups split the four products and
//     the accumulators, so neither holds more than hd / 2 + 32 floats a
//     thread: warpgroup 0 computes P^T = exp2(K Q^T ...) (keys as wgmma's M)
//     and dV += P^T dO, the P^T accumulator feeding the A registers
//     directly; warpgroup 1 computes dP^T = V dO^T, takes P^T from a 16 KB
//     float buffer in the same fragment layout (thread t of each group owns
//     the same (row, column): no shuffle; named barriers 1 and 2 hand it
//     over and back) and accumulates dK += dS^T Q. The first thread of
//     warpgroup 1 issues the loads, refilling a stage once both warpgroups
//     left it: with a ninth (producer) warp ptxas caps a thread at 168
//     registers (three warps share each quarter of the register file) and
//     hd 256 spilled; setmaxnreg did not lift the cap. Each block writes its
//     head's float32 partial dK (scaled) and dV to scratch [B, S, H, hd] x 2.
//     Shared memory at hd 256: K, V 64 KB, Q/dO ring 128 KB, P^T 16 KB.
//   - flash_bwd_reduce_kernel sums each kv head's G partials in head order
//     and rounds to bf16 once.
//   Precision: P (for dV) and dS (for dQ, dK) become bf16 operands, 2^-9
//   relative a term. Where a row sees few keys P is near 1 and its terms
//   dwarf the typical gradient, so one rounding of each term breaks the
//   elementwise tolerance there. A tile in which some P >= split_p (the
//   wrapper's SPLIT_P, 1/64; one vote a warpgroup, bar.red.or) also
//   multiplies lo = bf16(x - bf16(x)), which leaves ~2^-17 a term; below it
//   the terms are small enough that one rounding stays inside the bound.
//   kernels/flash_attention/split_sweep.py measures the trade on the card.
//   No atomics: every sum has one order, so two calls give the same bits.
//   Seven products where five suffice (S and dP are recomputed for dQ, which
//   keeps dQ out of a cross-block reduction), plus the lo products of the
//   tiles that split.
// * float32 at every head dim, and bfloat16 at head_dim 16 -> two kernels on
//   CUDA cores (float32 FMAs; bf16 is widened as it is staged): float32
//   wgmma would be TF32 and break the float32 tolerance, and a 16-column
//   bf16 row is narrower than a 128-byte swizzle box.
//   - flash_bwd_dq_kernel: one block per (32-row query tile, b * H), four
//     threads a row. It computes delta for its rows (stored for the second
//     kernel), then walks the key tiles the rows can see, recomputes P and
//     dP for 8 key columns a thread, stores dS in shared memory and
//     accumulates dQ (hd / 4 columns a thread) in registers.
//   - flash_bwd_dkdv_kernel: one block per (16-key tile, b * K), eight
//     threads a key. Its K and V rows stay in shared memory; it walks the G
//     query heads of its group and, for each, the query tiles that can see
//     its keys, recomputing P^T and dP^T for 4 query columns a thread, and
//     accumulates dK and dV (hd / 8 columns each a thread) in registers,
//     the group's heads summed in order.
//   Their products read padded float tiles in shared memory (~1 load an
//   FMA), so they are bound by shared-memory bandwidth.

#include "common/hopper.cuh"   // mbarriers, named barriers, TMA, wgmma

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

// ---------------------------------------------------------------------------
// bfloat16 at head_dim 64, 128 or 256: tensor-core kernels (wgmma, TMA)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64;            // rows a block owns: queries (dQ) or keys (dK/dV); wgmma M
constexpr int TC_BN = 64;            // rows of a streamed tile: keys (dQ) or queries (dK/dV)
constexpr int TC_STAGES = 2;         // streamed tiles in the shared-memory ring
constexpr int ATOM = TMA_BOX_COLS;   // bf16 columns in one 128-byte swizzle row
constexpr int WG = 128;              // threads in a warpgroup
constexpr int DQ_THREADS = WG + 32;          // a consumer warpgroup and a producer warp
constexpr int DKDV_THREADS = 2 * WG;         // two consumer warpgroups, one thread issuing loads
constexpr int REDUCE_THREADS = 256;
constexpr int PLAN = TMA_PLAN_VALUES;
constexpr int BAR_P_READY = 1, BAR_P_FREE = 2;   // named barriers of the P^T hand-off
constexpr int BAR_SPLIT = 3;         // + warpgroup: the vote on a tile's split (dQ: 1)
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct DqLayout {                    // byte offsets from a 1024-aligned base
  static constexpr int TILE = TC_BM * HD * 2;             // one 64-row bf16 tile
  static constexpr int Q_OFF = 0, DO_OFF = TILE;
  static constexpr int K_OFF = 2 * TILE;                  // stage s at + s * TILE
  static constexpr int V_OFF = K_OFF + TC_STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * TC_STAGES) + 1024;  // + alignment slack
};

template <int HD>
struct DkdvLayout {
  static constexpr int TILE = TC_BM * HD * 2;
  static constexpr int K_OFF = 0, V_OFF = TILE;
  static constexpr int Q_OFF = 2 * TILE;                  // stage s at + s * TILE
  static constexpr int DO_OFF = Q_OFF + TC_STAGES * TILE;
  static constexpr int P_OFF = DO_OFF + TC_STAGES * TILE; // P^T: float [BN / 2][WG]
  static constexpr int ROW_OFF = P_OFF + TC_BM * TC_BN * 4;  // a stage's lse log2e, delta
  static constexpr int BAR_OFF = ROW_OFF + TC_STAGES * 2 * TC_BN * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * TC_STAGES) + 1024;
};

static_assert(DqLayout<256>::BYTES <= 232448 && DkdvLayout<256>::BYTES <= 232448,
              "the hd 256 tiles fit one block's shared memory");

// acc[32] = A B^T over hd: A and B 64-row K-major tiles (hd / 64 swizzle
// boxes of [64 rows][64 columns] each), hd / 16 k16 steps.
template <int HD>
__device__ __forceinline__ void product_nt(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(acc, smem_desc(a + (kk / 4) * TC_BM * 128 + (kk % 4) * 32, 1, 64),
                 smem_desc(b + (kk / 4) * TC_BN * 128 + (kk % 4) * 32, 1, 64), kk > 0);
}

// acc[hd / 2] += X B: X the 64 x 64 accumulator packed as bf16 A fragments,
// B a 64-row tile as the MN-major operand; k16 step j starts 16 rows down.
template <int HD>
__device__ __forceinline__ void product_rs(float* acc, uint32_t (*pa)[4], uint32_t b) {
#pragma unroll
  for (int j = 0; j < TC_BN / 16; ++j)
    wgmma_rs<HD>(acc, pa[j], smem_desc(b + j * 16 * 128, TC_BN * 128 / 16, 64));
}

// The m64n64 accumulator x as bf16 A fragments, hi = bf16(x) and lo =
// bf16(x - hi): columns 16 j .. 16 j + 15 are already in the register
// layout of a k16 A fragment.
__device__ __forceinline__ void pack_split(uint32_t (*hi)[4], uint32_t (*lo)[4], const float* x) {
#pragma unroll
  for (int j = 0; j < TC_BN / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = x[8 * j + 2 * e], b = x[8 * j + 2 * e + 1];
      hi[j][e] = pack_bf16(a, b);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[j][e]);
      lo[j][e] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

__device__ __forceinline__ void init_ring(uint32_t once, uint32_t full0, uint32_t empty0,
                                          uint32_t consumers) {
  mbar_init(once, 1);
  for (int s = 0; s < TC_STAGES; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, consumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Grid: (ceil(S / 64), B * H); block y is (batch b, query head h), which
// reads kv head h / G. m64nN fragment of a consumer thread: rows r0 and r0 +
// 8 of the tile, columns 8 i + 2 (lane % 4) + {0, 1}; register 4 i + {0, 1}
// is row r0, 4 i + {2, 3} row r0 + 8.
template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       __nv_bfloat16* __restrict__ dq, float* __restrict__ lse2,
                       float* __restrict__ delta, int S, int S_pad, int H, int G, int causal,
                       int window, float scale, float split_p) {
  using L = DqLayout<HD>;
  constexpr int ATOMS = HD / ATOM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t qd_full = base + L::BAR_OFF;
  const uint32_t full0 = qd_full + 8, empty0 = full0 + 8 * TC_STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * TC_BM;
  // key tiles this query tile can see (the forward's range)
  const int kv_end = causal ? min(q0 + TC_BM, S) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = kv_begin / TC_BN;
  const int n_tiles = (kv_end + TC_BN - 1) / TC_BN - t0;

  if (threadIdx.x == 0) init_ring(qd_full, full0, empty0, WG);
  __syncthreads();

  if (threadIdx.x >= WG) {
    // producer: one thread starts every load
    if (threadIdx.x != WG) return;
    mbar_expect_tx(qd_full, 2 * L::TILE);
    for (int a = 0; a < ATOMS; ++a) {
      tma_load_4d(base + L::Q_OFF + a * TC_BM * 128, &tm_q, qd_full, a * ATOM, h, q0, b);
      tma_load_4d(base + L::DO_OFF + a * TC_BM * 128, &tm_do, qd_full, a * ATOM, h, q0, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % TC_STAGES;
      if (t >= TC_STAGES) mbar_wait(empty0 + 8 * s, ((t / TC_STAGES) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, 2 * L::TILE);
      const int k0 = (t0 + t) * TC_BN;
      for (int a = 0; a < ATOMS; ++a) {
        tma_load_4d(base + L::K_OFF + s * L::TILE + a * TC_BN * 128, &tm_k, full, a * ATOM, kh,
                    k0, b);
        tma_load_4d(base + L::V_OFF + s * L::TILE + a * TC_BN * 128, &tm_v, full, a * ATOM, kh,
                    k0, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;
  const int cq = 2 * (lane % 4);

  // delta = rowsum(dO o O) and lse log2e of rows r0 and r0 + 8 (the four
  // lanes of a row take every fourth 16-byte chunk), stored for the dK/dV
  // kernel; rows past S get lse +inf (so P = 0) and delta 0.
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    float sum = 0.f;
    if (qi < S) {
      const int64_t row = (((int64_t)b * S + qi) * H + h) * HD;
      const uint4* og = reinterpret_cast<const uint4*>(o + row);
      const uint4* gg = reinterpret_cast<const uint4*>(dout + row);
#pragma unroll
      for (int c = lane % 4; c < HD / 8; c += 4) {
        const uint4 ov = og[c], gv = gg[c];
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]), gf = __bfloat1622float2(gp[e]);
          sum = fmaf(gf.x, of.x, sum);
          sum = fmaf(gf.y, of.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
    l2[r] = qi < S ? lse[(int64_t)bh * S + qi] * LOG2E : __int_as_float(0x7f800000);   // +inf
    if (lane % 4 == 0) {
      delta[(int64_t)bh * S_pad + qi] = dl[r];
      lse2[(int64_t)bh * S_pad + qi] = l2[r];
    }
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  mbar_wait(qd_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % TC_STAGES;
    mbar_wait(full0 + 8 * s, (t / TC_STAGES) & 1);
    const uint32_t k_base = base + L::K_OFF + s * L::TILE;
    const uint32_t v_base = base + L::V_OFF + s * L::TILE;

    // S = Q K^T and dP = dO V^T
    float sc[TC_BN / 2], dp[TC_BN / 2];
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs<TC_BN / 2>(sc);
    fence_regs<TC_BN / 2>(dp);
    wgmma_fence();
    product_nt<HD>(sc, base + L::Q_OFF, k_base);
    product_nt<HD>(dp, base + L::DO_OFF, v_base);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<TC_BN / 2>(sc);
    fence_regs<TC_BN / 2>(dp);

    // dS = P o (dP - delta), P masked on the diagonal, window-edge and past-S tiles
    const int k0 = (t0 + t) * TC_BN;
    const bool edge = k0 + TC_BN > S || (causal && k0 + TC_BN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + TC_BM - 1 - window);
    bool big = false;
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) {
      const int half = (i % 4) / 2;              // 0: row r0, 1: row r0 + 8
      float p = exp2f(fmaf(sc[i], scale_log2, -l2[half]));
      if (edge && !visible(q0 + r0 + 8 * half, k0 + 8 * (i / 4) + cq + (i % 2), S, causal,
                           window))
        p = 0.f;
      big = big || p >= split_p;
      sc[i] = p * (dp[i] - dl[half]);
    }
    const bool split = named_bar_any(1, WG, big);
    uint32_t pa[TC_BN / 16][4], pb[TC_BN / 16][4];
    pack_split(pa, pb, sc);

    // dQ += dS K: K [BN keys][hd] is the MN-major B operand
    fence_regs<HD / 2>(acc);
    fence_regs<TC_BN / 4>(&pa[0][0]);
    fence_regs<TC_BN / 4>(&pb[0][0]);
    wgmma_fence();
    product_rs<HD>(acc, pa, k_base);
    if (split) product_rs<HD>(acc, pb, k_base);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<HD / 2>(acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= S) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * S + qi) * H + h) * HD + cq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
  }
}

// Grid: (ceil(S / 64), B * H); block (x, y) owns keys 64 x .. 64 x + 63 of
// kv head h / G for query head h only, and writes that head's partial dK
// and dV. Threads 0-127: warpgroup 0 (P^T, dV); 128-255: warpgroup 1 (dP^T,
// dK), whose first thread also issues the loads. No producer warp: eight
// warps leave 255 registers a thread (a ninth would cap them at 168, three
// warps to each quarter of the register file, and hd 256 would spill).
template <int HD>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
flash_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         float* __restrict__ dk_part, float* __restrict__ dv_part, int S,
                         int S_pad, int H, int G, int causal, int window, float scale,
                         float split_p) {
  using L = DkdvLayout<HD>;
  constexpr int ATOMS = HD / ATOM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* smem_f = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t kv_full = base + L::BAR_OFF;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * TC_STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / G;
  const int k0 = blockIdx.x * TC_BM;
  // query tiles that can see these keys
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + TC_BM - 1 + window) : S;
  const int t0 = q_begin / TC_BN;
  const int n_tiles = (q_end + TC_BN - 1) / TC_BN - t0;

  if (threadIdx.x == 0) init_ring(kv_full, full0, empty0, 2 * WG);
  __syncthreads();

  // the issuing thread: K and V once, then query tile t into stage t % STAGES
  const bool issuer = threadIdx.x == WG;
  const float* l2_row = lse2 + (int64_t)bh * S_pad;
  const float* dl_row = delta + (int64_t)bh * S_pad;
  auto issue = [&](int t) {
    const int s = t % TC_STAGES, q0 = (t0 + t) * TC_BN;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::TILE + 2 * TC_BN * 4);
    for (int a = 0; a < ATOMS; ++a) {
      tma_load_4d(base + L::Q_OFF + s * L::TILE + a * TC_BN * 128, &tm_q, full, a * ATOM, h, q0,
                  b);
      tma_load_4d(base + L::DO_OFF + s * L::TILE + a * TC_BN * 128, &tm_do, full, a * ATOM, h,
                  q0, b);
    }
    const uint32_t rows = base + L::ROW_OFF + s * 2 * TC_BN * 4;
    bulk_load(rows, l2_row + q0, TC_BN * 4, full);
    bulk_load(rows + TC_BN * 4, dl_row + q0, TC_BN * 4, full);
  };
  if (issuer) {
    mbar_expect_tx(kv_full, 2 * L::TILE);
    for (int a = 0; a < ATOMS; ++a) {
      tma_load_4d(base + L::K_OFF + a * TC_BM * 128, &tm_k, kv_full, a * ATOM, kh, k0, b);
      tma_load_4d(base + L::V_OFF + a * TC_BM * 128, &tm_v, kv_full, a * ATOM, kh, k0, b);
    }
    for (int t = 0; t < min(TC_STAGES, n_tiles); ++t) issue(t);
  }

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;      // key rows r0, r0 + 8
  const int cq = 2 * (lane % 4);
  float* p_buf = smem_f + L::P_OFF / 4;

  float acc[HD / 2];                              // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % TC_STAGES;
    mbar_wait(full0 + 8 * s, (t / TC_STAGES) & 1);
    const uint32_t q_s = base + L::Q_OFF + s * L::TILE;
    const uint32_t do_s = base + L::DO_OFF + s * L::TILE;
    const float* rows = smem_f + (L::ROW_OFF + s * 2 * TC_BN * 4) / 4;   // lse log2e, delta
    const int q0 = (t0 + t) * TC_BN;

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (keys as M)
    float x[TC_BN / 2];
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) x[i] = 0.f;
    fence_regs<TC_BN / 2>(x);
    wgmma_fence();
    product_nt<HD>(x, base + (wg == 0 ? L::K_OFF : L::V_OFF), wg == 0 ? q_s : do_s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<TC_BN / 2>(x);

    bool big = false;
    if (wg == 0) {
      // P^T, masked on the diagonal, window-edge and past-S tiles; handed
      // to warpgroup 1 in the accumulator's own layout
      const bool edge = q0 + TC_BN > S || (causal && q0 < k0 + TC_BM - 1) ||
                        (window > 0 && k0 <= q0 + TC_BN - 1 - window);
#pragma unroll
      for (int i = 0; i < TC_BN / 2; ++i) {
        const int col = 8 * (i / 4) + cq + (i % 2);
        float p = exp2f(fmaf(x[i], scale_log2, -rows[col]));
        if (edge && !visible(q0 + col, k0 + r0 + 8 * ((i % 4) / 2), S, causal, window)) p = 0.f;
        big = big || p >= split_p;
        x[i] = p;
      }
      if (t > 0) named_bar_sync(BAR_P_FREE, 2 * WG);       // warpgroup 1 read the last P^T
#pragma unroll
      for (int i = 0; i < TC_BN / 2; ++i) p_buf[i * WG + tid] = x[i];
      named_bar_arrive(BAR_P_READY, 2 * WG);
    } else {
      named_bar_sync(BAR_P_READY, 2 * WG);
#pragma unroll
      for (int i = 0; i < TC_BN / 2; ++i) {
        const int col = 8 * (i / 4) + cq + (i % 2);
        const float p = p_buf[i * WG + tid];
        big = big || p >= split_p;
        x[i] = p * (x[i] - rows[TC_BN + col]);      // dS^T
      }
      if (t + 1 < n_tiles) named_bar_arrive(BAR_P_FREE, 2 * WG);
    }
    const bool split = named_bar_any(BAR_SPLIT + wg, WG, big);
    uint32_t pa[TC_BN / 16][4], pb[TC_BN / 16][4];
    pack_split(pa, pb, x);

    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
    const uint32_t b_tile = wg == 0 ? do_s : q_s;
    fence_regs<HD / 2>(acc);
    fence_regs<TC_BN / 4>(&pa[0][0]);
    fence_regs<TC_BN / 4>(&pb[0][0]);
    wgmma_fence();
    product_rs<HD>(acc, pa, b_tile);
    if (split) product_rs<HD>(acc, pb, b_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<HD / 2>(acc);
    mbar_arrive(empty0 + 8 * s);
    if (issuer && t + TC_STAGES < n_tiles) {   // refill the stage once both warpgroups left it
      mbar_wait(empty0 + 8 * s, (t / TC_STAGES) & 1);
      issue(t + TC_STAGES);
    }
  }

  float* part = wg == 0 ? dv_part : dk_part;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + r0 + 8 * r;
    if (ki >= S) continue;
    float* row = part + (((int64_t)b * S + ki) * H + h) * HD + cq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  }
}

// dk[b, s, kh] = sum over g = 0 .. G - 1, in that order, of dk_part[b, s,
// kh G + g] (dv the same), rounded to bf16 once. One thread a 4-column
// group; n = B S K hd / 4 groups, hd4 = hd / 4.
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_reduce_kernel(const float4* __restrict__ dk_part, const float4* __restrict__ dv_part,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int64_t n, int G, int hd4) {
  const int64_t e = (int64_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e >= n) return;
  const int64_t row = e / hd4, d = e % hd4;       // row: (b S + s) K + kh
  const int64_t src = row * G * hd4 + d;          // head kh G of that (b, s)
  float4 sk = dk_part[src], sv = dv_part[src];
  for (int g = 1; g < G; ++g) {
    const float4 a = dk_part[src + g * hd4], c = dv_part[src + g * hd4];
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * e;
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * e;
  ok[0] = __floats2bfloat162_rn(sk.x, sk.y);
  ok[1] = __floats2bfloat162_rn(sk.z, sk.w);
  ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
  ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// plans: the tensor maps of q, k, v and dO (PLAN values each, 64-row boxes).
// rows: float32 [2, B H, S_pad] scratch (lse log2e, then delta); part:
// float32 [2, B, S, H, hd] scratch (partial dK, then dV).
template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, void* dk, void* dv,
                      float* rows, float* part, int B, int S, int H, int K,
                      const int64_t* plans, int causal, int window, float scale,
                      float split_p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = encode_map(&tm_q, q, plans, HD, H, S, B, TC_BM)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_k, k, plans + PLAN, HD, K, S, B, TC_BN)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_v, v, plans + 2 * PLAN, HD, K, S, B, TC_BN)) != cudaSuccess)
    return err;
  if ((err = encode_map(&tm_do, dout, plans + 3 * PLAN, HD, H, S, B, TC_BM)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_bwd_tc_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DqLayout<HD>::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_tc_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DkdvLayout<HD>::BYTES);
  if (err != cudaSuccess) return err;
  const int S_pad = (S + TC_BM - 1) / TC_BM * TC_BM;
  float* lse2 = rows;
  float* delta = rows + (int64_t)B * H * S_pad;
  float* dk_part = part;
  float* dv_part = part + (int64_t)B * S * H * HD;
  const dim3 grid(S_pad / TC_BM, B * H);
  flash_bwd_tc_dq_kernel<HD><<<grid, DQ_THREADS, DqLayout<HD>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, static_cast<__nv_bfloat16*>(dq), lse2,
      delta, S, S_pad, H, H / K, causal, window, scale, split_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // after the dQ kernel on the same stream: it reads the rows that one wrote
  flash_bwd_tc_dkdv_kernel<HD><<<grid, DKDV_THREADS, DkdvLayout<HD>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse2, delta, dk_part, dv_part, S, S_pad, H, H / K, causal,
      window, scale, split_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = (int64_t)B * S * K * HD / 4;
  flash_bwd_reduce_kernel<<<(unsigned)((n + REDUCE_THREADS - 1) / REDUCE_THREADS),
                            REDUCE_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part), reinterpret_cast<const float4*>(dv_part),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, H / K, HD / 4);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernels. dtype: 0 = float32 (hd 16, 64, 128 or 256), 1 =
// bfloat16 (hd 16). q, o, dout, dq: contiguous [B, S, H, hd]; k, v, dk, dv:
// contiguous [B, S, K, hd]; lse: float32 [B, H, S] from the forward; delta:
// float32 [B, H, S] scratch that the first kernel fills. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_cc(int dtype, const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse, void* dq,
                                      void* dk, void* dv, void* delta, int B, int S, int H,
                                      int K, int hd, int causal, int window, float scale,
                                      void* stream) {
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
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernels: bfloat16, hd 64, 128 or 256, the layouts of the
// CUDA-core entry (o contiguous and 16-byte aligned). plans: 4 * 11 int64,
// the tensor maps of q, k, v and dout (dims, byte strides, 64-row box; see
// encode_map). rows: float32 [2, B * H, ceil(S / 64) * 64] scratch; part:
// float32 [2, B, S, H, hd] scratch. split_p: a tile where some P >= split_p
// also multiplies the lo part of its bf16 A operands (0: every tile, +inf:
// none). Returns a cudaError_t.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, void* rows, void* part,
                                        int B, int S, int H, int K, int hd,
                                        const int64_t* plans, int causal, int window,
                                        float scale, float split_p, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rows);
  float* p = static_cast<float*>(part);
#define FLASH_BWD_TC(HD)                                                                  \
  return (int)launch_tc<HD>(q, k, v, o, dout, l, dq, dk, dv, r, p, B, S, H, K, plans,     \
                            causal, window, scale, split_p, st)
  if (hd == 64) FLASH_BWD_TC(64);
  if (hd == 128) FLASH_BWD_TC(128);
  if (hd == 256) FLASH_BWD_TC(256);
#undef FLASH_BWD_TC
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
