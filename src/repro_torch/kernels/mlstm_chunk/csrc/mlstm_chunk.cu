// Chunkwise-parallel stabilised mLSTM forward for Hopper (sm_90a), returning
// h and the final state (C, n, m).
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunk/kernel.py:
// mlstm_chunk_fwd (body _mlstm_kernel). Same function as its oracle
// repro.models.xlstm.mlstm_chunkwise: per (batch, head), chunks of c steps in
// order, b = cumsum(f) within the chunk, log D[j,l] = b_j - b_l + i_l (l <= j),
// m_j = max(max_l log D[j,l], b_j + m_prev), h_j = (sum_l q_j.k_l D[j,l] v_l
// + e^{b_j + m_prev - m_j} q_j C) / max(|den_j|, e^{-m_j}); then the state
// (C, n, m) moves to the end of the chunk. m starts at 0; masked entries are
// never exponentiated. Unlike the Pallas kernel, which drops its VMEM state,
// this one writes the final (C, n, m): the model's prefill caches them.
//
// Bound on H100. At the serving prefill shape (B 4, S 512, H 4, dqk 512,
// dv 1024, c 256, bf16) the function moves ~84 MB (q, k, v, h in bf16, C in
// f32): ~25 us at 3.35 TB/s; its ~20 GFLOP (causal pairs) take ~21 us at the
// bf16 tensor-core rate. Bytes and operations sit near the ridge.
//
// Two paths, chosen by dtype:
//
// * bfloat16 -> two launches on the tensor cores (wgmma, bf16 in, float32
//   accumulate), fed by TMA through mbarrier rings (common/hopper.cuh):
//   mlstm_state_kernel carries C through the chunks once per (64 dqk rows,
//   256 dv columns) tile and leaves the state at the start of every interior
//   chunk (C in bf16, n in float32) in scratch; mlstm_out_kernel then
//   computes each chunk's h independently from it, one 64-row query tile and
//   256 dv columns a block, scores recomputed once per 256-column dv slab (4
//   times at full width). The state keeps float32 accuracy: dec_k k
//   goes into the product as a bf16 pair hi + lo (one bf16 rounding of it
//   costs ~2^-9 per term, the size of the 1e-3 state tolerance). Only Q
//   C_prev reads the bf16 state, W goes to the second product in bf16, and
//   h is held to 3e-2 of max|h|. dqk up to 512, dv from 64, byte strides
//   multiples of 16 (kernels/_tma.py); ragged dqk and dv tiles are filled
//   with zeros by TMA.
// * float32 -> mlstm_chunk_kernel, float32 FMAs on CUDA cores (wgmma in
//   float32 would be TF32, which would break the 1e-4 tolerance). The carried
//   C is [dqk, dv] float32, 2 MiB per (batch, head) at full width, far
//   beyond one SM's 227 KB of shared memory. So dv is split: one block per
//   (64-column tile of dv, batch*head), 256 threads, looping over the chunks
//   in order with its [dqk, 64] tile of C (128 KB) and its own copy of n
//   [dqk] in shared memory. Per chunk:
//   1. gates: cumsum, m_intra by a direct max over l <= j (as the oracle),
//      m_j, the decays and the new m, all from the f32 gates;
//   2. per tile of 32 query rows: the causal scores q k^T (only the key rows
//      the tile can see) from 32-wide slabs of q and k in shared memory, a
//      4x8 register tile per thread; in the same pass over the q slabs,
//      q C for the block's 64 columns and q.n. W = scores * D goes to shared
//      memory; the intra denominator is sum_l W S (= q_j . n_intra[j]);
//      then W v over 32-row slabs of v, and h is written;
//   3. C = e^{..} C + (dec_k k)^T v and n likewise, over 8-row slabs.
//   Every block of a (batch, head) recomputes the gates, the scores and the
//   denominator (dv/64 times). Chunk c is any length up to 256 (the model's
//   divisor of S), dqk up to 512, dv any (the last tile masked).
// q/k/v and the f32 gates are read in the model layout [B, S, H, d] / [B, S, H]
// through strides.
//
// Tolerance. Sums run in another order than the oracle's: float32 h and
// state agree to rel 1e-4; in bf16, h agrees to 3e-2 of max|h| with the
// plain version fed the same bf16 inputs and the f32 state to 1e-3.

#include "common/hopper.cuh"   // mbarriers, TMA, wgmma (shared with flash_attention.cu)
#include "mlstm_chunk/csrc/mlstm_gates.cuh"   // chunk_gates, next_m (shared with the backward)
namespace {

constexpr int THREADS = 256;
constexpr int TV = 64;            // dv columns per block
constexpr int RJ = 32;            // query rows per row tile
constexpr int DK = 32;            // dqk slab of the score pass
constexpr int LS = 32;            // v rows per slab of the W v pass
constexpr int LC = 8;             // rows per slab of the state update
constexpr int MAX_C = 256;        // longest chunk
constexpr int MAX_DQK = 512;
constexpr int WLD = MAX_C + 1;    // padded row of W (conflict-free reads)
constexpr int NRED = 32;
constexpr float NEG_INF = -1e30f;


__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// the union of the three passes' slabs, rounded up to a float4
__host__ __device__ constexpr int scratch_floats(int dqk) {
  return (imax(imax(RJ * (DK + 1) + MAX_C * (DK + 1), LS * TV), LC * dqk + LC * TV) + 3) & ~3;
}

size_t smem_bytes(int dqk) {
  const int floats = dqk * TV + scratch_floats(dqk) + RJ * WLD + dqk + 7 * MAX_C + RJ + NRED;
  return (size_t)floats * sizeof(float);
}

// this thread's 8 columns of a 64-wide tile: two float4s, 32 apart, so that
// the eight threads of a quarter-warp read 32 consecutive floats
__device__ __forceinline__ int tile_col(int t, int i) {
  return (i < 4 ? 0 : 32) + (t & 7) * 4 + (i & 3);
}

__global__ void __launch_bounds__(THREADS, 1)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, float* __restrict__ h,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int H, int dqk, int dv, int c,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t i_sb, int64_t i_ss, int64_t i_sh,
                   int64_t f_sb, int64_t f_ss, int64_t f_sh,
                   int64_t h_sb, int64_t h_ss, int64_t h_sh) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                          // [dqk][TV]   state tile
  float* scr = Cs + dqk * TV;                // slabs (union)
  float* Ws = scr + scratch_floats(dqk);     // [RJ][WLD]   W = S * D
  float* ns = Ws + RJ * WLD;                 // [dqk]       state n
  float* bs = ns + dqk;                      // [MAX_C]     cumsum of f
  float* is = bs + MAX_C;                    // [MAX_C]     i gates
  float* fs = is + MAX_C;                    // [MAX_C]     f gates
  float* mjs = fs + MAX_C;                   // [MAX_C]     m_j
  float* decq = mjs + MAX_C;                 // [MAX_C]     e^{m_inter - m_j}
  float* deck = decq + MAX_C;                // [MAX_C]     e^{g_l - m_state}
  float* floors = deck + MAX_C;              // [MAX_C]     e^{-m_j}
  float* dens = floors + MAX_C;              // [RJ]        intra denominators
  float* red = dens + RJ;                    // [NRED]      block reduction
  float* Qs = scr;                           // [RJ][DK+1]
  float* Ks = scr + RJ * (DK + 1);           // [MAX_C][DK+1]
  float* Vs = scr;                           // [LS][TV]
  float* Kc = scr;                           // [LC][dqk]   dec_k * k
  float* Vc = scr + LC * dqk;                // [LC][TV]

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, hh = bh % H;
  const int tv0 = tile * TV;
  const float* qb = q + b * q_sb + hh * q_sh;
  const float* kb = k + b * k_sb + hh * k_sh;
  const float* vb = v + b * v_sb + hh * v_sh;
  const float* ib = ig + b * i_sb + hh * i_sh;
  const float* fb = fg + b * f_sb + hh * f_sh;
  float* hb = h + b * h_sb + hh * h_sh;

  // score pass: rows rg*4 + r, key columns cg + 32*kk
  const int rg = t >> 5, cg = t & 31;
  // h pass: row hr, columns tile_col(t, i)
  const int hr = t >> 3;

  for (int e = t; e < dqk * TV; e += THREADS) Cs[e] = 0.f;
  for (int e = t; e < dqk; e += THREADS) ns[e] = 0.f;
  float m_prev = 0.f;

  const int n_chunks = S / c;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int64_t s0 = (int64_t)chunk * c;
    __syncthreads();                       // previous chunk's state is written
    if (t < c) {
      is[t] = ib[(s0 + t) * i_ss];
      fs[t] = fb[(s0 + t) * f_ss];
    }
    __syncthreads();
    if (t == 0) {
      float acc = 0.f;
      for (int l = 0; l < c; ++l) {
        acc += fs[l];
        bs[l] = acc;
      }
    }
    __syncthreads();
    const float btot = bs[c - 1];
    float g = NEG_INF;                     // btot - b_l + i_l of row l = t
    if (t < c) {
      const float bj = bs[t];
      float m_intra = NEG_INF;
      for (int l = 0; l <= t; ++l) m_intra = fmaxf(m_intra, bj - bs[l] + is[l]);
      const float m_inter = bj + m_prev;
      const float mj = fmaxf(m_intra, m_inter);
      mjs[t] = mj;
      decq[t] = expf(m_inter - mj);
      floors[t] = expf(-mj);
      g = btot - bj + is[t];
    }
    float gmax = g;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
    if ((t & 31) == 0) red[t >> 5] = gmax;
    __syncthreads();
    if (t == 0) {
      float a = red[0];
      for (int w = 1; w < THREADS / 32; ++w) a = fmaxf(a, red[w]);
      red[THREADS / 32] = a;
    }
    __syncthreads();
    const float m_state = fmaxf(btot + m_prev, red[THREADS / 32]);
    const float decay = expf(btot + m_prev - m_state);
    if (t < c) deck[t] = expf(g - m_state);

    for (int j0 = 0; j0 < c; j0 += RJ) {
      const int lpad = j0 + RJ;            // key rows this tile can see, padded
      float sc[4][8];
      float hi[8];
      float ni = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) sc[r][kk] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) hi[i] = 0.f;

      for (int d0 = 0; d0 < dqk; d0 += DK) {
        const int dk = min(DK, dqk - d0);
        __syncthreads();                   // previous slabs consumed
        for (int e = t; e < RJ * DK; e += THREADS) {
          const int r = e / DK, d = e % DK, j = j0 + r;
          Qs[r * (DK + 1) + d] = (j < c && d < dk) ? qb[(s0 + j) * q_ss + d0 + d] : 0.f;
        }
        for (int e = t; e < lpad * DK; e += THREADS) {
          const int l = e / DK, d = e % DK;
          Ks[l * (DK + 1) + d] = (l < c && d < dk) ? kb[(s0 + l) * k_ss + d0 + d] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < DK; ++d) {
          float qv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) qv[r] = Qs[(rg * 4 + r) * (DK + 1) + d];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk * 32 < lpad) {
              const float kv = Ks[(cg + 32 * kk) * (DK + 1) + d];
#pragma unroll
              for (int r = 0; r < 4; ++r) sc[r][kk] = fmaf(qv[r], kv, sc[r][kk]);
            }
          }
        }
        for (int d = 0; d < dk; ++d) {
          const float qv = Qs[hr * (DK + 1) + d];
          const float* crow = Cs + (d0 + d) * TV;
          const float4 c0 = *reinterpret_cast<const float4*>(crow + tile_col(t, 0));
          const float4 c1 = *reinterpret_cast<const float4*>(crow + tile_col(t, 4));
          hi[0] = fmaf(qv, c0.x, hi[0]); hi[1] = fmaf(qv, c0.y, hi[1]);
          hi[2] = fmaf(qv, c0.z, hi[2]); hi[3] = fmaf(qv, c0.w, hi[3]);
          hi[4] = fmaf(qv, c1.x, hi[4]); hi[5] = fmaf(qv, c1.y, hi[5]);
          hi[6] = fmaf(qv, c1.z, hi[6]); hi[7] = fmaf(qv, c1.w, hi[7]);
          ni = fmaf(qv, ns[d0 + d], ni);
        }
      }

      // W = S * D (0 above the diagonal) and the intra denominator sum W S;
      // a warp holds four whole rows
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rg * 4 + r, j = j0 + row;
        const bool jv = j < c;
        const float bj = jv ? bs[j] : 0.f, mj = jv ? mjs[j] : 0.f;
        float dsum = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk * 32 < lpad) {
            const int l = cg + 32 * kk;
            float w = 0.f;
            if (jv && l <= j) {
              w = sc[r][kk] * expf(bj - bs[l] + is[l] - mj);
              dsum = fmaf(w, sc[r][kk], dsum);
            }
            Ws[row * WLD + l] = w;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
        if (cg == 0) dens[row] = dsum;
      }

      float ha[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ha[i] = 0.f;
      for (int l0 = 0; l0 < lpad; l0 += LS) {
        __syncthreads();                   // W written; previous slab consumed
        for (int e = t; e < LS * TV; e += THREADS) {
          const int l = e / TV, col = e % TV, ll = l0 + l, gcol = tv0 + col;
          Vs[e] = (ll < c && gcol < dv) ? vb[(s0 + ll) * v_ss + gcol] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int l = 0; l < LS; ++l) {
          const float w = Ws[hr * WLD + l0 + l];
          const float4 a0 = *reinterpret_cast<const float4*>(Vs + l * TV + tile_col(t, 0));
          const float4 a1 = *reinterpret_cast<const float4*>(Vs + l * TV + tile_col(t, 4));
          ha[0] = fmaf(w, a0.x, ha[0]); ha[1] = fmaf(w, a0.y, ha[1]);
          ha[2] = fmaf(w, a0.z, ha[2]); ha[3] = fmaf(w, a0.w, ha[3]);
          ha[4] = fmaf(w, a1.x, ha[4]); ha[5] = fmaf(w, a1.y, ha[5]);
          ha[6] = fmaf(w, a1.z, ha[6]); ha[7] = fmaf(w, a1.w, ha[7]);
        }
      }

      const int j = j0 + hr;
      if (j < c) {
        const float dq = decq[j];
        const float den = fmaxf(fabsf(dens[hr] + ni * dq), floors[j]);
        float* hrow = hb + (s0 + j) * h_ss;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int gcol = tv0 + tile_col(t, i);
          if (gcol < dv) hrow[gcol] = (ha[i] + hi[i] * dq) / den;
        }
      }
    }

    // state update: C = decay C + (dec_k k)^T v, n = decay n + sum_l dec_k k
    for (int l0 = 0; l0 < c; l0 += LC) {
      __syncthreads();                     // previous slab (or h pass) done
      for (int e = t; e < LC * dqk; e += THREADS) {
        const int l = e / dqk, d = e % dqk, ll = l0 + l;
        Kc[e] = ll < c ? deck[ll] * kb[(s0 + ll) * k_ss + d] : 0.f;
      }
      for (int e = t; e < LC * TV; e += THREADS) {
        const int l = e / TV, col = e % TV, ll = l0 + l, gcol = tv0 + col;
        Vc[e] = (ll < c && gcol < dv) ? vb[(s0 + ll) * v_ss + gcol] : 0.f;
      }
      __syncthreads();
      const float scale = l0 == 0 ? decay : 1.f;
      float vr[LC][8];
#pragma unroll
      for (int l = 0; l < LC; ++l) {
        const float4 a0 = *reinterpret_cast<const float4*>(Vc + l * TV + tile_col(t, 0));
        const float4 a1 = *reinterpret_cast<const float4*>(Vc + l * TV + tile_col(t, 4));
        vr[l][0] = a0.x; vr[l][1] = a0.y; vr[l][2] = a0.z; vr[l][3] = a0.w;
        vr[l][4] = a1.x; vr[l][5] = a1.y; vr[l][6] = a1.z; vr[l][7] = a1.w;
      }
      for (int d = t >> 3; d < dqk; d += THREADS / 8) {
        float4* c0p = reinterpret_cast<float4*>(Cs + d * TV + tile_col(t, 0));
        float4* c1p = reinterpret_cast<float4*>(Cs + d * TV + tile_col(t, 4));
        const float4 c0 = *c0p, c1 = *c1p;
        float cv[8] = {c0.x * scale, c0.y * scale, c0.z * scale, c0.w * scale,
                       c1.x * scale, c1.y * scale, c1.z * scale, c1.w * scale};
#pragma unroll
        for (int l = 0; l < LC; ++l) {
          const float kd = Kc[l * dqk + d];
#pragma unroll
          for (int i = 0; i < 8; ++i) cv[i] = fmaf(kd, vr[l][i], cv[i]);
        }
        *c0p = make_float4(cv[0], cv[1], cv[2], cv[3]);
        *c1p = make_float4(cv[4], cv[5], cv[6], cv[7]);
      }
      for (int d = t; d < dqk; d += THREADS) {
        float a = ns[d] * scale;
#pragma unroll
        for (int l = 0; l < LC; ++l) a += Kc[l * dqk + d];
        ns[d] = a;
      }
    }
    m_prev = m_state;
  }

  __syncthreads();
  float* cb = c_out + (int64_t)bh * dqk * dv;
  for (int e = t; e < dqk * TV; e += THREADS) {
    const int d = e / TV, gcol = tv0 + e % TV;
    if (gcol < dv) cb[(int64_t)d * dv + gcol] = Cs[e];
  }
  if (tile == 0) {
    for (int d = t; d < dqk; d += THREADS) n_out[(int64_t)bh * dqk + d] = ns[d];
    if (t == 0) m_out[bh] = m_prev;
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* ig,
                       const float* fg, void* h, float* c_out, float* n_out, float* m_out,
                       int B, int S, int H, int dqk, int dv, int c, const int64_t* qs,
                       const int64_t* ks, const int64_t* vs, const int64_t* is,
                       const int64_t* fs, const int64_t* hs, cudaStream_t stream) {
  const size_t smem = smem_bytes(dqk);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dv + TV - 1) / TV, B * H);
  mlstm_chunk_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ig, fg, static_cast<float*>(h), c_out, n_out, m_out, S,
      H, dqk, dv, c, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      is[0], is[1], is[2], fs[0], fs[1], fs[2], hs[0], hs[1], hs[2]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: a state pass and an output pass on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64;                    // dqk rows of a state tile; query rows of an output tile
constexpr int TC_NV = 256;                   // dv columns of a tile (wgmma N)
constexpr int TC_SLAB = 64;                  // chunk rows a state-pass stage holds
constexpr int TC_WG = 128;                   // threads in a warpgroup
constexpr int TC_THREADS = TC_WG + 32;       // the consumer warpgroup and a producer warp
constexpr int BOX_BYTES = 64 * 128;          // one [64 rows x 64 columns] bf16 TMA box
constexpr int PLAN = TMA_PLAN_VALUES;        // int64 values of one tensor-map plan
constexpr int ST_STAGES = 4;
constexpr int ST_STAGE_BYTES = 6 * BOX_BYTES;    // k (scaled, hi), its lo part, 4 boxes of v
constexpr int OUT_STAGES = 4;
constexpr int OUT_STAGE_BYTES = 4 * BOX_BYTES;   // 4 boxes: C slab, K quarter or V tile
constexpr int Q_BYTES = MAX_DQK / 64 * BOX_BYTES;

// byte offsets from the 1024-aligned base of the dynamic shared memory
struct StateLayout {
  static constexpr int F_OFF = ST_STAGES * ST_STAGE_BYTES;      // floats
  static constexpr int FLOATS = 3 * MAX_C + 4 + 16 * 64;        // b, i, dec_k, scalars, n sums
  static constexpr int BAR_OFF = F_OFF + 4 * FLOATS;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * ST_STAGES + 1024;
};
struct OutLayout {
  static constexpr int RING_OFF = Q_BYTES;
  static constexpr int F_OFF = RING_OFF + OUT_STAGES * OUT_STAGE_BYTES;
  static constexpr int FLOATS = 3 * MAX_C + MAX_DQK + 4 * TC_BM;  // b, i, a, n_prev, row terms
  static constexpr int BAR_OFF = F_OFF + 4 * FLOATS;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * OUT_STAGES) + 1024;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the consumer warpgroup only
}

// State pass. Grid (ceil(dv / 256), ceil(dqk / 64), B * H): a block carries the
// [64 dqk rows x 256 dv columns] tile of C as a wgmma accumulator (m64n256,
// float32, 128 registers a thread) through the chunks in order. Per chunk:
// the gates (one warp), C at the chunk's start written as bf16 to c_scr for
// the output pass (chunks 1 .. nc - 1), C *= e^{btot + m_prev - m_state}, then
// C += (dec_k k)^T v over 64-row slabs fed by TMA through a 4-stage ring:
// the consumers scale each k row by dec_k in shared memory after it lands
// (the 128-byte swizzle moves whole 16-byte chunks within a row, so a row
// scale ignores it), split it into bf16 hi + lo, and run both against the
// slab of v (kT as the MN-major A operand, v as the MN-major B). Rows past
// the chunk get dec_k = 0. The dv-tile-0 blocks also keep n in float32 on
// CUDA cores and write it (n_scr per interior chunk, n_out at the end) and m.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_state_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, __nv_bfloat16* __restrict__ c_scr,
                   float* __restrict__ n_scr, int H, int dqk, int dv, int c, int n_chunks,
                   int64_t i_sb, int64_t i_ss, int64_t i_sh,
                   int64_t f_sb, int64_t f_ss, int64_t f_sh) {
  using L = StateLayout;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* s_b = reinterpret_cast<float*>(gbase + L::F_OFF);   // [MAX_C]
  float* s_i = s_b + MAX_C;                                  // [MAX_C]
  float* s_dk = s_i + MAX_C;                                 // [MAX_C] dec_k, 0 past c
  float* s_scal = s_dk + MAX_C;                              // decay, m_state
  float* s_nsum = s_scal + 4;                                // [16][64]
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * ST_STAGES;

  const int e0 = blockIdx.x * TC_NV, d0 = blockIdx.y * TC_BM, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int slabs = (c + TC_SLAB - 1) / TC_SLAB;
  const int nvb = min(4, (dv - e0 + 63) / 64);              // v boxes inside dv
  const bool keeps_n = blockIdx.x == 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, TC_WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_WG) {
    if (threadIdx.x != TC_WG) return;
    int item = 0;
    for (int t = 0; t < n_chunks; ++t) {
      for (int i = 0; i < slabs; ++i, ++item) {
        const int s = item % ST_STAGES;
        if (item >= ST_STAGES) mbar_wait(empty0 + 8 * s, ((item / ST_STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, st = base + s * ST_STAGE_BYTES;
        mbar_expect_tx(full, (1 + nvb) * BOX_BYTES);
        const int row = t * c + i * TC_SLAB;
        tma_load_4d(st, &tm_k, full, d0, h, row, b);
        for (int a = 0; a < nvb; ++a)
          tma_load_4d(st + (2 + a) * BOX_BYTES, &tm_v, full, e0 + 64 * a, h, row, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int cc = tid % 8;                  // the 16-byte chunk of k this thread scales
  const float* ib = ig + b * i_sb + h * i_sh;
  const float* fb = fg + b * f_sb + h * f_sh;

  float acc[TC_NV / 2];
#pragma unroll
  for (int i = 0; i < TC_NV / 2; ++i) acc[i] = 0.f;
  float n_part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m_prev = 0.f;

  // n of this block's 64 dqk rows: the 16 threads of each chunk sum their parts
  auto reduce_n = [&](float* dst) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s_nsum[(tid / 8) * 64 + cc * 8 + e] = n_part[e];
    consumer_sync();
    if (tid < 64 && d0 + tid < dqk) {
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += s_nsum[r * 64 + tid];
      dst[d0 + tid] = sum;
    }
    consumer_sync();
  };

  int item = 0;
  for (int t = 0; t < n_chunks; ++t) {
    if (warp == 0) {
      const float btot = chunk_gates(ib, fb, i_ss, f_ss, (int64_t)t * c, c, s_b, s_i, lane);
      const float m_state = next_m(s_b, s_i, c, btot, m_prev, lane);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = 8 * lane + u;
        s_dk[r] = r < c ? expf(btot - s_b[r] + s_i[r] - m_state) : 0.f;
      }
      if (lane == 0) {
        s_scal[0] = expf(btot + m_prev - m_state);
        s_scal[1] = m_state;
      }
    }
    consumer_sync();
    const float decay = s_scal[0], m_state = s_scal[1];

    if (t > 0) {                           // the state at the start of chunk t
      const int64_t slot = (int64_t)bh * (n_chunks - 1) + t - 1;
      __nv_bfloat16* cs = c_scr + slot * dqk * dv;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = d0 + r0 + 8 * half;
        if (d >= dqk) continue;
#pragma unroll
        for (int i = 0; i < TC_NV / 8; ++i) {
          const int col = e0 + 8 * i + cq;
          if (col < dv)
            *reinterpret_cast<__nv_bfloat162*>(cs + (int64_t)d * dv + col) =
                __floats2bfloat162_rn(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
        }
      }
      if (keeps_n) reduce_n(n_scr + slot * dqk);
    }
#pragma unroll
    for (int i = 0; i < TC_NV / 2; ++i) acc[i] *= decay;
#pragma unroll
    for (int e = 0; e < 8; ++e) n_part[e] *= decay;

    for (int i = 0; i < slabs; ++i, ++item) {
      const int s = item % ST_STAGES;
      mbar_wait(full0 + 8 * s, (item / ST_STAGES) & 1);
      unsigned char* kst = gbase + s * ST_STAGE_BYTES;
      for (int rr = tid / 8; rr < TC_SLAB; rr += TC_WG / 8) {
        const float dk = s_dk[i * TC_SLAB + rr];
        const int off = rr * 128 + ((cc ^ (rr & 7)) * 16);
        float x[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(kst + off), x);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float a = x[e] * dk, bb = x[e + 1] * dk;
          n_part[e] += a;
          n_part[e + 1] += bb;
          const __nv_bfloat162 hv = __floats2bfloat162_rn(a, bb);
          const float2 hf = __bfloat1622float2(hv);
          const __nv_bfloat162 lv = __floats2bfloat162_rn(a - hf.x, bb - hf.y);
          hi[e / 2] = *reinterpret_cast<const uint32_t*>(&hv);
          lo[e / 2] = *reinterpret_cast<const uint32_t*>(&lv);
        }
        *reinterpret_cast<uint4*>(kst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(kst + BOX_BYTES + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();

      const uint32_t st = base + s * ST_STAGE_BYTES;
      fence_regs<TC_NV / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TC_SLAB / 16; ++j) {
        const uint64_t dv_ = smem_desc(st + 2 * BOX_BYTES + j * 16 * 128, BOX_BYTES / 16, 64);
        wgmma_ss_n256<1, 1>(acc, smem_desc(st + j * 16 * 128, BOX_BYTES / 16, 64), dv_, 1);
        wgmma_ss_n256<1, 1>(acc, smem_desc(st + BOX_BYTES + j * 16 * 128, BOX_BYTES / 16, 64),
                            dv_, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<TC_NV / 2>(acc);
      mbar_arrive(empty0 + 8 * s);
    }
    m_prev = m_state;
  }

  float* cb = c_out + (int64_t)bh * dqk * dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = d0 + r0 + 8 * half;
    if (d >= dqk) continue;
#pragma unroll
    for (int i = 0; i < TC_NV / 8; ++i) {
      const int col = e0 + 8 * i + cq;
      if (col < dv)
        *reinterpret_cast<float2*>(cb + (int64_t)d * dv + col) =
            make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
  if (keeps_n) {
    reduce_n(n_out + (int64_t)bh * dqk);
    if (blockIdx.y == 0 && tid == 0) m_out[bh] = m_prev;
  }
}

// Output pass. Grid (n_chunks * ceil(c / 64), ceil(dv / 256), B * H): a block
// owns 64 query rows j0.. of chunk t and 256 columns of dv, and keeps one
// m64n256 float32 accumulator O. Its Q tile (64 x dqk, up to 64 KB) arrives
// once through TMA; C_prev slabs (64 dqk rows x 256), K quarters (64 keys x
// 256 dqk) and V tiles (64 keys x 256) stream through a 4-stage ring.
//   1. gates (one warp): m_prev by re-running the state recurrence over the
//      earlier chunks' gates; b, a_l = i_l - b_l and its prefix max give
//      m_j = b_j + max(prefix max, m_prev) without the c x c matrix;
//   2. chunk t > 0: O = Q C_prev (wgmma, from the bf16 state), O *= dec_q;
//      q . n_prev on CUDA cores; chunk 0 has C_prev = 0 and m_prev = 0;
//   3. per 64-key tile up to the diagonal: S = Q K^T (wgmma m64n64, over dqk),
//      W = S e^{a_l - (m_j - b_j)} on l <= j < c from each register's (row,
//      column) in the m64nN fragment layout, the row sums of W S (the
//      reference's q . n_intra) in float32, W packed to bf16 A registers,
//      O += W V (wgmma m64n256, V MN-major);
//   4. h = O / max(|sum W S + dec_q q . n_prev|, e^{-m_j}) in bf16.
__global__ void __launch_bounds__(TC_THREADS, 1)
mlstm_out_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ ig, const float* __restrict__ fg,
                 const float* __restrict__ n_scr, __nv_bfloat16* __restrict__ hout,
                 int H, int dqk, int dv, int c, int n_chunks,
                 int64_t i_sb, int64_t i_ss, int64_t i_sh,
                 int64_t f_sb, int64_t f_ss, int64_t f_sh,
                 int64_t h_sb, int64_t h_ss, int64_t h_sh) {
  using L = OutLayout;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* s_b = reinterpret_cast<float*>(gbase + L::F_OFF);   // [MAX_C]
  float* s_i = s_b + MAX_C;                                  // [MAX_C]
  float* s_a = s_i + MAX_C;                                  // [MAX_C] i_l - b_l
  float* s_n = s_a + MAX_C;                                  // [MAX_DQK] n_prev
  float* s_z = s_n + MAX_DQK;                                // [64] m_j - b_j
  float* s_decq = s_z + TC_BM;                               // [64] e^{m_prev - z_j}
  float* s_floor = s_decq + TC_BM;                           // [64] e^{-m_j}
  float* s_qn = s_floor + TC_BM;                             // [64] q_j . n_prev
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * OUT_STAGES;

  const int nq = (c + TC_BM - 1) / TC_BM;
  const int t = blockIdx.x / nq, j0 = (blockIdx.x % nq) * TC_BM;
  const int e0 = blockIdx.y * TC_NV, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int64_t s0 = (int64_t)t * c;
  const int na = (dqk + 63) / 64;                 // 64-column atoms of q and k
  const int nk_items = (na + 3) / 4;              // ring items of one K tile
  const int nvb = min(4, (dv - e0 + 63) / 64);    // V / C_prev boxes inside dv
  const int n_kt = j0 / 64 + 1;                   // key tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < OUT_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, TC_WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_WG) {
    if (threadIdx.x != TC_WG) return;
    mbar_expect_tx(q_full, na * BOX_BYTES);
    for (int a = 0; a < na; ++a)
      tma_load_4d(base + a * BOX_BYTES, &tm_q, q_full, 64 * a, h, (int)s0 + j0, b);
    int item = 0;
    auto stage = [&](int boxes) {
      const int s = item % OUT_STAGES;
      if (item >= OUT_STAGES) mbar_wait(empty0 + 8 * s, ((item / OUT_STAGES) & 1) ^ 1);
      mbar_expect_tx(full0 + 8 * s, boxes * BOX_BYTES);
      ++item;
      return s;
    };
    if (t > 0) {
      const int slot = bh * (n_chunks - 1) + t - 1;
      for (int sl = 0; sl < na; ++sl) {
        const int s = stage(nvb);
        for (int a = 0; a < nvb; ++a)
          tma_load_4d(base + L::RING_OFF + s * OUT_STAGE_BYTES + a * BOX_BYTES, &tm_c,
                      full0 + 8 * s, e0 + 64 * a, 0, 64 * sl, slot);
      }
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int row = (int)s0 + 64 * kt;
      for (int u = 0; u < nk_items; ++u) {
        const int nb = min(4, na - 4 * u);
        const int s = stage(nb);
        for (int a = 0; a < nb; ++a)
          tma_load_4d(base + L::RING_OFF + s * OUT_STAGE_BYTES + a * BOX_BYTES, &tm_k,
                      full0 + 8 * s, 64 * (4 * u + a), h, row, b);
      }
      const int s = stage(nvb);
      for (int a = 0; a < nvb; ++a)
        tma_load_4d(base + L::RING_OFF + s * OUT_STAGE_BYTES + a * BOX_BYTES, &tm_v,
                    full0 + 8 * s, e0 + 64 * a, h, row, b);
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);

  // 1. gates
  if (warp == 0) {
    const float* ib = ig + b * i_sb + h * i_sh;
    const float* fb = fg + b * f_sb + h * f_sh;
    float m_prev = 0.f;
    for (int u = 0; u < t; ++u) {
      const float btot = chunk_gates(ib, fb, i_ss, f_ss, (int64_t)u * c, c, s_b, s_i, lane);
      m_prev = next_m(s_b, s_i, c, btot, m_prev, lane);
    }
    chunk_gates(ib, fb, i_ss, f_ss, s0, c, s_b, s_i, lane);
    float zs[8];
    chunk_stabilisers(s_b, s_i, c, m_prev, lane, zs);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = 8 * lane + u;
      s_a[r] = r < c ? s_i[r] - s_b[r] : 0.f;
      const int rr = r - j0;
      if (rr >= 0 && rr < TC_BM) {
        const float z = zs[u];                                // m_j - b_j
        s_z[rr] = z;
        s_decq[rr] = expf(m_prev - z);
        s_floor[rr] = expf(-(s_b[rr + j0] + z));
      }
    }
  }
  if (t > 0)
    for (int d = tid; d < na * 64; d += TC_WG)
      s_n[d] = d < dqk ? n_scr[((int64_t)bh * (n_chunks - 1) + t - 1) * dqk + d] : 0.f;
  consumer_sync();

  mbar_wait(q_full, 0);
  if (t > 0) {                             // q . n_prev: two threads a row
    const int r = tid / 2, hh = tid % 2;
    float qn = 0.f;
    for (int a = 0; a < na; ++a) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ch = 4 * hh + u;
        float x[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(
                            gbase + a * BOX_BYTES + r * 128 + ((ch ^ (r & 7)) * 16)), x);
        const float* nn = s_n + a * 64 + ch * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) qn = fmaf(x[e], nn[e], qn);
      }
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    if (hh == 0) s_qn[r] = qn;
  }
  consumer_sync();

  float z[2], dq[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    z[half] = s_z[r0 + 8 * half];
    dq[half] = s_decq[r0 + 8 * half];
  }

  float acc[TC_NV / 2];
#pragma unroll
  for (int i = 0; i < TC_NV / 2; ++i) acc[i] = 0.f;
  int item = 0;

  // 2. O = dec_q (Q C_prev)
  if (t > 0) {
    for (int sl = 0; sl < na; ++sl, ++item) {
      const int s = item % OUT_STAGES;
      mbar_wait(full0 + 8 * s, (item / OUT_STAGES) & 1);
      const uint32_t cs = base + L::RING_OFF + s * OUT_STAGE_BYTES;
      fence_regs<TC_NV / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss_n256<0, 1>(acc, smem_desc(base + sl * BOX_BYTES + j * 32, 1, 64),
                            smem_desc(cs + j * 16 * 128, BOX_BYTES / 16, 64), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<TC_NV / 2>(acc);
      mbar_arrive(empty0 + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < TC_NV / 2; ++i) acc[i] *= dq[(i % 4) / 2];
  }

  // 3. the intra-chunk terms, key tile by key tile
  float den[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    for (int u = 0; u < nk_items; ++u, ++item) {
      const int s = item % OUT_STAGES;
      mbar_wait(full0 + 8 * s, (item / OUT_STAGES) & 1);
      const uint32_t ks = base + L::RING_OFF + s * OUT_STAGE_BYTES;
      const int nkk = 4 * min(4, na - 4 * u);
      fence_regs<32>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        if (kk >= nkk) break;
        const int g = 16 * u + kk;                 // k16 step over dqk
        wgmma_ss_n64(sc, smem_desc(base + (g / 4) * BOX_BYTES + (g % 4) * 32, 1, 64),
                     smem_desc(ks + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 1, 64), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);
      mbar_arrive(empty0 + 8 * s);
    }

    // W = S e^{a_l - z_j} on l <= j < c, and the row sums of W S
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i % 4) / 2;
      const int j = j0 + r0 + 8 * half;
      const int l = 64 * kt + 8 * (i / 4) + cq + (i % 2);
      const float w = (l <= j && j < c) ? sc[i] * expf(s_a[l] - z[half]) : 0.f;
      den[half] = fmaf(w, sc[i], den[half]);
      sc[i] = w;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      pa[jj][0] = pack_bf16(sc[8 * jj + 0], sc[8 * jj + 1]);
      pa[jj][1] = pack_bf16(sc[8 * jj + 2], sc[8 * jj + 3]);
      pa[jj][2] = pack_bf16(sc[8 * jj + 4], sc[8 * jj + 5]);
      pa[jj][3] = pack_bf16(sc[8 * jj + 6], sc[8 * jj + 7]);
    }

    const int s = item % OUT_STAGES;
    mbar_wait(full0 + 8 * s, (item / OUT_STAGES) & 1);
    const uint32_t vs = base + L::RING_OFF + s * OUT_STAGE_BYTES;
    fence_regs<TC_NV / 2>(acc);
    fence_regs<16>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wgmma_rs_n256(acc, pa[jj], smem_desc(vs + jj * 16 * 128, BOX_BYTES / 16, 64));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<TC_NV / 2>(acc);
    mbar_arrive(empty0 + 8 * s);
    ++item;
  }

  // 4. h = O / max(|den|, e^{-m_j}); rows past the chunk are not written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 1);
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half, j = j0 + row;
    if (j >= c) continue;
    const float qn = t > 0 ? s_qn[row] : 0.f;
    const float inv = 1.f / fmaxf(fabsf(den[half] + qn * dq[half]), s_floor[row]);
    __nv_bfloat16* hrow = hout + b * h_sb + (s0 + j) * h_ss + h * h_sh;
#pragma unroll
    for (int i = 0; i < TC_NV / 8; ++i) {
      const int col = e0 + 8 * i + cq;
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(hrow + col) = __floats2bfloat162_rn(
            acc[4 * i + 2 * half] * inv, acc[4 * i + 2 * half + 1] * inv);
    }
  }
}

// Encodes the four tensor maps and launches both passes on one stream.
// args: the plans of q, k, v (64-row boxes) and of c_scr viewed as
// [B * H * (nc - 1), dqk, 1, dv] (PLAN values each; zeros when nc = 1), then
// the element strides (batch, seq, head) of i, f and h.
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* ig,
                        const float* fg, void* h, float* c_out, float* n_out, float* m_out,
                        void* c_scr, float* n_scr, int B, int S, int H, int dqk, int dv,
                        int c, const int64_t* args, cudaStream_t stream) {
  const int n_chunks = S / c, BH = B * H;
  CUtensorMap tm_q, tm_k, tm_v, tm_c = {};
  cudaError_t err;
  if ((err = encode_map(&tm_q, q, args, dqk, H, S, B, TC_BM)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_k, k, args + PLAN, dqk, H, S, B, TC_BM)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_v, v, args + 2 * PLAN, dv, H, S, B, TC_BM)) != cudaSuccess)
    return err;
  if (n_chunks > 1 && (err = encode_map(&tm_c, c_scr, args + 3 * PLAN, dv, 1, dqk,
                                        BH * (n_chunks - 1), TC_BM)) != cudaSuccess)
    return err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  static uint64_t configured = 0;                 // once per device
  if (!(configured >> device & 1)) {
    if ((err = cudaFuncSetAttribute(mlstm_state_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    StateLayout::BYTES)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(mlstm_out_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    OutLayout::BYTES)) != cudaSuccess)
      return err;
    configured |= 1ull << device;
  }
  const int64_t* is = args + 4 * PLAN;
  const int64_t* fs = is + 3;
  const int64_t* hs = fs + 3;
  const int n_dv = (dv + TC_NV - 1) / TC_NV;
  mlstm_state_kernel<<<dim3(n_dv, (dqk + TC_BM - 1) / TC_BM, BH), TC_THREADS,
                       StateLayout::BYTES, stream>>>(
      tm_k, tm_v, ig, fg, c_out, n_out, m_out, static_cast<__nv_bfloat16*>(c_scr), n_scr, H,
      dqk, dv, c, n_chunks, is[0], is[1], is[2], fs[0], fs[1], fs[2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_out_kernel<<<dim3(n_chunks * ((c + TC_BM - 1) / TC_BM), n_dv, BH), TC_THREADS,
                     OutLayout::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_c, ig, fg, n_scr, static_cast<__nv_bfloat16*>(h), H, dqk, dv, c,
      n_chunks, is[0], is[1], is[2], fs[0], fs[1], fs[2], hs[0], hs[1], hs[2]);
  return cudaGetLastError();
}

}  // namespace

// float32 q, k, v and h; float32 gates. Strides are in elements, ordered
// (batch, seq, head); the last dim of q, k, v and h must be contiguous. c
// divides S and is at most 256. The state outputs are contiguous float32:
// C [B,H,dqk,dv], n [B,H,dqk], m [B,H]. Returns a cudaError_t.
extern "C" int mlstm_chunk_fwd_f32(const void* q, const void* k, const void* v,
                                   const float* ig, const float* fg, void* h, float* c_out,
                                   float* n_out, float* m_out, int B, int S, int H, int dqk,
                                   int dv, int c, const int64_t* q_strides,
                                   const int64_t* k_strides, const int64_t* v_strides,
                                   const int64_t* i_strides, const int64_t* f_strides,
                                   const int64_t* h_strides, void* stream) {
  if (c <= 0 || c > MAX_C || S <= 0 || S % c != 0 || dqk <= 0 || dqk > MAX_DQK ||
      dv <= 0 || B * H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32(q, k, v, ig, fg, h, c_out, n_out, m_out, B, S, H, dqk, dv, c,
                         q_strides, k_strides, v_strides, i_strides, f_strides, h_strides,
                         static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v and h; float32 gates and state. c_scr: bf16 [B * H *
// (S / c - 1), dqk, dv] and n_scr: float32 [B * H * (S / c - 1), dqk], the
// state at the start of each interior chunk (unused when S = c). args: 4 *
// 11 + 9 int64, see launch_bf16. Returns a cudaError_t.
extern "C" int mlstm_chunk_fwd_bf16(const void* q, const void* k, const void* v,
                                    const float* ig, const float* fg, void* h, float* c_out,
                                    float* n_out, float* m_out, void* c_scr, float* n_scr,
                                    int B, int S, int H, int dqk, int dv, int c,
                                    const int64_t* args, void* stream) {
  if (c <= 0 || c > MAX_C || S <= 0 || S % c != 0 || dqk < 64 || dqk > MAX_DQK ||
      dv < 64 || B * H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(q, k, v, ig, fg, h, c_out, n_out, m_out, c_scr, n_scr, B, S, H,
                          dqk, dv, c, args, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
