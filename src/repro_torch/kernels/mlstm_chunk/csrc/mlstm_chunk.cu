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
// Design. The carried C is [dqk, dv] float32, 2 MiB per (batch, head) at
// full width (dqk 512, dv 1024), far beyond one SM's 227 KB of shared memory.
// So dv is split: one block per (64-column tile of dv, batch*head), 256
// threads, looping over the chunks in order with its [dqk, 64] tile of C
// (128 KB) and its own copy of n [dqk] in shared memory. Per chunk:
//   1. gates: cumsum, m_intra by a direct max over l <= j (as the oracle),
//      m_j, the decays and the new m, all from the f32 gates;
//   2. per tile of 32 query rows: the causal scores q k^T (only the key rows
//      the tile can see) from 32-wide slabs of q and k in shared memory, a
//      4x8 register tile per thread; in the same pass over the q slabs,
//      q C for the block's 64 columns and q.n. W = scores * D goes to shared
//      memory; the intra denominator is sum_l W S (= q_j . n_intra[j]);
//      then W v over 32-row slabs of v, and h is written;
//   3. C = e^{..} C + (dec_k k)^T v and n likewise, over 8-row slabs.
// Every block of a (batch, head) recomputes the gates, the scores and the
// denominator: dv/64 = 16 times at full width. That is the cost of keeping
// one kernel; a split into a scores pass and a per-tile pass removes it.
// Products are float32 FMAs on CUDA cores; chunk c is any length up to 256
// (the model's divisor of S), dqk up to 512, dv any (the last tile masked).
// q/k/v and the f32 gates are read in the model layout [B, S, H, d] / [B, S, H]
// through strides.
//
// Bound on H100. At the serving prefill shape (B 4, S 512, H 4, dqk 512,
// dv 1024, c 256, bf16) the function moves ~84 MB (q, k, v, h in bf16, C in
// f32): ~25 us at 3.35 TB/s; its ~20 GFLOP (causal pairs) take ~21 us at the
// bf16 tensor-core rate. This version runs on the CUDA cores with the score
// work repeated per dv tile, far above that bound; wgmma for the four
// products and one scores pass per (batch, head) are the way down.
//
// Tolerance. Sums run in another order than the oracle's (the intra
// denominator as sum W S, C updated row by row): float32 h and state agree
// to rel 1e-4; in bf16, h agrees to 3e-2 of max|h| with the plain version fed
// the same bf16 inputs (one rounding of h to bf16) and the f32 state to 1e-3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, T* __restrict__ h,
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
  const T* qb = q + b * q_sb + hh * q_sh;
  const T* kb = k + b * k_sb + hh * k_sh;
  const T* vb = v + b * v_sb + hh * v_sh;
  const float* ib = ig + b * i_sb + hh * i_sh;
  const float* fb = fg + b * f_sb + hh * f_sh;
  T* hb = h + b * h_sb + hh * h_sh;

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
          Qs[r * (DK + 1) + d] = (j < c && d < dk) ? to_float(qb[(s0 + j) * q_ss + d0 + d]) : 0.f;
        }
        for (int e = t; e < lpad * DK; e += THREADS) {
          const int l = e / DK, d = e % DK;
          Ks[l * (DK + 1) + d] = (l < c && d < dk) ? to_float(kb[(s0 + l) * k_ss + d0 + d]) : 0.f;
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
          Vs[e] = (ll < c && gcol < dv) ? to_float(vb[(s0 + ll) * v_ss + gcol]) : 0.f;
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
        T* hrow = hb + (s0 + j) * h_ss;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int gcol = tv0 + tile_col(t, i);
          if (gcol < dv) hrow[gcol] = from_float<T>((ha[i] + hi[i] * dq) / den);
        }
      }
    }

    // state update: C = decay C + (dec_k k)^T v, n = decay n + sum_l dec_k k
    for (int l0 = 0; l0 < c; l0 += LC) {
      __syncthreads();                     // previous slab (or h pass) done
      for (int e = t; e < LC * dqk; e += THREADS) {
        const int l = e / dqk, d = e % dqk, ll = l0 + l;
        Kc[e] = ll < c ? deck[ll] * to_float(kb[(s0 + ll) * k_ss + d]) : 0.f;
      }
      for (int e = t; e < LC * TV; e += THREADS) {
        const int l = e / TV, col = e % TV, ll = l0 + l, gcol = tv0 + col;
        Vc[e] = (ll < c && gcol < dv) ? to_float(vb[(s0 + ll) * v_ss + gcol]) : 0.f;
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ig,
                   const float* fg, void* h, float* c_out, float* n_out, float* m_out,
                   int B, int S, int H, int dqk, int dv, int c, const int64_t* qs,
                   const int64_t* ks, const int64_t* vs, const int64_t* is,
                   const int64_t* fs, const int64_t* hs, cudaStream_t stream) {
  const size_t smem = smem_bytes(dqk);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dv + TV - 1) / TV, B * H);
  mlstm_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ig, fg,
      static_cast<T*>(h), c_out, n_out, m_out, S, H, dqk, dv, c,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      is[0], is[1], is[2], fs[0], fs[1], fs[2], hs[0], hs[1], hs[2]);
  return cudaGetLastError();
}

}  // namespace

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16; the gates are float32.
// Strides are in elements, ordered (batch, seq, head); the last dim of q, k,
// v and h must be contiguous. c divides S and is at most 256. The state
// outputs are contiguous float32: C [B,H,dqk,dv], n [B,H,dqk], m [B,H].
// Returns a cudaError_t.
extern "C" int mlstm_chunk_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ig, const float* fg, void* h, float* c_out,
                               float* n_out, float* m_out, int B, int S, int H, int dqk,
                               int dv, int c, const int64_t* q_strides,
                               const int64_t* k_strides, const int64_t* v_strides,
                               const int64_t* i_strides, const int64_t* f_strides,
                               const int64_t* h_strides, void* stream) {
  if (c <= 0 || c > MAX_C || S <= 0 || S % c != 0 || dqk <= 0 || dqk > MAX_DQK ||
      dv <= 0 || B * H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, ig, fg, h, c_out, n_out, m_out, B, S, H, dqk, dv, c,
                              q_strides, k_strides, v_strides, i_strides, f_strides,
                              h_strides, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, ig, fg, h, c_out, n_out, m_out, B, S, H, dqk,
                                      dv, c, q_strides, k_strides, v_strides, i_strides,
                                      f_strides, h_strides, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
