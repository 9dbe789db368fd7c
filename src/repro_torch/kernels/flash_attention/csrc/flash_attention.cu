// Flash attention forward for Hopper (sm_90a): causal / sliding-window
// attention with GQA and an online softmax in float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (body _flash_fwd_kernel). Same function: query head h
// reads kv head h / G, scale 1/sqrt(hd), masked logits -1e30, visible keys
// ki <= qi (causal) and ki > qi - window, output acc / max(l, 1e-30) in q's
// dtype. Layout [B, S, H, hd] / [B, S, K, hd], head_dim 16, 64, 128 or 256.
// For training, either kernel also writes each row's log-sum-exp of the
// scaled logits (float32 [B, H, S], natural log) where the caller passes a
// buffer; serving passes a null pointer and the kernels skip that store.
// The backward kernels that read it are in flash_attention_bwd.cu.
//
// Two kernels, chosen by dtype and head dim:
//
// * bfloat16 at head_dim 64, 128 or 256 -> flash_tc_kernel, on the tensor
//   cores. S = Q K^T and O += P V are wgmma products (bf16 in, float32
//   accumulate). A block is one consumer warpgroup that owns a 64-row query
//   tile (wgmma's M) of one head, and a producer warp; grid (ceil(S / 64), B *
//   H). One producer thread feeds a ring of 2 K/V tiles of 64 keys through
//   TMA, each stage guarded by a full and an empty mbarrier. The tensor maps
//   are 4-D over {hd, heads, S, B} with the tensors' own byte strides, encoded
//   per call on the host (cuTensorMapEncodeTiled, looked up through
//   cudaGetDriverEntryPoint, so no -lcuda) from a plan the wrapper caches per
//   layout, and passed as __grid_constant__ parameters. A box is [rows, 64]
//   bf16 with the 128-byte swizzle, so a tile is hd / 64 boxes (one at hd 64);
//   the wgmma descriptors use the same swizzle. Rows past S arrive as zeros
//   and are masked. Q and K are K-major operands; V is the MN-major B operand
//   of the second product (transpose-B bit), and P goes from the S accumulator
//   to the A-operand registers as bf16 pairs without a shuffle. Registers: the
//   O accumulator takes hd / 2 floats a thread and S BK / 2; at hd 256 with BK
//   = 64 that is 199 registers, no spills, and its 160 KB of shared memory
//   leave one block an SM (80 KB and two blocks at hd 128, 41 KB at hd 64).
//   Only kv tiles the query tile can see are loaded; tiles on the diagonal, at
//   the window's edge or past S are masked in registers, from each accumulator
//   register's (row, column) in the m64nN fragment layout. One instance per
//   head dim: 3 stages, 32-key tiles at hd 256 and two consumer warpgroups
//   sharing each K/V tile were each slower at the serving shapes.
// * float32 at every head dim, and bfloat16 at head_dim 16 ->
//   flash_cc_kernel, float32 FMAs on CUDA cores (bf16 is widened as it is
//   staged and rounded once on the way out). Float32 wgmma would be TF32,
//   which would break the float32 tolerance (2e-5) that the float32 models
//   hold the kernel to. At head_dim 16 a bf16 row is 32 bytes, narrower than
//   the 128-byte swizzle box the tensor-core kernel is built on, QK^T would
//   be a single k16 step, and no served model runs bf16 at head_dim 16 (the
//   reduced configs serve in float32), so that instance shares the CUDA-core
//   kernel. One block per (b * h, 32-row query tile), four threads per row,
//   padded float tiles in shared memory.
//
// Bound on H100 (989 TFLOP/s bf16, 3.35 TB/s): at qwen2-7b's prefill shape
// (B 4, S 512, H 28, K 4, hd 128, causal, bf16) the work is ~7.5 GFLOP
// against ~33.6 MB of q, k, v and out: 0.0076 ms of tensor-core time and
// 0.0100 ms of HBM time, so bytes bound it. At recurrentgemma-2b's (H 10,
// K 1, hd 256) it is ~5.4 GFLOP against ~23 MB: 0.0055 / 0.0069 ms.
// Both shapes sit near the ridge. A warpgroup runs its two products and the
// softmax between them one after another, so the tensor cores idle during
// the softmax unless another block on the SM fills them.

#include "common/hopper.cuh"   // mbarriers, TMA, wgmma (shared with mlstm_chunk.cu)

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// CUDA-core kernel: float32 at every head dim, bfloat16 at head_dim 16
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int F_BQ = 32;           // query rows per block
constexpr int F_BK = 32;           // keys per kv tile
constexpr int F_THREADS = 128;     // 4 threads per query row
constexpr int F_COLS = F_BK / 4;   // score columns per thread

template <int HD>                  // head dim: 16, 64, 128 or 256
constexpr int cc_smem_floats() {
  return F_BQ * (HD + 1) + F_BK * (HD + 1) + F_BK * HD + F_BQ * (F_BK + 1);
}

// Four blocks an SM: with no floor, ptxas capped some instances at 48 to 72
// registers and spilled a few bytes.
template <typename T, int HD>
__global__ void __launch_bounds__(F_THREADS, 4)
flash_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                int S, int H, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, float scale) {
  constexpr int DPT = HD / 4;          // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD+1]  (padded: no bank conflicts)
  float* Ks = Qs + F_BQ * (HD + 1);    // [BK][HD+1]
  float* Vs = Ks + F_BK * (HD + 1);    // [BK][HD]
  float* Ps = Vs + F_BK * HD;          // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * F_BQ;
  const int t = threadIdx.x;
  const int r = t >> 2;                // this thread's query row in the tile
  const int c0 = t & 3;                // its first score / accumulator column
  const int qi = q0 + r;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int e = t; e < F_BQ * HD; e += F_THREADS) {
    const int row = e / HD, d = e % HD;
    const int qr = q0 + row;
    Qs[row * (HD + 1) + d] = qr < S ? to_float(qb[qr * q_ss + d]) : 0.f;
  }

  // kv tiles this query tile can see
  const int q_last = min(q0 + F_BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_end = (kv_end + F_BK - 1) / F_BK;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int tile = kv_begin / F_BK; tile < tile_end; ++tile) {
    const int k0 = tile * F_BK;
    __syncthreads();                   // previous K/V consumed, Q stored
    for (int e = t; e < F_BK * HD; e += F_THREADS) {
      const int row = e / HD, d = e % HD;
      const int kr = k0 + row;
      const bool in = kr < S;
      Ks[row * (HD + 1) + d] = in ? to_float(kb[kr * k_ss + d]) : 0.f;
      Vs[row * HD + d] = in ? to_float(vb[kr * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[F_COLS];
#pragma unroll
    for (int j = 0; j < F_COLS; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * (HD + 1);
    const float* kcol = Ks + c0 * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < F_COLS; ++j) s[j] = fmaf(qd, kcol[4 * j * (HD + 1) + d], s[j]);
    }

    bool valid[F_COLS];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < F_COLS; ++j) {
      const int ki = k0 + c0 + 4 * j;
      valid[j] = ki < S && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
      s[j] = valid[j] ? s[j] * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // the four threads of a row are neighbouring lanes
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < F_COLS; ++j) {
      const float p = valid[j] ? expf(s[j] - m_new) : 0.f;
      rowsum += p;
      Ps[r * (F_BK + 1) + c0 + 4 * j] = p;
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
    l = l * alpha + rowsum;
    m = m_new;
    __syncwarp();                      // a row's P is written and read in one warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    const float* prow = Ps + r * (F_BK + 1);
    for (int c = 0; c < F_BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * HD + c0;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[c0 + 4 * j] = from_float<T>(acc[j] * inv);
    if (lse != nullptr && c0 == 0) lse[(int64_t)bh * S + qi] = m + logf(l);
  }
}

template <typename T, int HD>
cudaError_t launch_cc(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int S, int H, int K,
                      const int64_t* qs, const int64_t* ks, const int64_t* vs,
                      const int64_t* os, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = cc_smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_cc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + F_BQ - 1) / F_BQ, B * H);
  flash_cc_kernel<T, HD><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, H / K,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

constexpr int BM = 64;             // query rows per block (wgmma M)
constexpr int BK = 64;             // keys per K/V tile (wgmma N of Q K^T)
constexpr int STAGES = 2;          // K/V tiles in the shared-memory ring
constexpr int ATOM = TMA_BOX_COLS; // bf16 columns in one 128-byte swizzle row
constexpr int WG = 128;            // threads in a warpgroup
constexpr int TC_THREADS = WG + 32;  // the consumer warpgroup and a producer warp
constexpr int PLAN = 11;           // int64 values of one tensor-map plan
static_assert(PLAN == TMA_PLAN_VALUES, "a plan is kernels/_tma.py's TensorMapPlan");


template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "head dim 64, 128 or 256");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int HD>
struct TcLayout {                   // byte offsets from a 1024-aligned base
  static constexpr int Q_BYTES = BM * HD * 2;        // the 64-row Q tile
  static constexpr int KV_BYTES = BK * HD * 2;       // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// Grid: (ceil(S / 64), B * H); block y is (batch b, query head h), which
// reads kv head h / G.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H, int G,
                int64_t o_sb, int64_t o_ss, int64_t o_sh,
                int causal, int window, float scale_log2) {
  using L = TcLayout<HD>;
  constexpr int ATOMS = HD / ATOM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t full0 = q_full + 8;                 // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;        // empty[s] = empty0 + 8 s

  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = blockIdx.x * BM;

  // kv tiles this query tile can see
  const int kv_end = causal ? min(q0 + BM, S) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG) {
    // producer: one thread starts every load
    if (threadIdx.x != WG) return;
    mbar_expect_tx(q_full, L::Q_BYTES);
    for (int a = 0; a < ATOMS; ++a)
      tma_load_4d(base + a * BM * 128, &tm_q, q_full, a * ATOM, h, q0, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(empty0 + 8 * s, ((t / STAGES) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, 2 * L::KV_BYTES);
      const int k0 = (t0 + t) * BK;
      for (int a = 0; a < ATOMS; ++a) {
        tma_load_4d(base + L::K_OFF + s * L::KV_BYTES + a * BK * 128, &tm_k, full,
                    a * ATOM, kh, k0, b);
        tma_load_4d(base + L::V_OFF + s * L::KV_BYTES + a * BK * 128, &tm_v, full,
                    a * ATOM, kh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup: 64 query rows of head h. m64nN fragment: this
  // thread holds rows r0 and r0 + 8 of the tile, columns 8 i + 2 (lane % 4)
  // + {0, 1}; register 4 i + {0, 1} is row r0, 4 i + {2, 3} row r0 + 8.
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;
  const int cq = 2 * (lane % 4);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    const uint32_t k_base = base + L::K_OFF + s * L::KV_BYTES;
    const uint32_t v_base = base + L::V_OFF + s * L::KV_BYTES;

    // S = Q K^T: hd / 16 steps of k16; each 64-column atom holds 4 of them
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    fence_regs<BK / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, smem_desc(base + (kk / 4) * BM * 128 + (kk % 4) * 32, 1, 64),
                   smem_desc(k_base + (kk / 4) * BK * 128 + (kk % 4) * 32, 1, 64), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BK / 2>(sc);

    // mask, then the online softmax (log2 domain) of rows r0 and r0 + 8
    const int k0 = (t0 + t) * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BM - 1 - window);
    float m_tile[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int half = (i % 4) / 2;              // 0: row r0, 1: row r0 + 8
      float x = sc[i] * scale_log2;
      if (edge) {
        const int qi = q0 + r0 + 8 * half;
        const int ki = k0 + 8 * (i / 4) + cq + (i % 2);
        const bool ok = ki < S && (!causal || ki <= qi) && (window <= 0 || ki > qi - window);
        x = ok ? x : NEG_INF;
      }
      sc[i] = x;
      m_tile[half] = fmaxf(m_tile[half], x);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a row are neighbours
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      // a row with no visible key yet: its masked entries must give p = 0
      m_use[r] = m_new == NEG_INF ? 0.f : m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int half = (i % 4) / 2;
      const float p = exp2f(sc[i] - m_use[half]);
      sc[i] = p;
      psum[half] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

    // P as the A operand: the accumulator of keys 16 j .. 16 j + 15 is
    // already in the register layout of a k16 A fragment
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
      pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
      pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
      pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
    }

    // O += P V: V [BK keys][hd] is MN-major; k16 step j starts 16 rows down
    fence_regs<HD / 2>(acc);
    fence_regs<BK / 4>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_pv<HD>(acc, pa[j], smem_desc(v_base + j * 16 * 128, BK * 128 / 16, 64));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<HD / 2>(acc);
    mbar_arrive(empty0 + 8 * s);
  }

  // out = acc / max(l, 1e-30); rows past S are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= S) continue;
    // log-sum-exp in natural units: m_run is in the log2 domain
    if (lse != nullptr && lane % 4 == 0)
      lse[(int64_t)blockIdx.y * S + qi] = (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = o + b * o_sb + qi * o_ss + h * o_sh + cq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
  }
}


// args: the plans of q, k and v (PLAN values each), then o's element
// strides (batch, seq, head).
template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int S, int H, int K, const int64_t* args, int causal, int window,
                      float scale, cudaStream_t stream) {
  using L = TcLayout<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = encode_map(&tm_q, q, args, HD, H, S, B, BM)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_k, k, args + PLAN, HD, K, S, B, BK)) != cudaSuccess) return err;
  if ((err = encode_map(&tm_v, v, args + 2 * PLAN, HD, K, S, B, BK)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const int64_t* os = args + 3 * PLAN;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_tc_kernel<HD><<<grid, TC_THREADS, L::BYTES, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, S, H, H / K, os[0], os[1], os[2],
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel. dtype: 0 = float32 (hd 16, 64, 128 or 256), 1 =
// bfloat16 (hd 16). Strides are in elements, ordered (batch, seq, head); the
// head dim must be contiguous. lse: null, or float32 [B, H, S] for each row's
// log-sum-exp. Returns a cudaError_t.
extern "C" int flash_attention_fwd_cc(int dtype, const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int S, int H, int K, int hd,
                                      const int64_t* q_strides, const int64_t* k_strides,
                                      const int64_t* v_strides, const int64_t* o_strides,
                                      int causal, int window, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || B * H > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CC(T, HD)                                                                  \
  return (int)launch_cc<T, HD>(q, k, v, o, static_cast<float*>(lse), B, S, H, K, q_strides, \
                               k_strides, v_strides, o_strides, causal, window, scale, st)
  if (dtype == 0 && hd == 16) FLASH_CC(float, 16);
  if (dtype == 0 && hd == 64) FLASH_CC(float, 64);
  if (dtype == 0 && hd == 128) FLASH_CC(float, 128);
  if (dtype == 0 && hd == 256) FLASH_CC(float, 256);
  if (dtype == 1 && hd == 16) FLASH_CC(__nv_bfloat16, 16);
#undef FLASH_CC
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bfloat16 inputs, hd 64, 128 or 256. args: 3 * 11
// + 3 int64, the tensor maps of q, k and v (dims, byte strides, box; see
// encode_map), then o's strides in elements (batch, seq, head). lse as for
// the CUDA-core kernel. Returns a cudaError_t.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int S, int H, int K, int hd,
                                        const int64_t* args, int causal, int window,
                                        float scale, void* stream) {
  if (K <= 0 || H % K != 0 || B * H > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return (int)launch_tc<64>(q, k, v, o, l, B, S, H, K, args, causal, window, scale, st);
  if (hd == 128)
    return (int)launch_tc<128>(q, k, v, o, l, B, S, H, K, args, causal, window, scale, st);
  if (hd == 256)
    return (int)launch_tc<256>(q, k, v, o, l, B, S, H, K, args, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
