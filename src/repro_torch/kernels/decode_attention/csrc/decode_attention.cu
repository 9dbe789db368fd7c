// Decode attention for Hopper (sm_90a): one query token per (batch, kv head)
// against an L-slot KV cache, head_dim 16, 64, 128 or 256, float32 online
// softmax, split over the slots (flash-decoding) with the partial results
// combined inside one launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention_fwd (body _decode_kernel). Same function: the G query
// heads of a group share kv head kh; slot j is valid if slot_pos[j] >= 0,
// slot_pos[j] <= cur_pos and, with a window, slot_pos[j] > cur_pos - window;
// a masked slot has the logit -1e30 and stays in the online softmax, so a
// call with no valid slot averages v over all L slots, as the JAX kernel and
// the plain version do; output acc / max(l, 1e-30) in q's dtype.
//
// Bound on H100: every cache byte is read once per token and does ~G FMAs,
// so the kernel is bound by bytes (3.35 TB/s). At qwen2-7b's decode shape
// (B 4, K 4, G 7, L 544, hd 128, bf16) that is 4.46 MB, 1.3 us; at
// recurrentgemma-2b's (B 4, K 1, G 10, hd 256) 2.2 MB, 0.7 us. One block
// per (batch, kv head) would be 16 and 4 blocks for 132 SMs, so the slots
// are split over several blocks.
//
// Design. A thread-block cluster of `splits` blocks serves gc query heads
// of one (batch, kv head); block rank r of the cluster takes slots
// [r * slots, (r + 1) * slots). kernels/decode_attention/ops.py:split_plan
// picks head blocks, splits and slots: portable clusters of up to 8 and
// >= 64 blocks at the serving shapes (qwen2-7b 1 x 8 splits, 128 blocks;
// recurrentgemma-2b 2 head blocks x 8 splits, 64 blocks). Grid: B * K *
// head_blocks * splits blocks of 256 threads; a block holds at most
// MAX_HEADS = 8 heads (a group of 9 to 16 takes two head blocks or more), so
// that two blocks fit an SM.
//   1. Loads: the block's K and V rows arrive in shared memory as 16-byte
//      cp.async copies, in tiles of up to 64 slots (32 for float32 at hd
//      256), double-buffered: every load of a 2-tile slice is issued before
//      the first is consumed. The tile's slot_pos entries come with it. The
//      q rows come as 16-byte loads and sit in shared memory as float32.
//   2. Scores: a row is read by 2 to 32 lanes (one per 16-byte chunk of the
//      row, at most 32: head_dim 16 in bf16 is 2 chunks, so 16 rows share a
//      warp), 16 bytes each (conflict-free); each lane keeps the partial dots
//      of all MAX_HEADS heads for 3 or 4 rows (independent chains; each q
//      chunk read serves those rows), summed over the lanes by a
//      reduce-scatter (N - 1 shuffles for N heads; where a row has fewer
//      lanes than heads, each lane ends with several heads' dots); a masked
//      slot gets -1e30.
//   3. Softmax: one warp per head updates (m, l) from the tile's scores and
//      turns them into p in place.
//   4. PV: a thread owns one 16-byte column chunk of up to four heads and
//      accumulates p v over the tile's rows in registers; when the group
//      leaves half the threads idle (G 7 at hd 128) they split the rows, and
//      their sums meet in shared memory at the end.
// Scores, softmax and PV stay on CUDA cores in float32: one token per head
// gives the tensor cores nothing to do in a kernel bound by bytes.
//   5. Combine: block r of the cluster owns a 1/splits share of the gc x hd
//      outputs. Each block pushes its partial acc of every share, and its
//      (m, l), into the owner's shared memory through distributed shared
//      memory (mapa, st.shared::cluster: stores, so no block waits on a
//      remote load); after one cluster barrier the owner combines its share
//      from local shared memory and writes it in q's dtype. A split with no
//      valid slot (or no slot: L < splits) holds m = -1e30 and drops out of
//      the combine unless no split has a valid slot. One launch per call
//      (cudaLaunchKernelEx with a cluster dimension of at most 8, the
//      portable size).
// k/v are read in place in the cache layout [B, L, K, hd] through strides;
// q and cache rows must be 16-byte aligned (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HEADS = 8;          // query heads a block holds
constexpr int MAX_SPLITS = 8;         // blocks a cluster holds (the portable size)
constexpr int MAX_ROW_GROUPS = 8;     // PV row groups; their sums meet one after another
constexpr float NEG_INF = -1e30f;

template <typename T, int HD>
struct Shape {
  static constexpr int E = 16 / sizeof(T);               // elements a 16-byte chunk
  static constexpr int CH = HD / E;                      // chunks a row
  static constexpr int LPR = CH < 32 ? CH : 32;          // lanes reading one row
  static constexpr int RPW = 32 / LPR;                   // rows a warp reads at once
  static constexpr int CPL = CH / LPR;                   // chunks a lane reads of a row
  static constexpr int HPP = THREADS / CH;               // heads of one PV pass
  static constexpr int PASSES = (MAX_HEADS + HPP - 1) / HPP;
  static constexpr int FIT = 32768 / (HD * (int)sizeof(T));   // rows in 32 KB
  static constexpr int MAX_TILE = FIT < 64 ? FIT : 64;          // slots a K or V tile
  static constexpr int R = MAX_HEADS * E <= 32 ? 4 : 3;          // rows scored at once
  static constexpr int QPT = (MAX_HEADS * CH + THREADS - 1) / THREADS;   // q chunks a thread loads
  // after the row group's reduce-scatter a lane holds KEEP heads' dots, each
  // held by DUP lanes (KEEP > 1 only at head_dim 16, where a row has fewer
  // 16-byte chunks than MAX_HEADS; a bf16 row at 64 has exactly 8)
  static constexpr int KEEP = MAX_HEADS > LPR ? MAX_HEADS / LPR : 1;
  static constexpr int DUP = LPR > MAX_HEADS ? LPR / MAX_HEADS : 1;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The E elements of a 16-byte chunk as floats.
__device__ __forceinline__ void chunk_to_float(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void chunk_to_float(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Chunk c of a q row in shared memory, as floats. For bf16 (a chunk is 8
// columns, two float4s) the second float4 of chunk c sits HD / 8 float4s
// after the first, so that the lanes of a row group read consecutive
// 16-byte words (no bank conflict).
template <int E, int HD>
__device__ __forceinline__ void q_chunk(const float* q_row, int c, float* out) {
  chunk_to_float(q_row + 4 * c, out);
  if constexpr (E == 8) chunk_to_float(q_row + 4 * (HD / 8 + c), out + 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stores to block `rank`'s shared memory at the address of `p` in this
// block's (distributed shared memory: 32-bit shared::cluster addresses).
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(addr) : "r"(rank));
  return addr;
}
__device__ __forceinline__ void st_peer(const float* p, int rank, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(peer_addr(p, rank)), "f"(x)
               : "memory");
}
__device__ __forceinline__ void st_peer4(const float* p, int rank, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(peer_addr(p, rank)), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w) : "memory");
}

// Phase clocks, compiled only with -DREPRO_DECODE_PHASES (the diagnostic
// build of kernels/decode_attention/phases.py; the served library has none
// of this). Thread 0 of each block adds up the clock() cycles of each phase
// as it sees them, after the block's barriers, and at the end stores them in
// decode_phase_cycles[block].
enum Phase { PROLOGUE, WAIT, SCORES, SOFTMAX, PV, PARTIAL, CLUSTER_WAIT, PUSH, COMBINE, N_PHASES };
#ifdef REPRO_DECODE_PHASES
constexpr int PHASE_BLOCKS = 4096;
__device__ unsigned decode_phase_cycles[PHASE_BLOCKS][N_PHASES];
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
      for (int p = 0; p < N_PHASES; ++p) decode_phase_cycles[blockIdx.x][p] = sum[p];
  }
};
#else
struct PhaseClock {
  __device__ void mark(Phase) const {}
  __device__ void store() const {}
};
#endif

// Sums, over the LPR lanes of a row group, N per-lane values (one per head;
// powers of two). Each halving step sends a partner the half of the values
// that it keeps (N - 1 shuffles in all, not N log LPR). Where N <= LPR the
// lanes that hold the same head finish by plain shuffles and v[0] is the sum
// of head `head`; where N > LPR the halving stops when every lane of the
// group has been added in, and v[0 .. N / LPR) are the sums of heads `head`,
// `head` + 1, ...
__host__ __device__ constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x / 2) : 0; }

template <int N, int LPR>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane, int& head) {
  constexpr int HALVINGS = log2_of(N < LPR ? N : LPR);
  head = 0;
#pragma unroll
  for (int step = 0; step < HALVINGS; ++step) {
    const int n = N >> step, off = (LPR / 2) >> step;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (up) head += n / 2;
  }
#pragma unroll
  for (int off = (LPR / 2) >> HALVINGS; off > 0; off /= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

// Shared memory of one block, in bytes: K/V stages, q (MAX_HEADS rows, zero
// past the block's heads), the partial accumulator, what the peers push for
// this block's share of the outputs (their accumulators, m and l), scores,
// (m, l, alpha) and slot positions.
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes(int tile, int stages) {
  return (size_t)stages * 2 * tile * HD * sizeof(T)
         + sizeof(float) * ((size_t)3 * MAX_HEADS * HD + 4 * MAX_SPLITS
                            + 2 * MAX_SPLITS * MAX_HEADS + (size_t)MAX_HEADS * tile
                            + 3 * MAX_HEADS)
         + sizeof(int) * stages * tile;
}

// Issues every load of tile t of a split (all threads, one commit group):
// its K and V rows as 16-byte copies and its slot positions.
template <typename T, int HD>
__device__ __forceinline__ void issue_tile(int t, T* s_kv, int* s_pos, const T* kb, const T* vb,
                                           const int* slot_pos, int64_t k_sl, int64_t v_sl,
                                           int s_begin, int n, int tile, int stages, int tid) {
  constexpr int E = Shape<T, HD>::E, CH = Shape<T, HD>::CH;
  const int r0 = t * tile, rows = min(tile, n - r0), st = t % stages;
  T* ks = s_kv + (size_t)st * 2 * tile * HD;
  T* vs = ks + tile * HD;
  for (int e = tid; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const int64_t slot = s_begin + r0 + r;
    cp_async16(ks + r * HD + c * E, kb + slot * k_sl + c * E);
    cp_async16(vs + r * HD + c * E, vb + slot * v_sl + c * E);
  }
  for (int r = tid; r < rows; r += THREADS)
    cp_async4(s_pos + st * tile + r, slot_pos + s_begin + r0 + r);
  cp_async_commit();
}

// Block x: rank r = x % splits of the cluster of (b, kh, head block hb), with
// x / splits = (b * K + kh) * head_blocks + hb. It holds query heads
// [kh * group + hb * gc, + gb), gb <= MAX_HEADS, and slots [r * slots,
// min(L, (r + 1) * slots)).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)             // two blocks an SM
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ slot_pos,
                    T* __restrict__ o, int L, int K, int group, int head_blocks, int gc,
                    int splits, int slots, int tile, int stages,
                    int64_t q_sb, int64_t q_sh,
                    int64_t k_sb, int64_t k_sl, int64_t k_sk,
                    int64_t v_sb, int64_t v_sl, int64_t v_sk,
                    int64_t o_sb, int64_t o_sh,
                    int cur_pos, int window, float scale) {
  using Sh = Shape<T, HD>;
  constexpr int E = Sh::E, CH = Sh::CH, LPR = Sh::LPR, RPW = Sh::RPW, CPL = Sh::CPL;
  constexpr int HPP = Sh::HPP, PASSES = Sh::PASSES, R = Sh::R, KEEP = Sh::KEEP, DUP = Sh::DUP;
  cg::cluster_group cluster = cg::this_cluster();
  PhaseClock clk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_kv = reinterpret_cast<T*>(smem_raw);                        // [stages][2][tile][HD]
  float* s_q = reinterpret_cast<float*>(s_kv + (size_t)stages * 2 * tile * HD);  // [MAX_HEADS][HD]
  float* s_acc = s_q + MAX_HEADS * HD;                        // [MAX_HEADS][HD]
  float* s_in = s_acc + MAX_HEADS * HD;                       // [splits][per]: peers' acc shares
  float* s_in_ml = s_in + MAX_HEADS * HD + 4 * MAX_SPLITS;    // [2][MAX_SPLITS][MAX_HEADS]
  float* s_p = s_in_ml + 2 * MAX_SPLITS * MAX_HEADS;          // [MAX_HEADS][tile]
  float* s_m = s_p + MAX_HEADS * tile;                        // [MAX_HEADS]
  float* s_l = s_m + MAX_HEADS;                               // [MAX_HEADS]
  float* s_alpha = s_l + MAX_HEADS;                           // [MAX_HEADS]
  int* s_pos = reinterpret_cast<int*>(s_alpha + MAX_HEADS);   // [stages][tile]

  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / splits;
  const int hb = cid % head_blocks, bk = cid / head_blocks;
  const int b = bk / K, kh = bk % K;
  const int h0 = kh * group + hb * gc;
  const int gb = min(gc, group - hb * gc);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int s_begin = min(L, rank * slots);
  const int n = min(L, s_begin + slots) - s_begin;
  const int n_tiles = (n + tile - 1) / tile;
  const T* kb = k + b * k_sb + kh * k_sk;
  const T* vb = v + b * v_sb + kh * v_sk;

  // the cluster's blocks must all have started before one stores into
  // another's shared memory: arrive now, wait before the push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int t = 0; t < stages && t < n_tiles; ++t)
    issue_tile<T, HD>(t, s_kv, s_pos, kb, vb, slot_pos, k_sl, v_sl, s_begin, n, tile, stages,
                      tid);
  {                                       // q rows, 16 bytes a load, all loads first
    uint4 raw[Sh::QPT];
#pragma unroll
    for (int i = 0; i < Sh::QPT; ++i) {
      const int c = tid + i * THREADS, g = c / CH;
      raw[i] = c < MAX_HEADS * CH && g < gb
                   ? *reinterpret_cast<const uint4*>(q + b * q_sb + (h0 + g) * q_sh + c % CH * E)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < Sh::QPT; ++i) {
      const int c = tid + i * THREADS, g = c / CH, cc = c % CH;
      if (c < MAX_HEADS * CH) {
        float f[E];
        chunk_to_float(reinterpret_cast<const T*>(&raw[i]), f);
        float* row = s_q + g * HD;
        *reinterpret_cast<float4*>(row + 4 * cc) = make_float4(f[0], f[1], f[2], f[3]);
        if constexpr (E == 8)
          *reinterpret_cast<float4*>(row + 4 * (HD / 8 + cc)) = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
  if (tid < MAX_HEADS) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }

  // PV ownership: column chunk c_pv of heads g0 + j * HPP; when the group
  // leaves at least half the head slots idle, they split the rows instead
  // (row group rg of nrg <= MAX_ROW_GROUPS takes rows rg, rg + nrg, ...)
  const int c_pv = tid % CH, hslot = tid / CH;
  const int nrg = HPP >= 2 * gb ? min(HPP / gb, MAX_ROW_GROUPS) : 1;
  const int rg = nrg > 1 ? hslot / gb : 0;
  const int g0 = nrg > 1 ? hslot % gb : hslot;
  const bool pv = rg < nrg && g0 < gb;
  float acc[PASSES][E];
#pragma unroll
  for (int j = 0; j < PASSES; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;

  const int sub = lane % LPR, rw = lane / LPR;
  clk.mark(PROLOGUE);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                            // tile t landed; q, m, l set
    clk.mark(WAIT);
    const int rows = min(tile, n - t * tile), st = t % stages;
    const T* ks = s_kv + (size_t)st * 2 * tile * HD;
    const T* vs = ks + tile * HD;
    const int* ps = s_pos + st * tile;

    // scores: a row group of LPR lanes reads a row, 16 bytes a lane, and
    // keeps the partial dots of all MAX_HEADS heads for R rows at once (each q
    // chunk read from shared memory serves R rows)
    for (int r0 = warp * RPW * R; r0 < rows; r0 += WARPS * RPW * R) {
      float kf[R][CPL][E] = {};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + rw + i * RPW;
        if (r < rows)
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            chunk_to_float(ks + r * HD + (sub + j * LPR) * E, kf[i][j]);
      }
      float part[R][MAX_HEADS];
#pragma unroll
      for (int g = 0; g < MAX_HEADS; ++g) {
#pragma unroll
        for (int i = 0; i < R; ++i) part[i][g] = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float qf[E];
          q_chunk<E, HD>(s_q + g * HD, sub + j * LPR, qf);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e) part[i][g] = fmaf(qf[e], kf[i][j][e], part[i][g]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + rw + i * RPW;
        int g;
        reduce_scatter<MAX_HEADS, LPR>(part[i], lane, g);
        const int sp = r < rows ? ps[r] : -1;
        const bool valid = sp >= 0 && sp <= cur_pos && (window <= 0 || sp > cur_pos - window);
#pragma unroll
        for (int j = 0; j < KEEP; ++j)
          if (r < rows && g + j < gb && (sub & (DUP - 1)) == 0)
            s_p[(g + j) * tile + r] = valid ? part[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();
    clk.mark(SCORES);

    // online softmax, one warp a head; p replaces the score
#pragma unroll
    for (int w = 0; w < (MAX_HEADS + WARPS - 1) / WARPS; ++w) {
      const int g = warp + w * WARPS;
      if (g < gb) {
        float mx = NEG_INF;
        for (int i = lane; i < rows; i += 32) mx = fmaxf(mx, s_p[g * tile + i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = s_m[g], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int i = lane; i < rows; i += 32) {
          const float p = expf(s_p[g * tile + i] - m_new);
          s_p[g * tile + i] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          s_alpha[g] = alpha;
          s_l[g] = s_l[g] * alpha + sum;
          s_m[g] = m_new;
        }
      }
    }
    __syncthreads();
    clk.mark(SOFTMAX);

    // acc = acc * alpha + p v over the tile's rows (this row group's)
    if (pv) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int g = g0 + j * HPP;
        const float alpha = g < gb ? s_alpha[g] : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
      }
#pragma unroll 4
      for (int r = rg; r < rows; r += nrg) {
        float vf[E];
        chunk_to_float(vs + r * HD + c_pv * E, vf);
#pragma unroll
        for (int j = 0; j < PASSES; ++j) {
          const int g = g0 + j * HPP;
          if (g < gb) {
            const float p = s_p[g * tile + r];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
          }
        }
      }
    }
    __syncthreads();                            // stage t % stages consumed
    if (t + stages < n_tiles)
      issue_tile<T, HD>(t + stages, s_kv, s_pos, kb, vb, slot_pos, k_sl, v_sl, s_begin, n,
                        tile, stages, tid);
    clk.mark(PV);
  }

  // this split's partial acc: the row groups add up in shared memory, one
  // group after another
  for (int grp = 0; grp < nrg; ++grp) {
    if (pv && rg == grp)
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int g = g0 + j * HPP;
        if (g < gb)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float* dst = s_acc + g * HD + c_pv * E + e;
            *dst = grp == 0 ? acc[j][e] : *dst + acc[j][e];
          }
      }
    __syncthreads();
  }
  clk.mark(PARTIAL);

  // push: block r owns the 4-float chunks [r * per, (r + 1) * per) of the
  // gb x HD outputs; each block stores its partial of every chunk, and its
  // (m, l), into the owner's shared memory (fire and forget), then one
  // cluster barrier makes them visible
  const int chunks = gb * HD / 4, per = (chunks + splits - 1) / splits;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  clk.mark(CLUSTER_WAIT);
  for (int c = tid; c < chunks; c += THREADS) {
    const int owner = c / per;
    st_peer4(s_in + 4 * (rank * per + c - owner * per), owner,
             *reinterpret_cast<const float4*>(s_acc + 4 * c));
  }
  if (tid < splits * gb) {
    const int owner = tid / gb, g = tid % gb;
    st_peer(s_in_ml + rank * MAX_HEADS + g, owner, s_m[g]);
    st_peer(s_in_ml + (MAX_SPLITS + rank) * MAX_HEADS + g, owner, s_l[g]);
  }
  cluster.sync();
  clk.mark(PUSH);

  // combine this block's chunks from local shared memory:
  // out = sum_r acc_r e^{m_r - M} / sum_r l_r e^{m_r - M}
  const int c_begin = min(chunks, rank * per), n_mine = min(chunks, c_begin + per) - c_begin;
  for (int i = tid; i < n_mine; i += THREADS) {
    const int e = 4 * (c_begin + i), g = e / HD;
    float M = NEG_INF;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, s_in_ml[r * MAX_HEADS + g]);
    float den = 0.f;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float f = expf(s_in_ml[r * MAX_HEADS + g] - M);
      den = fmaf(s_in_ml[(MAX_SPLITS + r) * MAX_HEADS + g], f, den);
      const float4 a = *reinterpret_cast<const float4*>(s_in + 4 * (r * per + i));
      out.x = fmaf(a.x, f, out.x);
      out.y = fmaf(a.y, f, out.y);
      out.z = fmaf(a.z, f, out.z);
      out.w = fmaf(a.w, f, out.w);
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    T* dst = o + b * o_sb + (h0 + g) * o_sh + e % HD;
    dst[0] = from_float<T>(out.x * inv);
    dst[1] = from_float<T>(out.y * inv);
    dst[2] = from_float<T>(out.z * inv);
    dst[3] = from_float<T>(out.w * inv);
  }
  clk.mark(COMBINE);
  clk.store();
}

// Host-side tile choice: the fewest tiles of at most MAX_TILE slots that
// cover a split, of equal length; two stages when there are two or more.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos, void* o,
                   int B, int L, int K, int group, int head_blocks, int gc, int splits,
                   int slots, const int64_t* st, int cur_pos, int window, float scale,
                   cudaStream_t stream) {
  using Sh = Shape<T, HD>;
  const int n_tiles = (slots + Sh::MAX_TILE - 1) / Sh::MAX_TILE;
  const int tile = (slots + n_tiles - 1) / n_tiles;
  const int stages = n_tiles > 1 ? 2 : 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static uint64_t configured = 0;               // once per instance and device
  if (!(configured >> device & 1)) {
    err = cudaFuncSetAttribute(decode_split_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<T, HD>(Sh::MAX_TILE, 2));
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K * head_blocks * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T, HD>(tile, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_split_kernel<T, HD>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), slot_pos, static_cast<T*>(o), L, K,
      group, head_blocks, gc, splits, slots, tile, stages, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], cur_pos, window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Instances: head dim 16, 64, 128 or 256.
template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const int* sp,
                     void* o, int B, int L, int K, int G, int hb, int splits, int slots,
                     const int64_t* st, int cur_pos, int window, float scale, cudaStream_t s) {
  const int gc = (G + hb - 1) / hb;
  if (gc > MAX_HEADS || splits < 1 || splits > MAX_SPLITS || slots < 1 ||
      (int64_t)splits * slots < L || (hb - 1) * gc >= G)
    return cudaErrorInvalidValue;
#define DECODE_HD(HD)                                                                     \
  if (hd == HD)                                                                           \
  return launch<T, HD>(q, k, v, sp, o, B, L, K, G, hb, gc, splits, slots, st, cur_pos, \
                       window, scale, s)
  DECODE_HD(16);
  DECODE_HD(64);
  DECODE_HD(128);
  DECODE_HD(256);
#undef DECODE_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 16, 64, 128 or 256; a head block holds at
// most 8 heads of the group H / K. strides (10 int64, in elements, the head dim
// contiguous): q (batch, head), cache k and v (batch, slot, kv head), out
// (batch, head); cache rows 16-byte aligned. slot_pos is int32 [L] on the
// device. The split plan (head_blocks, splits <= 8, slots with splits *
// slots >= L) comes from ops.split_plan. Returns a cudaError_t.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    const void* slot_pos, void* o, int B, int L, int H, int K,
                                    int hd, const int64_t* strides, int cur_pos, int window,
                                    float scale, int head_blocks, int splits, int slots,
                                    void* stream) {
  if (K <= 0 || H % K != 0 || L <= 0 || B <= 0 || head_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const int* sp = static_cast<const int*>(slot_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(hd, q, k, v, sp, o, B, L, K, G, head_blocks, splits, slots,
                                strides, cur_pos, window, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, sp, o, B, L, K, G, head_blocks, splits,
                                        slots, strides, cur_pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef REPRO_DECODE_PHASES
// Copies the phase cycles of blocks [0, n) of the last launch to out, n x
// N_PHASES unsigned ints in the order of enum Phase.
extern "C" int decode_phase_cycles_read(unsigned* out, int n) {
  if (n < 0 || n > PHASE_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, decode_phase_cycles, sizeof(unsigned) * N_PHASES * n);
}
#endif

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
