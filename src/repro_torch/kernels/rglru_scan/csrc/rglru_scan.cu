// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t,
// elementwise over the recurrence width, with a float32 carry.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_fwd (body _rglru_kernel). Same function: a, b [B, S, W] in one
// dtype, h0 [B, W]; the carry is float32 and h is written in b's dtype.
//
// Bound on H100. Each input element is read once and each output written
// once with one FMA between them, so the kernel is bound by memory
// bandwidth: at the serving prefill shape (a, b, h float32 [4, 512, 2560],
// h0 [4, 2560]) that is ~62.9 MB, ~0.0188 ms at 3.35 TB/s. Reaching that
// rate takes ~25 KB in flight per SM (Little's law at ~1 us of HBM latency),
// which one thread per (batch, channel) -- 10,240 threads, ~2.4 warps an SM
// -- cannot keep.
//
// Design: the sequence is split over the blocks of a thread-block cluster.
// h_t from a carry h_in is an affine map of h_in, so a chunk of steps folds
// into (A, H) = (prod a_t, h at the chunk's end from 0), and chunks compose
// in order: h_out = A h_in + H.
//   * Grid (clusters, ceil(W / 64), B), cluster (clusters, 1, 1): one cluster
//     per (batch, 64-channel tile); block c of the cluster takes chunk c, of
//     `chunk` <= 64 steps (ops.scan_plan: up to 8 chunks, the portable
//     cluster size; a short sequence takes fewer, S = 1 one). A sequence
//     longer than 8 x 64 steps is taken in `rounds` of 8 chunks, the carry
//     handed from one round to the next inside the block.
//   * Staging: one warp brings the block's [chunk, 64] tiles of a and b into
//     shared memory once per round, as one 1-D bulk asynchronous copy per
//     row (cp.async.bulk on an mbarrier): 32 KB a block in float32 at the
//     serving shape, ~5 blocks an SM, so most of the input is in flight at
//     once. A layout the bulk copies cannot take (a base, a batch or seq byte
//     stride, or a row of W elements that is not a multiple of 16 bytes) is
//     staged by plain loads instead; the arithmetic is the same.
//   * Pass 1: 256 threads, 4 per channel, each folds a quarter of the chunk
//     into (A, H); the channel's 4 maps compose in shared memory.
//   * Exchange: each block stores its (A_c, H_c) of every channel into the
//     shared memory of every block of the cluster (st.shared::cluster), then
//     one cluster barrier.
//   * Carry-in: block c composes h_in = A_j h + H_j over chunks j < c from
//     the round's carry (h0 in the first), in chunk order, and its thread of
//     quarter s goes on over quarters < s. No global flags, no look-back, no
//     second launch.
//   * Pass 2: each thread re-runs its quarter from its carry out of the
//     staged tiles and writes each h once (a warp writes 32 consecutive
//     channels of a step).
// Each input element is read from HBM once and each output written once.
// Splitting S reorders the float32 operations against a sequential loop:
// the carry into a chunk is composed from products of a, not stepped.
//
// Backward (rglru_scan_bwd_kernel). Replaces nothing on the TPU: the JAX
// package trains through XLA autodiff of lax.associative_scan
// (src/repro/models/rglru.py:68); the port's models run this kernel when they
// train, so its gradient is a kernel too. With dh the gradient of h and a_S
// taken as 0, the gradient g_t of h_t follows the reverse recurrence
//   g_t = a_{t+1} g_{t+1} + dh_t,   db_t = g_t,   da_t = g_t h_{t-1},
//   dh0 = a_0 g_0                   (h_{-1} = h0)
// which is the forward recurrence in reversed time u = S - 1 - t with
// a'_u = a_{S-u} (0 at u = 0) and b'_u = dh_{S-1-u}. So the backward kernel
// is the forward's split-S cluster design walked from the end: the same
// grid, plan, quarter folds, exchange and carry-in over reversed chunks from
// a zero carry; pass 2 writes db and da (with h_{t-1} read from the forward's
// float32 h) and the block holding t = 0 writes dh0. A first version: float32
// only, tiles staged by plain loads. Bound: a, h and dh read once, da and db
// written once, ~5 x 4 B a (batch, step, channel): ~157 MB, 0.047 ms at
// [1, 3072, 2560].

#include <cooperative_groups.h>

#include "common/hopper.cuh"   // mbarriers and bulk copies

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_W = 64;                 // channels a block
constexpr int SUBS = 4;                    // threads a channel: quarters of a chunk
constexpr int THREADS = TILE_W * SUBS;
constexpr int MAX_CHUNK = 64;              // steps a block stages a round
constexpr int MAX_CLUSTER = 8;             // blocks a cluster: the portable size

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stores (A, H) into block `rank`'s shared memory at the address of `p` in
// this block's (distributed shared memory).
__device__ __forceinline__ void st_peer(const float2* p, int rank, float2 x) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(addr) : "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x.x), "f"(x.y)
               : "memory");
}

// Shared memory of one block, in bytes: the a and b tiles, the quarters'
// maps, the cluster's chunk maps (two buffers when there are several rounds)
// and the mbarrier.
template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int chunk) {
  return ((size_t)2 * chunk * TILE_W * sizeof(T) + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int chunk, int clusters, int rounds) {
  return tile_bytes<T>(chunk)
         + sizeof(float2) * TILE_W * (SUBS + (rounds > 1 ? 2 : 1) * clusters) + sizeof(uint64_t);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ o, int S, int W, int chunk,
                  int rounds, int64_t a_sb, int64_t a_ss, int64_t b_sb, int64_t b_ss,
                  int64_t o_sb, int64_t o_ss, int bulk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int w0 = blockIdx.y * TILE_W, bi = blockIdx.z;
  const int tid = threadIdx.x, ch = tid % TILE_W, sub = tid / TILE_W;
  const int w = w0 + ch, nw = min(TILE_W, W - w0);
  const int quarter = (chunk + SUBS - 1) / SUBS;
  const int nbuf = rounds > 1 ? 2 : 1;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);                                  // [chunk][TILE_W]
  T* tb = ta + chunk * TILE_W;                                         // [chunk][TILE_W]
  float2* sub_maps = reinterpret_cast<float2*>(smem + tile_bytes<T>(chunk));   // [SUBS][TILE_W]
  float2* maps = sub_maps + SUBS * TILE_W;                             // [nbuf][C][TILE_W]
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(maps + nbuf * C * TILE_W);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the cluster's blocks must all have started before one stores into
  // another's shared memory: arrive now, wait before the first exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const T* ab = a + bi * a_sb + w0;
  const T* bb = b + bi * b_sb + w0;
  float h = w < W ? h0[(int64_t)bi * W + w] : 0.f;      // the carry into the round
  for (int r = 0; r < rounds; ++r) {
    const int t0 = (r * C + c) * chunk;
    const int rows = max(0, min(chunk, S - t0));
    if (bulk) {
      if (tid < 32) {
        const uint32_t row_bytes = nw * sizeof(T);
        if (tid == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar, 2 * rows * row_bytes);
        }
        __syncwarp();
        for (int t = tid; t < rows; t += 32) {
          bulk_load((uint32_t)__cvta_generic_to_shared(ta + t * TILE_W), ab + (t0 + t) * a_ss,
                    row_bytes, bar);
          bulk_load((uint32_t)__cvta_generic_to_shared(tb + t * TILE_W), bb + (t0 + t) * b_ss,
                    row_bytes, bar);
        }
      }
      mbar_wait(bar, r & 1);
    } else {
      for (int e = tid; e < rows * TILE_W; e += THREADS) {
        const int t = e / TILE_W, x = e % TILE_W;
        if (x < nw) {
          ta[e] = ab[(t0 + t) * a_ss + x];
          tb[e] = bb[(t0 + t) * b_ss + x];
        }
      }
      __syncthreads();
    }

    // pass 1: this thread's quarter folded into (A, H)
    const int s0 = min(rows, sub * quarter), s1 = min(rows, s0 + quarter);
    float A = 1.f, H = 0.f;
#pragma unroll 4
    for (int t = s0; t < s1; ++t) {
      const float at = to_float(ta[t * TILE_W + ch]);
      A *= at;
      H = fmaf(at, H, to_float(tb[t * TILE_W + ch]));
    }
    sub_maps[sub * TILE_W + ch] = make_float2(A, H);
    __syncthreads();

    // exchange: the chunk's map of each channel, into every block's buffer
    float2* buf = maps + (r % nbuf) * C * TILE_W;
    if (r == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (sub == 0) {
      float2 m = make_float2(1.f, 0.f);
#pragma unroll
      for (int s = 0; s < SUBS; ++s) {
        const float2 q = sub_maps[s * TILE_W + ch];
        m = make_float2(m.x * q.x, fmaf(q.x, m.y, q.y));
      }
      for (int p = 0; p < C; ++p) st_peer(buf + c * TILE_W + ch, p, m);
    }
    cluster.sync();

    // carry-in: over the chunks before this one, then the quarters; h goes
    // on over the round's other chunks to the carry into the next round
    float hc = h;
    for (int j = 0; j < C; ++j) {
      if (j == c) hc = h;
      const float2 m = buf[j * TILE_W + ch];
      h = fmaf(m.x, h, m.y);
    }
    for (int s = 0; s < sub; ++s) {
      const float2 m = sub_maps[s * TILE_W + ch];
      hc = fmaf(m.x, hc, m.y);
    }

    // pass 2: this thread's quarter again, from its carry; each h written once
    if (w < W) {
      T* op = o + bi * o_sb + w;
#pragma unroll 4
      for (int t = s0; t < s1; ++t) {
        hc = fmaf(to_float(ta[t * TILE_W + ch]), hc, to_float(tb[t * TILE_W + ch]));
        op[(t0 + t) * o_ss] = from_float<T>(hc);
      }
    }
    __syncthreads();                           // tiles and quarter maps consumed
  }
}

// The backward: a, h (the forward's output), dh, da and db contiguous float32
// [B, S, W]; h0 and dh0 [B, W]. Tiles hold a' and dh in reversed time.
__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ hs,
                      const float* __restrict__ h0, const float* __restrict__ dh,
                      float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                      int S, int W, int chunk, int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int w0 = blockIdx.y * TILE_W, bi = blockIdx.z;
  const int tid = threadIdx.x, ch = tid % TILE_W, sub = tid / TILE_W;
  const int w = w0 + ch, nw = min(TILE_W, W - w0);
  const int quarter = (chunk + SUBS - 1) / SUBS;
  const int nbuf = rounds > 1 ? 2 : 1;

  extern __shared__ __align__(128) unsigned char smem[];
  float* ta = reinterpret_cast<float*>(smem);                         // [chunk][TILE_W]: a'
  float* tg = ta + chunk * TILE_W;                                    // [chunk][TILE_W]: dh
  float2* sub_maps = reinterpret_cast<float2*>(smem + tile_bytes<float>(chunk));
  float2* maps = sub_maps + SUBS * TILE_W;                            // [nbuf][C][TILE_W]

  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int64_t row0 = (int64_t)bi * S * W;                           // this batch row's [S, W]
  float g = 0.f;                       // the carry into the round: g past the end is 0
  for (int r = 0; r < rounds; ++r) {
    const int u0 = (r * C + c) * chunk;
    const int rows = max(0, min(chunk, S - u0));
    for (int e = tid; e < rows * TILE_W; e += THREADS) {
      const int u = e / TILE_W, x = e % TILE_W;
      const int t = S - 1 - (u0 + u);
      if (x < nw) {
        ta[e] = t + 1 < S ? a[row0 + (int64_t)(t + 1) * W + w0 + x] : 0.f;
        tg[e] = dh[row0 + (int64_t)t * W + w0 + x];
      }
    }
    __syncthreads();

    // pass 1: this thread's quarter folded into (A, G)
    const int s0 = min(rows, sub * quarter), s1 = min(rows, s0 + quarter);
    float A = 1.f, Gq = 0.f;
#pragma unroll 4
    for (int u = s0; u < s1; ++u) {
      const float at = ta[u * TILE_W + ch];
      A *= at;
      Gq = fmaf(at, Gq, tg[u * TILE_W + ch]);
    }
    sub_maps[sub * TILE_W + ch] = make_float2(A, Gq);
    __syncthreads();

    float2* buf = maps + (r % nbuf) * C * TILE_W;
    if (r == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (sub == 0) {
      float2 m = make_float2(1.f, 0.f);
#pragma unroll
      for (int q = 0; q < SUBS; ++q) {
        const float2 x = sub_maps[q * TILE_W + ch];
        m = make_float2(m.x * x.x, fmaf(x.x, m.y, x.y));
      }
      for (int p = 0; p < C; ++p) st_peer(buf + c * TILE_W + ch, p, m);
    }
    cluster.sync();

    float gc = g;
    for (int j = 0; j < C; ++j) {
      if (j == c) gc = g;
      const float2 m = buf[j * TILE_W + ch];
      g = fmaf(m.x, g, m.y);
    }
    for (int q = 0; q < sub; ++q) {
      const float2 m = sub_maps[q * TILE_W + ch];
      gc = fmaf(m.x, gc, m.y);
    }

    // pass 2: g_t of each step of the quarter, then db_t, da_t (and dh0)
    if (w < W) {
#pragma unroll 4
      for (int u = s0; u < s1; ++u) {
        gc = fmaf(ta[u * TILE_W + ch], gc, tg[u * TILE_W + ch]);
        const int t = S - 1 - (u0 + u);
        const int64_t at = row0 + (int64_t)t * W + w;
        const float hp = t > 0 ? hs[at - W] : h0[(int64_t)bi * W + w];
        db[at] = gc;
        da[at] = gc * hp;
        if (t == 0) dh0[(int64_t)bi * W + w] = a[at] * gc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* o, int B, int S, int W,
                   const int64_t* as, const int64_t* bs, const int64_t* os, int clusters,
                   int chunk, int rounds, int bulk, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, (W + TILE_W - 1) / TILE_W, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T>(chunk, clusters, rounds);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, rglru_scan_kernel<T>, static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(o), S, W, chunk, rounds, as[0], as[1], bs[0], bs[1], os[0], os[1], bulk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static_assert(smem_bytes<float>(MAX_CHUNK, MAX_CLUSTER, 2) <= 48 * 1024,
              "the largest plan fits the default dynamic shared memory");

}  // namespace

// dtype (of a, b and the output): 0 = float32, 1 = bfloat16. h0 is float32
// [B, W], contiguous. Strides are in elements, ordered (batch, seq); the W
// dim must be contiguous. The plan (clusters <= 8 chunks a round of `chunk`
// <= 64 steps, `rounds` rounds, clusters * chunk * rounds >= S) comes from
// ops.scan_plan; bulk = 1 stages the tiles by bulk copies (16-byte aligned
// bases, byte strides and rows), 0 by plain loads. Returns a cudaError_t.
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b, const void* h0,
                              void* o, int B, int S, int W, const int64_t* a_strides,
                              const int64_t* b_strides, const int64_t* o_strides,
                              int clusters, int chunk, int rounds, int bulk, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || clusters < 1 || clusters > MAX_CLUSTER ||
      chunk < 1 || chunk > MAX_CHUNK || rounds < 1 || (int64_t)clusters * chunk * rounds < S)
    return (int)cudaErrorInvalidValue;
  const float* h = static_cast<const float*>(h0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(a, b, h, o, B, S, W, a_strides, b_strides, o_strides, clusters,
                              chunk, rounds, bulk, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, b, h, o, B, S, W, a_strides, b_strides, o_strides,
                                      clusters, chunk, rounds, bulk, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: a, h (the forward's output), dh, da, db float32 [B, S, W]
// and h0, dh0 [B, W], all contiguous; the plan as for rglru_scan_fwd.
// Returns a cudaError_t.
extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* h0, const void* dh,
                              void* da, void* db, void* dh0, int B, int S, int W, int clusters,
                              int chunk, int rounds, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || clusters < 1 || clusters > MAX_CLUSTER ||
      chunk < 1 || chunk > MAX_CHUNK || rounds < 1 || (int64_t)clusters * chunk * rounds < S)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, (W + TILE_W - 1) / TILE_W, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<float>(chunk, clusters, rounds);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, rglru_scan_bwd_kernel, static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dh), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W, chunk, rounds);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
