// Warp-level pieces of the chunkwise mLSTM's gate arithmetic, shared by the
// bf16 forward (mlstm_chunk.cu) and the bf16 backward (mlstm_chunk_bwd.cu).
// Include as "mlstm_chunk/csrc/mlstm_gates.cuh" after common/hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float GATE_NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One warp: the f32 gates of chunk rows [s0, s0 + c), c <= 256, lane owning
// rows 8 lane .. 8 lane + 7: i into s_i and the in-chunk cumulative sum b of
// f into s_b (0 past c). Returns b's total, btot, in every lane.
__device__ float chunk_gates(const float* ib, const float* fb, int64_t i_ss, int64_t f_ss,
                             int64_t s0, int c, float* s_b, float* s_i, int lane) {
  float pre[8], run = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * lane + u;
    const bool in = r < c;
    run += in ? fb[(s0 + r) * f_ss] : 0.f;
    pre[u] = run;
    s_i[r] = in ? ib[(s0 + r) * i_ss] : 0.f;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const float before = __shfl_up_sync(0xffffffffu, incl, 1);
  const float excl = lane == 0 ? 0.f : before;
#pragma unroll
  for (int u = 0; u < 8; ++u) s_b[8 * lane + u] = 8 * lane + u < c ? excl + pre[u] : 0.f;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// One warp: the stabiliser after the chunk whose gates chunk_gates just
// stored, from m_prev (the chunk's max of btot - b_l + i_l against btot + m_prev).
__device__ float next_m(const float* s_b, const float* s_i, int c, float btot, float m_prev,
                        int lane) {
  float g = GATE_NEG_INF;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * lane + u;
    if (r < c) g = fmaxf(g, btot - s_b[r] + s_i[r]);
  }
  return fmaxf(btot + m_prev, warp_max(g));
}

// One warp, after chunk_gates: z_j = m_j - b_j = max(max_{l <= j} (i_l - b_l),
// m_prev) of the lane's rows 8 lane + u into z[u] (a prefix max over the
// chunk, so no c x c matrix; rows past c get m_prev).
__device__ void chunk_stabilisers(const float* s_b, const float* s_i, int c, float m_prev,
                                  int lane, float* z) {
  float pm[8], run = GATE_NEG_INF;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * lane + u;
    run = fmaxf(run, r < c ? s_i[r] - s_b[r] : GATE_NEG_INF);
    pm[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = fmaxf(incl, y);
  }
  const float before = __shfl_up_sync(0xffffffffu, incl, 1);
  const float excl = lane == 0 ? GATE_NEG_INF : before;
#pragma unroll
  for (int u = 0; u < 8; ++u) z[u] = fmaxf(fmaxf(excl, pm[u]), m_prev);
}

__device__ __forceinline__ void bf16x8_to_float(uint4 raw, float* x) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

}  // namespace
