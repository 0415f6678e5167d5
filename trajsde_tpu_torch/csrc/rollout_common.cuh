// Shared by the decoder-rollout kernels K1 (sde_rollout.cu, forward) and
// K2 (sde_rollout_bwd.cu, reverse sweep): the packed weight layout and the
// counter-based generator.  K2 regenerates K1's increments from the same
// (seed, global row, step, word) counters, so both files must draw through
// these functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rollout {

constexpr int D = 64;
constexpr int MAT = D * D;

// packed weights (floats), matrices stored [in][out]:
// wf0 wf1 wf2 wg0 wg1 | wf0t[2][D] wg0t[2][D] | bf0 bf1 bf2 bg0 bg1 wgo | bgo (padded to 4)
constexpr int OFF_WF0 = 0, OFF_WF1 = MAT, OFF_WF2 = 2 * MAT, OFF_WG0 = 3 * MAT, OFF_WG1 = 4 * MAT;
constexpr int OFF_WF0T = 5 * MAT, OFF_WG0T = OFF_WF0T + 2 * D;
constexpr int OFF_BF0 = OFF_WG0T + 2 * D, OFF_BF1 = OFF_BF0 + D, OFF_BF2 = OFF_BF1 + D;
constexpr int OFF_BG0 = OFF_BF2 + D, OFF_BG1 = OFF_BG0 + D, OFF_WGO = OFF_BG1 + D;
constexpr int OFF_BGO = OFF_WGO + D;
constexpr int W_FLOATS = OFF_BGO + 4;

enum Mode { EXPLICIT = 0, RADEMACHER = 1, GAUSSIAN = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The generator's two keys: the scalar arguments k1 / k2, or, when `keys` is
// not null, the uint32[2] it points to.  A CUDA graph replays the scalar
// arguments it captured, so a captured launch reads each replay's keys from
// device memory; loaded once per thread, they feed the same hash.
__device__ __forceinline__ void load_keys(const uint32_t* __restrict__ keys, uint32_t& k1,
                                          uint32_t& k2) {
  if (keys != nullptr) {
    k1 = keys[0];
    k2 = keys[1];
  }
}

// 32 random bits for one (row, step, word) counter; k1/k2 derive from the seed
__device__ __forceinline__ uint32_t draw_bits(uint32_t k1, uint32_t k2, uint64_t counter) {
  return fmix32(fmix32(static_cast<uint32_t>(counter) ^ k1) ^ k2);
}

// (0, 1) uniform from the top 24 bits, clipped away from 0 and 1
__device__ __forceinline__ float uniform24(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return fminf(fmaxf(u, 1.0f / 16777216.0f), 1.0f - 1.0f / 16777216.0f);
}

// Rademacher increment of lane `col` at (row, step t): one bit per lane,
// word col / 32 of the (row, t) counter block
__device__ __forceinline__ float rademacher(uint32_t k1, uint32_t k2, uint64_t row, int t, int T,
                                            int col) {
  const uint64_t base = (row * static_cast<uint64_t>(T) + t) * (D / 32);
  const uint32_t bits = draw_bits(k1, k2, base + (col >> 5));
  return ((bits >> (col & 31)) & 1u) ? 1.0f : -1.0f;
}

// pair-output Box-Muller at (row, step t): pair p uses words 2p, 2p+1;
// lane p takes r cos(a) (*zc), lane p + D/2 takes r sin(a) (*zs)
__device__ __forceinline__ void gaussian_pair(uint32_t k1, uint32_t k2, uint64_t row, int t, int T,
                                              int p, float* zc, float* zs) {
  const uint64_t base = (row * static_cast<uint64_t>(T) + t) * D;
  const float u1 = uniform24(draw_bits(k1, k2, base + 2 * p));
  const float u2 = uniform24(draw_bits(k1, k2, base + 2 * p + 1));
  const float r = sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincosf(6.283185307179586f * u2, &sn, &cs);
  *zc = r * cs;
  *zs = r * sn;
}

}  // namespace rollout
