// Shared by the fused AA pair-chain kernels K3 (aa_fused.cu, forward) and
// K4 (aa_fused_bwd.cu, backward): the widths, the packed weight layout and
// the register-tile helpers of the chain.  K4 recomputes K3's chain with
// these same functions, so its logits are the ones whose softmax statistics
// K3 wrote.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aa {

constexpr int D = 64;          // embed width
constexpr int D2 = 2 * D;      // packed two-branch width
constexpr int H = 8;           // heads
constexpr int HD = D / H;      // head width
constexpr float LN_EPS = 1e-5f;
constexpr float SCALE = 0.35355339059327373f;  // 1 / sqrt(HD)

// packed weights (floats) in W_ORDER, matrices [in][out]
constexpr int OFF_WU = 0;                      // [4][2D]
constexpr int OFF_BU = OFF_WU + 4 * D2;        // [2D]
constexpr int OFF_LN0S = OFF_BU + D2;          // [2D]
constexpr int OFF_LN0B = OFF_LN0S + D2;        // [2D]
constexpr int OFF_W1 = OFF_LN0B + D2;          // [2D][2D]
constexpr int OFF_B1 = OFF_W1 + D2 * D2;       // [2D]
constexpr int OFF_LNA0S = OFF_B1 + D2;         // [D]
constexpr int OFF_LNA0B = OFF_LNA0S + D;       // [D]
constexpr int OFF_WAGG = OFF_LNA0B + D;        // [D][D]
constexpr int OFF_BAGG = OFF_WAGG + D * D;     // [D]
constexpr int OFF_LNA1S = OFF_BAGG + D;        // [D]
constexpr int OFF_LNA1B = OFF_LNA1S + D;       // [D]
constexpr int OFF_WKV = OFF_LNA1B + D;         // [D][2D]
constexpr int OFF_BKV = OFF_WKV + D * D2;      // [2D]
constexpr int W_FLOATS = OFF_BKV + D2;

static_assert(W_FLOATS % 4 == 0, "float4 alignment");

// sum over the 16 lanes that hold one row (lanes differing in their low 4 bits)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm of one 64-wide row held as 4 values by each of 16 lanes (columns
// c0 .. c0+3 of that lane), two-pass variance; optional ReLU.  When xhat is
// given it receives the normalised values and *inv the row's 1/std.
__device__ __forceinline__ void ln_row(float x[4], const float* __restrict__ scale,
                                       const float* __restrict__ bias, int c0, bool relu,
                                       float* xhat = nullptr, float* inv_out = nullptr) {
  const float mean = row_sum16((x[0] + x[1]) + (x[2] + x[3])) * (1.0f / D);
  float xc[4], ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xc[j] = x[j] - mean;
    ss = fmaf(xc[j], xc[j], ss);
  }
  const float inv = 1.0f / sqrtf(row_sum16(ss) * (1.0f / D) + LN_EPS);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (xhat != nullptr) xhat[j] = xc[j] * inv;
    const float y = fmaf(xc[j] * inv, scale[c0 + j], bias[c0 + j]);
    x[j] = relu ? fmaxf(y, 0.0f) : y;
  }
  if (inv_out != nullptr) *inv_out = inv;
}

// acc[i][j] += sum_k A[r0 + i][k] * W[k][c0 + j] for i < NR, j < 4, and when
// TWO also acc[i][4 + j] += ... W[k][D + c0 + j]; A and W in shared memory
template <int NR, int K, int LDA, int LDW, bool TWO>
__device__ __forceinline__ void mm(const float* __restrict__ A, const float* __restrict__ W,
                                   int r0, int c0, float acc[NR][8]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float a[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (r0 + i) * LDA + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * LDW + c0);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        acc[i][0] = fmaf(a[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], w.w, acc[i][3]);
      }
      if (TWO) {
        const float4 w2 = *reinterpret_cast<const float4*>(W + (k + kk) * LDW + D + c0);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          acc[i][4] = fmaf(a[i][kk], w2.x, acc[i][4]);
          acc[i][5] = fmaf(a[i][kk], w2.y, acc[i][5]);
          acc[i][6] = fmaf(a[i][kk], w2.z, acc[i][6]);
          acc[i][7] = fmaf(a[i][kk], w2.w, acc[i][7]);
        }
      }
    }
  }
}

template <int NR>
__device__ __forceinline__ void zero(float acc[NR][8]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ void store4(float* dst, const float v[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace aa
