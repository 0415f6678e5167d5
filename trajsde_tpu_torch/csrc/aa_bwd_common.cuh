// Shared by the fused AA backward kernels K4 (aa_fused_bwd.cu, f32) and
// K4b (aa_fused_bwd_bf16.cu, the VJP of K3b): the chunk and group sizes,
// the layout of the vector gradients, the operand accessors of plain tiles,
// the LayerNorm VJP of one row and the f64 sum of the blocks' gradient
// slices.  Include after aa_common.cuh.
#pragma once

#include <cuda_runtime.h>

namespace aa_bwd {

using namespace aa;

constexpr int P = 32;          // pairs per chunk
constexpr int RB = 8;          // receivers per group
constexpr int THREADS = 256;   // 16 row groups (2 rows each) x 16 column groups
constexpr int NR = 2;          // rows per thread

// the vector gradients, summed by the block: wu, bu, ln0s, ln0b as packed,
// then the shared half of b1, lna0s, lna0b, bagg, lna1s, lna1b, bkv
constexpr int V_WU = 0, V_BU = OFF_BU, V_LN0S = OFF_LN0S, V_LN0B = OFF_LN0B;
constexpr int V_B1 = OFF_LN0B + D2;
constexpr int V_LNA0S = V_B1 + D, V_LNA0B = V_LNA0S + D;
constexpr int V_BAGG = V_LNA0B + D, V_LNA1S = V_BAGG + D, V_LNA1B = V_LNA1S + D;
constexpr int V_BKV = V_LNA1B + D;
constexpr int V_FLOATS = V_BKV + D2;

static_assert(OFF_WU == 0 && V_B1 == OFF_W1, "the packed layout starts wu bu ln0s ln0b");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// operand accessors for mma_tf32.cuh (swizzled tiles: aa_common.cuh's Swz)
struct Plain {  // a row-major tile or staged matrix, (row, col) -> value
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[r * ld + c]; }
};

struct PadAt {  // (row, col) -> float index in a padded tile, for tc::store_c
  int ld;
  __device__ __forceinline__ int operator()(int r, int c) const { return r * ld + c; }
};

template <int MT, int NT>
__device__ __forceinline__ void zero_tiles(float acc[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// LayerNorm VJP of one row over the 16 lanes that hold it: this lane's NV
// values dy (cotangent of the output), xhat (normalised input) and the
// scale at its columns -> dx; inv is the row's 1/std.  BF (K4b): xhat's
// row mean s3 is not 0 when the mean came from bf16-rounded inputs (ln_mm),
// and dx = inv (dxhat - s1 - (xhat - s3) s2) is the exact VJP of
// (x - m) inv with m and the variance differentiated as plain means (a
// rounding's derivative taken as 1, as JAX's astype)
template <int NV, bool BF = false>
__device__ __forceinline__ void ln_vjp(const float dy[NV], const float xh[NV], const float sc[NV],
                                       float inv, float dx[NV]) {
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, dxh[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    dxh[m] = dy[m] * sc[m];
    s1 += dxh[m];
    s2 = fmaf(dxh[m], xh[m], s2);
    if (BF) s3 += xh[m];
  }
  s1 = row_sum16(s1) * (1.0f / D);
  s2 = row_sum16(s2) * (1.0f / D);
  if (BF) {
    s3 = row_sum16(s3) * (1.0f / D);
#pragma unroll
    for (int m = 0; m < NV; ++m) dx[m] = inv * (dxh[m] - s1 - (xh[m] - s3) * s2);
  } else {
#pragma unroll
    for (int m = 0; m < NV; ++m) dx[m] = inv * (dxh[m] - s1 - xh[m] * s2);
  }
}

}  // namespace aa_bwd

// A kernel in the unnamed namespace, as the includer's own kernels are: each
// library that includes this header (K4's, K4b's) has its own copy.
namespace {

// dw[i] = sum over blocks of partial[b][i], in block order, in f64
__global__ void reduce_partials(const double* __restrict__ partial, int blocks,
                                float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= aa::W_FLOATS) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * aa::W_FLOATS + i];
  dw[i] = static_cast<float>(s);
}

}  // namespace
