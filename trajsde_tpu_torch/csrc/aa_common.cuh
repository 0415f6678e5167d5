// Shared by the fused AA pair-chain kernels K3 (aa_fused.cu, forward), K4
// (aa_fused_bwd.cu, backward) and K5 (aa_attention.cu, the chain with its
// q projection and pair features): the widths (D 64; 8 or 4 heads), the
// packed weight layout, the swizzled chunk tiles and the epilogues of the
// chain's products.  K3, K4's recompute and K5 take each product on the
// tensor cores through mma_tf32.cuh's mma_xwt_split and each epilogue
// through these functions, so K4's logits are bit for bit the ones whose
// softmax statistics K3 wrote.  The bf16 forms K3b and K4b take the same
// epilogues with BF = true (each LayerNorm's output rounded to bf16, and
// under ln_mm its statistics from bf16-rounded inputs) and their products
// through mma_bf16.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aa {

constexpr int D = 64;          // embed width
constexpr int D2 = 2 * D;      // packed two-branch width
constexpr float LN_EPS = 1e-5f;

// The head count is a template parameter of K3, K4 and K5: the flagship's 8
// heads and the HiVT baseline's 4.  A row's 64 columns lie in 16 lanes, 4
// columns a lane, so a head lies in LANES = HD / 4 neighbouring lanes.
template <int H>
struct Heads {
  static_assert(H == 8 || H == 4, "the AA kernels take 8 or 4 heads");
  static constexpr int HD = D / H;      // head width
  static constexpr int LANES = HD / 4;  // lanes that hold one head of a row
  static constexpr float SCALE = H == 8 ? 0.35355339059327373f : 0.25f;  // 1 / sqrt(HD)
};

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

// x rounded to the nearest bf16 (ties to even), as an f32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// LayerNorm of one 64-wide row held as 4 values by each of 16 lanes (columns
// c0 .. c0+3 of that lane), two-pass variance; optional ReLU.  When xhat is
// given it receives the normalised values and *inv the row's 1/std.
// BF (K3b, K4b): the output is rounded to bf16, as pair_chain's LayerNorms
// emit the compute dtype; with stats16 (JAX's ln_mm, _ln_mm in
// trajsde_tpu/ops/pallas/aa_fused.py) the mean is taken over the
// bf16-rounded inputs and the variance over the bf16-rounded squares
// (x - mean)^2, in f32 sums, as its averaging matmuls do.
template <bool BF>
__device__ __forceinline__ void ln_row_t(float x[4], const float* __restrict__ scale,
                                         const float* __restrict__ bias, int c0, bool relu,
                                         bool stats16, float* xhat, float* inv_out) {
  float mean;
  if (BF && stats16)
    mean = row_sum16((bf16r(x[0]) + bf16r(x[1])) + (bf16r(x[2]) + bf16r(x[3]))) * (1.0f / D);
  else
    mean = row_sum16((x[0] + x[1]) + (x[2] + x[3])) * (1.0f / D);
  float xc[4], ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xc[j] = x[j] - mean;
    if (BF && stats16)
      ss += bf16r(xc[j] * xc[j]);
    else
      ss = fmaf(xc[j], xc[j], ss);
  }
  const float inv = 1.0f / sqrtf(row_sum16(ss) * (1.0f / D) + LN_EPS);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (xhat != nullptr) xhat[j] = xc[j] * inv;
    float y = fmaf(xc[j] * inv, scale[c0 + j], bias[c0 + j]);
    if (BF) y = bf16r(y);
    x[j] = relu ? fmaxf(y, 0.0f) : y;
  }
  if (inv_out != nullptr) *inv_out = inv;
}

// the f32 LayerNorm (K3, K4, K5)
__device__ __forceinline__ void ln_row(float x[4], const float* __restrict__ scale,
                                       const float* __restrict__ bias, int c0, bool relu,
                                       float* xhat = nullptr, float* inv_out = nullptr) {
  ln_row_t<false>(x, scale, bias, c0, relu, false, xhat, inv_out);
}

__device__ __forceinline__ void store4(float* dst, const float v[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load4(float v[4], const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// index of (row, col) in a swizzled chunk tile of row stride ld (a multiple
// of 32): the row's 16-byte granules are permuted by an XOR with key(row) =
// 2 (row mod 4) + (row / 4 mod 2), which takes all 8 values over any 8 rows
// from a multiple of 8.  So the tensor-core fragment reads fall in 32
// different banks: 8 rows at one column (the A operand of X W), and 4 rows
// at 8 neighbouring columns (both operands of X^T Y: keys 2t or 2t + 1
// against 2 granules); the C fragments' float2 stores do too.  A float4 at
// a multiple of 4 columns stays whole.
__device__ __forceinline__ int swz(int row, int col, int ld) {
  const int key = ((row & 3) << 1) | ((row >> 2) & 1);
  return row * ld + (col ^ (key << 2));
}

struct Swz {  // a swizzled chunk tile as an operand accessor, (row, col) -> value
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[swz(r, c, ld)]; }
};

struct SwzAt {  // (row, col) -> float index in a swizzled tile, for tc::store_c
  int ld;
  __device__ __forceinline__ int operator()(int r, int c) const { return swz(r, c, ld); }
};

// The chain's epilogues, on one row held as 4 values by each of 16 lanes
// (columns c0 .. c0+3 of that lane): x holds the raw sums of a product
// (mma_xwt_split over the whole K, from zero), and each adds its bias, then
// as pair_chain does.  w1 comes folded: z1[:D] + z1[D:] = a0 w1f + b1f with
// w1f = w1[:, :D] + w1[:, D:] and b1f = b1[:D] + b1[D:] summed once in f32
// when the weights are staged (exact for the model's block-diagonal w1).
// In the bf16 forms w1 is not folded (a sum of two bf16 weights is not a
// bf16 value in general): x holds [a0 | a0] . [w1[:, :D]; w1[:, D:]], one
// product over K = 4D, and b1f is still summed once in f32.
// a1 = relu(LN(a0 w1f + b1f)); BF and stats16 as ln_row_t
template <bool BF = false>
__device__ __forceinline__ void epi_a1(float x[4], const float* __restrict__ b1f,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias, int c0,
                                       float* xhat = nullptr, float* inv = nullptr,
                                       bool stats16 = false) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] += b1f[c0 + j];
  ln_row_t<BF>(x, scale, bias, c0, true, stats16, xhat, inv);
}

// nbr = LN(a1 wagg + bagg)
template <bool BF = false>
__device__ __forceinline__ void epi_nbr(float x[4], const float* __restrict__ bagg,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, int c0,
                                        float* xhat = nullptr, float* inv = nullptr,
                                        bool stats16 = false) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] += bagg[c0 + j];
  ln_row_t<BF>(x, scale, bias, c0, false, stats16, xhat, inv);
}

// k or v = nbr wkv + bkv, at columns c0.. of bkv
__device__ __forceinline__ void epi_bias(float x[4], const float* __restrict__ b, int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] += b[c0 + j];
}

// the sum of one value per lane over the Heads<H>::LANES lanes that hold a
// head (lanes differing in their low bits), as a butterfly: xor 1 at 8
// heads; xor 1, then xor 2 at 4, so ((l0 + l1) + (l2 + l3)).  Every lane of
// the group gets the same bits (each add has the same two operands).
template <int H>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int off = 1; off < Heads<H>::LANES; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a head's logit q_h . k_h / sqrt(hd) from this lane's 4 key columns and
// those of the other lanes of its head (lanes 2h, 2h + 1 at 8 heads; 4h ..
// 4h + 3 at 4)
template <int H>
__device__ __forceinline__ float head_logit(const float4 qv, const float k[4]) {
  float part = qv.x * k[0];
  part = fmaf(qv.y, k[1], part);
  part = fmaf(qv.z, k[2], part);
  part = fmaf(qv.w, k[3], part);
  part = head_sum<H>(part);
  return __fmul_rn(part, Heads<H>::SCALE);  // rounded here: never contracted into a later add
}

}  // namespace aa
