// Warp-level tensor-core products at f32 accuracy (3xTF32) over operands in
// shared memory, for the products of K1 (sde_rollout.cu), K3 (aa_fused.cu),
// all nine of K4 (aa_fused_bwd.cu: its recompute is K3's) and K5's three
// (aa_attention.cu).  K2
// (sde_rollout_bwd.cu) ran its fourteen here too, until they moved to the
// FP64 tensor cores (mma_f64.cuh).
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 multiplies a 16 x 8
// tile of A by an 8 x 8 tile of B into a 16 x 8 f32 tile C, one warp at a
// time.  Lane (g, t) = (lane / 4, lane % 4) holds (PTX ISA, "Matrix
// fragments for mma.m16n8k8"):
//   A (row m, depth k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (depth k, col n): b0 (t, g), b1 (t + 4, g)
//   C (row m, col n):   c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// TF32 keeps 10 of f32's 23 mantissa bits, about 3 decimal digits.  So each
// f32 operand x is split into big = rna_tf32(x) and small = rna_tf32(x - big),
// which recombine to x within 2^-22 of |x|, and each product is the sum of
// three TF32 products in f32, the small terms first: small * big, big * small,
// big * big.  small * small (2^-22 of the product) is dropped.  The products
// of two TF32 values are exact in f32, so what differs from an f32 FMA chain
// is the operands' last bit or two and the tensor cores' rounding of their
// sums (see mma_xwt).
//
// The operands are read through accessors: (row, col) -> the f32 value, so a
// tile's layout (stride, swizzle, a sum of two weight blocks) stays with its
// caller.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small), both TF32 bit patterns in 32-bit registers
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b for one 16 x 8 x 8 tile
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over two k-steps (h = 0, 1) in 3xTF32: the six TF32 products,
// the small terms first, into a fresh fragment, which is then added to acc
// on the CUDA cores (see mma_xwt)
__device__ __forceinline__ void mma3x2(float acc[4], const uint32_t ab0[4], const uint32_t as0[4],
                                       const uint32_t bb0[2], const uint32_t bs0[2],
                                       const uint32_t ab1[4], const uint32_t as1[4],
                                       const uint32_t bb1[2], const uint32_t bs1[2]) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(c, as0, bb0);
  mma(c, ab0, bs0);
  mma(c, ab0, bb0);
  mma(c, as1, bb1);
  mma(c, ab1, bs1);
  mma(c, ab1, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// the same six products into two fresh fragments, the small terms in one
// and big * big in the other, added to acc in that order: the small terms
// are then not cut to the bits of the running sum, nor big * big's sum to
// those of a sum carried through four more steps.  K1 sums so, as K2 did
// in 3xTF32: in a CPU
// model of its reverse sweep (tests/test_torch_sde_rollout_tf32.py) mma3x2
// put five gradients 2.4-2.7x farther from f64 than the f32 plain version's
// typical distance, this 1.8x at most.
__device__ __forceinline__ void mma3x2_apart(float acc[4], const uint32_t ab0[4],
                                             const uint32_t as0[4], const uint32_t bb0[2],
                                             const uint32_t bs0[2], const uint32_t ab1[4],
                                             const uint32_t as1[4], const uint32_t bb1[2],
                                             const uint32_t bs1[2]) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(c, as0, bb0);
  mma(c, ab0, bs0);
  mma(c, as1, bb1);
  mma(c, ab1, bs1);
  mma(m, ab0, bb0);
  mma(m, ab1, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = (acc[e] + c[e]) + m[e];
}

// the A fragments of a k-step pair (k0, k0 + 8) of MT tiles, split
template <int MT, class AccX>
__device__ __forceinline__ void split_a(const AccX& x, int m0, int k0, uint32_t xb[2][MT][4],
                                        uint32_t xs[2][MT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i + g, k = k0 + 8 * h;
      split(x(m, k + t), xb[h][i][0], xs[h][i][0]);
      split(x(m + 8, k + t), xb[h][i][1], xs[h][i][1]);
      split(x(m, k + t + 4), xb[h][i][2], xs[h][i][2]);
      split(x(m + 8, k + t + 4), xb[h][i][3], xs[h][i][3]);
    }
}

// acc += X W^T, 3xTF32: acc[i][j] += sum_k x(m0 + 16 i + r, k) w(n0 + 8 j + c, k)
// for this warp's MT x NT tiles (r < 16, c < 8, k < K), with X [M][K] and
// W [N][K] by rows: an input gradient dY W^T of y = x W, W's rows [in][out]
// read at their out index k.  acc[i][j] is the C fragment of tile (i, j);
// K is a multiple of 16.  Each X fragment is split once for all NT tiles.
// The six products of two k-steps go into a fresh fragment, which is then
// added to acc on the CUDA cores, rounded to nearest: the tensor cores do
// not round so.  On an H100 (scripts/probe_mma_rounding_torch.py) an mma
// cuts each of its addends (the exact products and C) toward zero 2 bits
// below the f32 ulp of the largest, and rounds their sum toward zero; a
// term under that cut is lost.  One accumulator carried through the tensor
// cores over a receiver group's 384 pairs put K4's weight gradients at the
// training shape up to 2.2x farther from the f32 plain version than its
// FMA build was, on an H100, and failed the f64 test at B = 8.  A fresh fragment per k-step also
// passes; one per two k-steps takes fewer registers (no spill in K4) and
// fewer adds (tests/test_torch_aa_fused_tf32.py models all three).
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW>
__device__ __forceinline__ void mma_xwt(const AccX& x, const AccW& w, int m0, int n0,
                                        float acc[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xb[2][MT][4], xs[2][MT][4];
    split_a<MT>(x, m0, k0, xb, xs);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t wb[2][2], ws[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split(w(n, k0 + 8 * h + t), wb[h][0], ws[h][0]);
        split(w(n, k0 + 8 * h + t + 4), wb[h][1], ws[h][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3x2(acc[i][j], xb[0][i], xs[0][i], wb[0], ws[0],
                                          xb[1][i], xs[1][i], wb[1], ws[1]);
    }
  }
}

// the transpose of an accessor: (r, c) -> x(c, r)
template <class Acc>
struct Trans {
  Acc x;
  __device__ __forceinline__ float operator()(int r, int c) const { return x(c, r); }
};

// acc += X^T Y: X [K][M] and Y [K][N] by rows (a weight gradient x^T dY,
// summed over K rows of pairs or rows)
template <int MT, int NT, int K, int UNROLL, class AccX, class AccY>
__device__ __forceinline__ void mma_xty(const AccX& x, const AccY& y, int m0, int n0,
                                        float acc[MT][NT][4]) {
  mma_xwt<MT, NT, K, UNROLL>(Trans<AccX>{x}, Trans<AccY>{y}, m0, n0, acc);
}

// acc += X W^T as mma_xwt, but summed as mma3x2_apart and with W split
// beforehand: w(n, k) returns the (big, small) TF32 pair of W[n][k] as a
// uint2, so only X is split here.
// The NT tiles lie n_step columns apart: tile j covers columns
// n0 + n_step j .. + 7 (K1's warps take n-tiles j and j + 4).
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW>
__device__ __forceinline__ void mma_xwt_split(const AccX& x, const AccW& w, int m0, int n0,
                                              int n_step, float acc[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xb[2][MT][4], xs[2][MT][4];
    split_a<MT>(x, m0, k0, xb, xs);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + n_step * j + g;
      uint32_t wb[2][2], ws[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 p = w(n, k0 + 8 * h + t + 4 * r);
          wb[h][r] = p.x;
          ws[h][r] = p.y;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3x2_apart(acc[i][j], xb[0][i], xs[0][i], wb[0], ws[0],
                                                xb[1][i], xs[1][i], wb[1], ws[1]);
    }
  }
}

// x's (big, small) pair as a uint2, as mma_xwt_split's weight accessors return it
__device__ __forceinline__ uint2 split2(float x) {
  uint32_t big, small;
  split(x, big, small);
  return make_uint2(big, small);
}

// an f32 weight accessor w(n, k) -> float as mma_xwt_split's operand: each
// value is split where it is read, into the bits a pre-split copy holds
template <class Acc>
struct SplitAtUse {
  Acc w;
  __device__ __forceinline__ uint2 operator()(int n, int k) const { return split2(w(n, k)); }
};

// the C fragments of a warp's NT tiles (rows m0 .., cols n0 + 8 j ..) into
// a chunk tile through at(row, col) -> float index, as float2s
template <int NT, class At>
__device__ __forceinline__ void store_c(float* tile, const At& at, const float acc[1][NT][4],
                                        int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + at(m0 + g + 8 * h, n0 + 8 * j + 2 * t)) =
          make_float2(acc[0][j][2 * h], acc[0][j][2 * h + 1]);
}

// two products of mma_xwt_split in one loop, acc1 += X1 W1^T and
// acc2 += X2 W2^T, so that their fragments interleave; where X1 and X2 are
// one tile (the same accessor), its fragments are loaded and split once
template <int MT, int NT, int K, int UNROLL, class AccX1, class AccW1, class AccX2, class AccW2>
__device__ __forceinline__ void mma_xwt_split2(const AccX1& x1, const AccW1& w1,
                                               float acc1[MT][NT][4], const AccX2& x2,
                                               const AccW2& w2, float acc2[MT][NT][4], int m0,
                                               int n0, int n_step) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xb1[2][MT][4], xs1[2][MT][4], xb2[2][MT][4], xs2[2][MT][4];
    split_a<MT>(x1, m0, k0, xb1, xs1);
    split_a<MT>(x2, m0, k0, xb2, xs2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + n_step * j + g;
      uint32_t wb1[2][2], ws1[2][2], wb2[2][2], ws2[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 p1 = w1(n, k0 + 8 * h + t + 4 * r), p2 = w2(n, k0 + 8 * h + t + 4 * r);
          wb1[h][r] = p1.x;
          ws1[h][r] = p1.y;
          wb2[h][r] = p2.x;
          ws2[h][r] = p2.y;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma3x2_apart(acc1[i][j], xb1[0][i], xs1[0][i], wb1[0], ws1[0], xb1[1][i], xs1[1][i],
                     wb1[1], ws1[1]);
        mma3x2_apart(acc2[i][j], xb2[0][i], xs2[0][i], wb2[0], ws2[0], xb2[1][i], xs2[1][i],
                     wb2[1], ws2[1]);
      }
    }
  }
}

// the C fragment of one tile at rows m0 .. m0 + 15, cols n0 .. n0 + 7:
// f(row, col, v0, v1) for the two pairs of neighbouring columns a lane holds
template <class F>
__device__ __forceinline__ void for_fragment(const float c[4], int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  f(m0 + g, n0 + 2 * t, c[0], c[1]);
  f(m0 + g + 8, n0 + 2 * t, c[2], c[3]);
}

}  // namespace tc
