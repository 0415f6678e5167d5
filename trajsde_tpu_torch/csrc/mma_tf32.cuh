// Warp-level tensor-core products at f32 accuracy (3xTF32) over operands in
// shared memory, for the backward products of K4 (aa_fused_bwd.cu).
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
      for (int i = 0; i < MT; ++i) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(c, xs[h][i], wb[h]);
          mma(c, xb[h][i], ws[h]);
          mma(c, xb[h][i], wb[h]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
      }
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
// summed over K rows of pairs)
template <int MT, int NT, int K, int UNROLL, class AccX, class AccY>
__device__ __forceinline__ void mma_xty(const AccX& x, const AccY& y, int m0, int n0,
                                        float acc[MT][NT][4]) {
  mma_xwt<MT, NT, K, UNROLL>(Trans<AccX>{x}, Trans<AccY>{y}, m0, n0, acc);
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
