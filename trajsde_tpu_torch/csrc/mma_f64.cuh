// Warp-level products of f32 operands on the FP64 tensor cores (DMMA), for
// the fourteen products of K2 (sde_rollout_bwd.cu).
//
// mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 (PTX ISA 7.8, sm_90)
// multiplies a 16 x 8 tile of A by an 8 x 8 tile of B into a 16 x 8 f64
// tile C, one warp at a time, with the fragment layout of the TF32
// m16n8k8 (mma_tf32.cuh): lane (g, t) = (lane / 4, lane % 4) holds
//   A (row m, depth k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (depth k, col n): b0 (t, g), b1 (t + 4, g)
//   C (row m, col n):   c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Each f32 operand widens to f64 exactly, so every product is exact, and an
// f64 sum of 16 of them lies far below f32's ulp: no operand is split and
// nothing is cut toward zero, as the TF32 tensor cores cut their sums.  The
// products of two k-steps go into a fresh f64 fragment, which is rounded to
// nearest f32 once and added to an f32 accumulator on the CUDA cores; an
// f64 accumulator (V = double) takes them as the mma's C, unrounded.
//
// The operands are read through accessors: (row, col) -> the value (f32
// for an activation tile, f64 for a weight widened beforehand), so a tile's
// layout stays with its caller.
#pragma once

#include <cuda_runtime.h>

namespace dtc {

// c += a b for one 16 x 8 x 8 tile in f64
__device__ __forceinline__ void mma(double c[4], const double a[4], const double b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc += A B over two k-steps (h = 0, 1): both products into a fresh f64
// fragment, rounded to nearest f32 and added to acc
__device__ __forceinline__ void mma_x2(float acc[4], const double a0[4], const double b0[2],
                                       const double a1[4], const double b1[2]) {
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  mma(c, a0, b0);
  mma(c, a1, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += static_cast<float>(c[e]);
}

// acc += A B over two k-steps into an f64 accumulator: the products go
// straight into acc, the mma's own C
__device__ __forceinline__ void mma_x2(double acc[4], const double a0[4], const double b0[2],
                                       const double a1[4], const double b1[2]) {
  mma(acc, a0, b0);
  mma(acc, a1, b1);
}

// the A fragments of a k-step pair (k0, k0 + 8) of MT tiles, widened
template <int MT, class AccX>
__device__ __forceinline__ void load_a(const AccX& x, int m0, int k0, double xa[2][MT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i + g, k = k0 + 8 * h;
      xa[h][i][0] = x(m, k + t);
      xa[h][i][1] = x(m + 8, k + t);
      xa[h][i][2] = x(m, k + t + 4);
      xa[h][i][3] = x(m + 8, k + t + 4);
    }
}

// the B fragments of a k-step pair at column n: w(n, k) -> the value
template <class AccW>
__device__ __forceinline__ void load_b(const AccW& w, int n, int k0, double wb[2][2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) wb[h][r] = w(n, k0 + 8 * h + t + 4 * r);
}

// the transpose of an accessor: (r, c) -> x(c, r)
template <class Acc>
struct Trans {
  Acc x;
  __device__ __forceinline__ auto operator()(int r, int c) const { return x(c, r); }
};

// acc += X W^T: acc[i][j] += sum_k x(m0 + 16 i + r, k) w(n0 + n_step j + c, k)
// for this warp's MT x NT tiles (r < 16, c < 8, k < K), X [M][K] and W [N][K]
// by rows; the NT tiles lie n_step columns apart (K2's warps take n-tiles j
// and j + 4).  K is a multiple of 16.  X's fragments are loaded once for
// all NT tiles.
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW, class V>
__device__ __forceinline__ void mma_xwt(const AccX& x, const AccW& w, int m0, int n0, int n_step,
                                        V acc[MT][NT][4]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    double xa[2][MT][4];
    load_a<MT>(x, m0, k0, xa);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      double wb[2][2];
      load_b(w, n0 + n_step * j + g, k0, wb);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_x2(acc[i][j], xa[0][i], wb[0], xa[1][i], wb[1]);
    }
  }
}

// two products of mma_xwt in one loop, acc1 += X1 W1^T and acc2 += X2 W2^T,
// so that their fragments interleave
template <int MT, int NT, int K, int UNROLL, class AccX1, class AccW1, class AccX2, class AccW2,
          class V>
__device__ __forceinline__ void mma_xwt2(const AccX1& x1, const AccW1& w1, V acc1[MT][NT][4],
                                         const AccX2& x2, const AccW2& w2, V acc2[MT][NT][4],
                                         int m0, int n0, int n_step) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    double xa1[2][MT][4], xa2[2][MT][4];
    load_a<MT>(x1, m0, k0, xa1);
    load_a<MT>(x2, m0, k0, xa2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + n_step * j + g;
      double wb1[2][2], wb2[2][2];
      load_b(w1, n, k0, wb1);
      load_b(w2, n, k0, wb2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_x2(acc1[i][j], xa1[0][i], wb1[0], xa1[1][i], wb1[1]);
        mma_x2(acc2[i][j], xa2[0][i], wb2[0], xa2[1][i], wb2[1]);
      }
    }
  }
}

// acc += X^T Y: X [K][M] and Y [K][N] by rows (a weight gradient x^T dY,
// summed over K rows); the NT tiles lie 8 columns apart
template <int MT, int NT, int K, int UNROLL, class AccX, class AccY>
__device__ __forceinline__ void mma_xty(const AccX& x, const AccY& y, int m0, int n0,
                                        float acc[MT][NT][4]) {
  mma_xwt<MT, NT, K, UNROLL>(Trans<AccX>{x}, Trans<AccY>{y}, m0, n0, 8, acc);
}

// two weight gradients of mma_xty in one loop, acc1 += X1^T Y1 and
// acc2 += X2^T Y2
template <int MT, int NT, int K, int UNROLL, class AccX1, class AccY1, class AccX2, class AccY2>
__device__ __forceinline__ void mma_xty2(const AccX1& x1, const AccY1& y1, float acc1[MT][NT][4],
                                         const AccX2& x2, const AccY2& y2, float acc2[MT][NT][4],
                                         int m0, int n0) {
  mma_xwt2<MT, NT, K, UNROLL>(Trans<AccX1>{x1}, Trans<AccY1>{y1}, acc1, Trans<AccX2>{x2},
                              Trans<AccY2>{y2}, acc2, m0, n0, 8);
}

// the C fragment of one tile at rows m0 .. m0 + 15, cols n0 .. n0 + 7:
// f(row, col, v0, v1) for the two pairs of neighbouring columns a lane holds
template <class F>
__device__ __forceinline__ void for_fragment(const float c[4], int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  f(m0 + g, n0 + 2 * t, c[0], c[1]);
  f(m0 + g + 8, n0 + 2 * t, c[2], c[3]);
}

}  // namespace dtc
