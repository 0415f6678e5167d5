// Warp-level tensor-core products for the bf16 forms of the fused AA
// kernels, K3b (aa_fused.cu) and K4b (aa_fused_bwd_bf16.cu), which compute as
// the JAX package's pair_chain does with compute_dtype "bfloat16": the
// chain's three products take bf16 operands (the LayerNorm outputs a0, a1
// and nbr, and w1, wagg and wkv rounded to bf16) and sum in f32.  Include
// after mma_tf32.cuh, whose mma, split_a and Trans the two-term products
// below use.
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 multiplies a 16 x 16
// tile of A by a 16 x 8 tile of B into a 16 x 8 f32 tile C.  Lane
// (g, t) = (lane / 4, lane % 4) holds (PTX ISA, "Matrix fragments for
// mma.m16n8k16 with floating point type"), each register two bf16 values,
// the lower column (or depth) in the low half:
//   A (row m, depth k): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//   B (depth k, col n): b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (row m, col n):   as m16n8k8's (mma_tf32.cuh)
// The product of two bf16 values is exact in f32, so one term per product
// is the whole of JAX's arithmetic; only the sums differ.  The tensor cores
// cut their sums (mma_tf32.cuh, scripts/probe_mma_rounding_torch.py), so
// each two k-steps (32 terms) go into a fresh fragment, which is added to
// the f32 accumulator on the CUDA cores, rounded to nearest.
//
// K4b's backward products pair an f32 cotangent with a bf16 operand (a
// weight, or a LayerNorm output).  A bf16 value is exact in TF32, so
// mma_tf32.cuh's three-term split loses the terms of the exact operand's
// small part: two TF32 products per k-step (the cotangent's small part
// times the exact operand, then its big part), at f32 accuracy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// two f32 values as one bf16x2 register: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16 value as the f32 (and TF32) bit pattern of the same number
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// B of x W from a transposed bf16 W^T [N][ld] in shared memory, as
// mma_xwt_bf16's w: (n, k even) -> W^T[n][k] and W^T[n][k + 1]
struct WBf {
  const __nv_bfloat16* p;
  int ld;
  __device__ __forceinline__ uint32_t operator()(int n, int k) const {
    return *reinterpret_cast<const uint32_t*>(p + n * ld + k);
  }
};

// c += a b for one 16 x 8 x 16 tile, bf16 operands, f32 sum
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += X W^T in bf16: acc[i][j] += sum_k X[m0 + 16 i + r][k] W[n0 + n_step j + c][k]
// for this warp's MT x NT tiles (r < 16, c < 8, k < K, K a multiple of 32).
// The accessors return bf16x2 registers: x(m, k) holds X[m][k] and X[m][k + 1],
// w(n, k) holds W[n][k] and W[n][k + 1] (k even).  Two k-steps a fresh
// fragment, added to acc in f32 (see above).  The order of each element's
// sum does not depend on MT, NT or which warp owns a tile, so K3b and K4b's
// recompute give the same bits.
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW>
__device__ __forceinline__ void mma_xwt_bf16(const AccX& x, const AccW& w, int m0, int n0,
                                             int n_step, float acc[MT][NT][4]) {
  static_assert(K % 32 == 0, "two k-steps of 16 a fragment");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[2][MT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = m0 + 16 * i + g, k = k0 + 16 * h + 2 * t;
        a[h][i][0] = x(m, k);
        a[h][i][1] = x(m + 8, k);
        a[h][i][2] = x(m, k + 8);
        a[h][i][3] = x(m + 8, k + 8);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + n_step * j + g;
      uint32_t b[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[h][0] = w(n, k0 + 16 * h + 2 * t);
        b[h][1] = w(n, k0 + 16 * h + 2 * t + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c, a[0][i], b[0]);
        mma_bf16(c, a[1][i], b[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
      }
    }
  }
}

// acc += X W^T in two TF32 terms with W exact in TF32 (bf16 values):
// w(n, k) -> the f32 bit pattern of W[n][k]; X is split as in mma_xwt.
// Per two k-steps: xs0 w0, xb0 w0, xs1 w1, xb1 w1 into a fresh fragment,
// added to acc on the CUDA cores.
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW>
__device__ __forceinline__ void mma_xwt_exact_w(const AccX& x, const AccW& w, int m0, int n0,
                                                float acc[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xb[2][MT][4], xs[2][MT][4];
    split_a<MT>(x, m0, k0, xb, xs);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t wv[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wv[h][0] = w(n, k0 + 8 * h + t);
        wv[h][1] = w(n, k0 + 8 * h + t + 4);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(c, xs[0][i], wv[0]);
        mma(c, xb[0][i], wv[0]);
        mma(c, xs[1][i], wv[1]);
        mma(c, xb[1][i], wv[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
      }
    }
  }
}

// acc += X W^T in two TF32 terms with X exact in TF32 (bf16 values, read
// as f32 through x(m, k)); W is split.  Per two k-steps: x0 ws0, x0 wb0,
// x1 ws1, x1 wb1 into a fresh fragment, added to acc on the CUDA cores.
template <int MT, int NT, int K, int UNROLL, class AccX, class AccW>
__device__ __forceinline__ void mma_xwt_exact_x(const AccX& x, const AccW& w, int m0, int n0,
                                                float acc[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t xv[2][MT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = m0 + 16 * i + g, k = k0 + 8 * h;
        xv[h][i][0] = __float_as_uint(x(m, k + t));
        xv[h][i][1] = __float_as_uint(x(m + 8, k + t));
        xv[h][i][2] = __float_as_uint(x(m, k + t + 4));
        xv[h][i][3] = __float_as_uint(x(m + 8, k + t + 4));
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
        mma(c, xv[0][i], ws[0]);
        mma(c, xv[0][i], wb[0]);
        mma(c, xv[1][i], ws[1]);
        mma(c, xv[1][i], wb[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[e];
      }
    }
  }
}

// acc += X^T Y with X exact in TF32 (a weight gradient x^T dY over K rows,
// x a bf16 LayerNorm output): mma_xwt_exact_x on the transposes
template <int MT, int NT, int K, int UNROLL, class AccX, class AccY>
__device__ __forceinline__ void mma_xty_exact_x(const AccX& x, const AccY& y, int m0, int n0,
                                                float acc[MT][NT][4]) {
  mma_xwt_exact_x<MT, NT, K, UNROLL>(Trans<AccX>{x}, Trans<AccY>{y}, m0, n0, acc);
}

}  // namespace tc
