// Fused AA pair chain, backward (kernel K4): the VJP of K3 (aa_fused.cu)
// for training with encoder.fused: true.  Its bf16 form K4b, the VJP of
// K3b, is a kernel of its own (aa_fused_bwd_bf16.cu).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_fused.py::_bwd_call
// (pallas_call body _bwd_kernel, which recomputes pair_chain under jax.vjp).
// Given the cotangent g [R, 64] of K3's output out, it returns dq [R, 64]
// and the gradients of the 14 packed weights; u, mask and keep get none
// (u is a function of the scene only, as in the JAX op).  Per pair (r, j),
// with keep' = keep / (1 - p) (or 1) and K3's softmax statistics (max m,
// sum l) of receiver r and head h:
//   recompute the chain: a0, xhat/1-over-std of the three LayerNorms, a1,
//     nbr, k, v (K3's own product and epilogue calls, w1 folded);
//   alpha = exp(q.k / sqrt(hd) - m) / l   (0 for a masked pair or empty receiver)
//   dlogit = alpha (keep' g.v - g.out)     (flash-attention identity:
//            sum_j alpha keep' g.v_j = g.out, so one pass suffices)
//   dk = dlogit q / sqrt(hd),  dv = alpha keep' g,  dq += dlogit k / sqrt(hd)
//   dnbr = [dk|dv] wkv^T -> LN VJP -> dy3;  da1 = dy3 wagg^T -> ReLU, LN VJP
//   -> dz;  dz1 = [dz | dz];  da0 = dz1 w1^T -> ReLU, the two per-branch LN
//   VJPs -> dh;  and the weight gradients nbr^T dkv, a1^T dy3, a0^T dz1,
//   u^T dh, the column sums for the biases and LayerNorm parameters.
// The full [2D, 2D] dw1 is returned (its two column halves are equal, as
// dz1 is), since the JAX op holds for any weights.
//
// Bound on an H100 SXM at the training twin shape (B 128, T 21, Aq 49, Ak 48,
// D 64, H 8: 6.32 M pairs): three times K3's matrix and elementwise
// operations per pair (recompute, input gradients, weight gradients),
// 8.3e11 f32 operations, 12.4 ms at the 67 TFLOP/s CUDA-core peak; the
// inputs (with the keep mask), dq and the weight gradients are 0.43 GB,
// 0.13 ms at 3.35 TB/s.  (At the HiVT baseline's shape, B 128, T 21,
// Aq = Ak = 48, H 4: 6.19 M pairs, 12.1 ms and 4.6 ms on the route.)
// K4 is bound by arithmetic.  On the route it takes, the recompute's three
// products and the six backward products below (30 D^2 = 122,880 of the
// 131,256 operations a pair needs) run on the tensor cores at f32
// accuracy, 3 TF32 products each, so at most 495 / 3 = 165 TFLOP/s:
// 4.7 ms; the rest stays on the CUDA cores, 0.8 ms.  The two pipes run at
// the same time (an mma.sync m16n8k8 takes one issue slot for 2,048
// flops), so the route's bound is 4.7 ms.
//
// Design.  As K3: a persistent grid (one 256-thread block per SM) walks
// groups of 8 receivers with all their senders, in chunks of 32 pairs.
//   * The softmax needs no second walk: K3 wrote each (receiver, head)'s max
//     and sum, and g.out per (receiver, head) is read once per group.
//   * The recompute (F1-F4) is K3's: its three products go through
//     mma_tf32.cuh's mma_xwt_split over the same operands (w1 folded when
//     staged, w1f = w1[:, :D] + w1[:, D:], b1f = b1[:D] + b1[D:]) and its
//     epilogues through aa_common.cuh's epi_a1, epi_nbr, epi_bias and
//     head_logit, so every per-row value of the chain and the logits are
//     bit for bit the ones whose softmax statistics K3 wrote; another
//     rounding would leave a larger residue S for the dq correction below.
//     K3 splits its weights once per block; K4 has no room for the split
//     copies and splits each weight where it reads it (tc::SplitAtUse),
//     into the same bits.  The tiling differs (K3's and K4's warps own the
//     same tiles here, but need not): the order of each element's sums
//     does not.
//   * The six backward products run on the tensor cores (mma_tf32.cuh:
//     mma.sync m16n8k8 TF32, each operand split into two TF32 terms, three
//     products per tile and k-step, two k-steps summed in a fresh fragment
//     and added to f32 accumulators on the CUDA cores): the input gradients
//     dnbr = dkv wkv^T (B2), da1 = dy3 wagg^T (B3) and da0 = dz w1f^T (B4,
//     the staged folded w1: dz1 = [dz | dz]), and the weight gradients
//     nbr^T dkv, a1^T dy3 and a0^T dz.  One TF32 product alone (about
//     2^-11 per operand) would move the smooth leaves 3 orders of
//     magnitude from the f32 gradient (tests/test_torch_aa_fused_tf32.py
//     emulates both on the CPU).
//   * Shared memory: the weights, staged once per block with padded row
//     strides (w1f 68, wagg 68, wkv 132 floats), so the B fragments of X W^T
//     read 8 rows at one column from 32 banks (91,648 B; the forward
//     products' reads of W[k][n] are 2-way conflicts); nine chunk tiles (a0,
//     k|v then dk|dv then d(pre-ReLU a0), the LayerNorms' xhat, a1, nbr and
//     three gradient tiles, 90,112 B); the group's q, g, dq and statistics,
//     the two sums of the dq correction below; the vector gradients.
//     200,064 B in all, one block per SM.  The four tiles that only the
//     backward reads or writes (k|v, dnbr, dy3, dz) are swizzled
//     (aa_common.cuh's swz: an XOR of each row's 16-byte granules, no
//     bytes), which puts every fragment read of them in 32 banks and keeps
//     the epilogues' float4s whole.  The recompute's three (a0, a1, nbr)
//     have their rows padded by 4 floats instead (132, 68, 68): the A
//     fragments of its products are read conflict-free, their transposed
//     reads by the weight gradients are 2-way conflicts (4-way unpadded),
//     and the simpler index saves the registers that the swizzle's cost
//     (swizzled, K4 spilled 32-40 B at 255 registers).  The xhat tiles are
//     read by rows only.
//     A weight gradient accumulator beside the weights would not fit, so:
//   * the three matrix gradients (a0^T dz: 128 x 64, nbr^T dkv: 64 x 128,
//     a1^T dy3: 64 x 64) are the C fragments of each warp's 16 x 8 tiles,
//     80 floats a thread, accumulated over one receiver group's pairs; the
//     vector gradients (1,408 floats) sit in shared memory, each column
//     summed by one thread in pair order;
//   * at the end of each group the block adds them into its own slice of a
//     [grid, W_FLOATS] f64 workspace in device memory (31.8 MB at 132
//     blocks, L2-resident); reduce_partials then sums the slices in block
//     order, in f64.  So no f32 sum runs over more than a group's 384 pairs
//     (on an H100 at the training shape, one serial f32 sum over a block's
//     48 k pairs doubled the error of the deeper gradients, and f32 sums
//     over a block's groups left lna1s 3x farther from an f64 oracle than
//     autograd's), no float atomics are used, and reruns are bit-equal (as
//     K2).
//   * dq: sum_j dlogit_j is 0 in exact arithmetic, but K4's dlogit uses
//     g . out from K3's output while alpha is recomputed, and their rounding
//     leaves sum_j dlogit_j = S != 0; dq = sum_j dlogit_j k_j then carries
//     S times the mean key, which can be far larger than dq (2.7-6x
//     autograd's distance from an f64 oracle, on an H100).  So the walk also
//     sums sum_j alpha_j k_j and S per (receiver, head) and subtracts
//     S sum_j alpha_j k_j.
//   * The gradients behind a ReLU's derivative (wu .. lna0b) jump where a
//     pre-ReLU value is 0 to within rounding: there K4, autograd in f32 and
//     f64 may fall on different sides, one element's whole contribution
//     apart, which no summation order changes
//     (scripts/check_aa_bwd_f64_torch.py counts such elements).
// Heads: as K3, a template on the head count H (8, the flagship's; 4, the
// HiVT baseline's) with an entry point each; a head's HD = 64 / H columns
// lie in HD / 4 lanes of a row, over which head_logit and g.v are summed
// by aa_common.cuh's butterfly (head_sum), and the head's first lane
// writes dlogit and alpha.  The products and their tiles do not depend on H.
// Each thread owns 2 rows of a chunk for the CUDA-core work: columns
// c0..c0+3 (and D + c0..) of the recompute's epilogues, as K3, and the
// strided columns cg + 16 m of the backward epilogues; a row's columns sit
// in 16 lanes of one warp, so the LayerNorm VJPs' row sums are shuffles.
// An input gradient's tiles are spread over the 8 warps and land in a chunk
// tile, read back by the epilogue after one barrier; so do the recompute's
// products, whose epilogues then run per row.  dq is summed per (receiver, column) by one
// thread in pair order.  TF32 appears only in the three-term form above.
// The ragged last chunk and group are bounds-checked: dead rows carry zero
// cotangents and add exact zeros.  Pair offsets are 64-bit.
// ptxas (sm_90a): 254 registers, no spills, 200,064 B of shared memory.
// Measured with scripts/compare_aa_bwd_builds_torch.py on an H100: 40.2-40.5
// ms against 46.8-47.1 with the recompute's products as f32 FMAs; the
// swizzle saves 1.9 ms; with the six backward products skipped the rest
// takes 26.8-27.0 ms, with the recompute's three skipped 33.0 ms.

#include "aa_common.cuh"
#include "mma_tf32.cuh"
#include "aa_bwd_common.cuh"

namespace {

using namespace aa;
using namespace aa_bwd;

constexpr int LW1 = D + 4;     // padded row strides of the staged matrices
constexpr int LWKV = D2 + 4;
constexpr int LWAGG = D + 4;

// staged weights (floats): the packed layout with padded matrix rows and
// w1 folded, w1f = w1[:, :D] + w1[:, D:] [2D][D] and b1f = b1[:D] + b1[D:]
constexpr int S_WU = 0;                        // wu, bu, ln0s, ln0b as packed
constexpr int S_BU = S_WU + (OFF_BU - OFF_WU);
constexpr int S_LN0S = S_WU + (OFF_LN0S - OFF_WU);
constexpr int S_LN0B = S_WU + (OFF_LN0B - OFF_WU);
constexpr int S_W1 = S_WU + (OFF_W1 - OFF_WU);  // [2D][LW1] w1f
constexpr int S_B1 = S_W1 + D2 * LW1;           // [D] b1f, then lna0s, lna0b as packed
constexpr int S_LNA0S = S_B1 + D;
constexpr int S_LNA0B = S_LNA0S + D;
constexpr int S_WAGG = S_LNA0B + D;             // [D][LWAGG]
constexpr int S_BAGG = S_WAGG + D * LWAGG;      // bagg, lna1s, lna1b as packed
constexpr int S_LNA1S = S_BAGG + (OFF_LNA1S - OFF_BAGG);
constexpr int S_LNA1B = S_BAGG + (OFF_LNA1B - OFF_BAGG);
constexpr int S_WKV = S_BAGG + (OFF_WKV - OFF_BAGG);  // [D][LWKV]
constexpr int S_BKV = S_WKV + D * LWKV;
constexpr int SW_FLOATS = S_BKV + D2;

// chunk tiles
constexpr int LA0 = D2 + 4;    // padded row strides of the recompute's tiles
constexpr int LAC = D + 4;
constexpr int T_A0 = SW_FLOATS;                // [P][LA0] a0, then dh
constexpr int T_KV = T_A0 + P * LA0;           // [P][2D] k|v, then dk|dv, then dpre0
constexpr int T_XB = T_KV + P * D2;            // [P][D] xhat of LN(a1 wagg + bagg)
constexpr int T_NB = T_XB + P * D;             // [P][LAC] nbr (T_XB..: [P][2D] xhat0)
constexpr int T_X0 = T_XB;
constexpr int T_XA = T_NB + P * LAC;           // [P][D] xhat of LN(z1[:D] + z1[D:])
constexpr int T_A1 = T_XA + P * D;             // [P][LAC] a1
constexpr int T_DN = T_A1 + P * LAC;           // [P][D] dnbr, then d(pre-ReLU a1)
constexpr int T_DY = T_DN + P * D;             // [P][D] dy3
constexpr int T_DZ = T_DY + P * D;             // [P][D] dz
constexpr int S_U = T_DZ + P * D;              // [P][4]
constexpr int S_MASK = S_U + P * 4;            // [P]
constexpr int T_AL = T_DZ;                     // [P][H] alpha, until dz is written
// the rest of the layout, per head count H
template <int H>
struct Smem {
  static constexpr int S_DL = S_MASK + P;        // [P][H] dlogit
  static constexpr int S_INVA = S_DL + P * H;    // [P]
  static constexpr int S_INVB = S_INVA + P;      // [P]
  // group state
  static constexpr int S_Q = S_INVB + P;         // [RB][D]
  static constexpr int S_G = S_Q + RB * D;       // [RB][D]
  static constexpr int S_DQ = S_G + RB * D;      // [RB][D]
  static constexpr int S_SM = S_DQ + RB * D;     // [RB][H] softmax max (K3)
  static constexpr int S_SL = S_SM + RB * H;     // [RB][H] softmax sum (K3)
  static constexpr int S_DELTA = S_SL + RB * H;  // [RB][H] g . out per head
  static constexpr int S_AK = S_DELTA + RB * H;  // [RB][D] sum_j alpha_j k_j
  static constexpr int S_DS = S_AK + RB * D;     // [RB][H] sum_j dlogit_j
  static constexpr int S_VG = S_DS + RB * H;     // [V_FLOATS] vector gradients
  static constexpr int S_FLOATS = S_VG + V_FLOATS;

  static_assert(S_W1 % 4 == 0 && S_WAGG % 4 == 0 && S_WKV % 4 == 0 && T_A0 % 4 == 0 &&
                S_Q % 4 == 0, "float4 alignment");
  static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");
};

// shared-memory index of packed weight float i, from wu to ln0b and from
// lna0s on (w1 and b1 are staged folded)
__device__ __forceinline__ int staged(int i) {
  if (i < OFF_W1) return S_WU + i;
  if (i < OFF_WAGG) return S_LNA0S + (i - OFF_LNA0S);
  if (i < OFF_BAGG) return S_WAGG + ((i - OFF_WAGG) / D) * LWAGG + (i - OFF_WAGG) % D;
  if (i < OFF_WKV) return S_BAGG + (i - OFF_BAGG);
  if (i < OFF_BKV) return S_WKV + ((i - OFF_WKV) / D2) * LWKV + (i - OFF_WKV) % D2;
  return S_BKV + (i - OFF_BKV);
}

// *dst = v on a block's first group, else *dst += v, in f64 (dst: the
// block's own slice of the workspace, written only by this thread)
__device__ __forceinline__ void put(double* dst, float v, bool first) {
  *dst = first ? static_cast<double>(v) : *dst + static_cast<double>(v);
}

__device__ __forceinline__ void put2(double* dst, float v0, float v1, bool first) {
  double2* d = reinterpret_cast<double2*>(dst);
  double2 v = make_double2(v0, v1);
  if (!first) {
    const double2 a = *d;
    v.x += a.x;
    v.y += a.y;
  }
  *d = v;
}

struct WFwd {  // B of x W from a staged W [K][N]: w(n, k) = W[k][n], split where read
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int n, int k) const { return p[k * ld + n]; }
};

#ifdef AA_WRITE_LOGITS
__device__ float* g_logits;  // [R * Ak][H]
#endif

// read a block-private gradient and zero it for the next group
__device__ __forceinline__ float take(float* v) {
  const float x = *v;
  *v = 0.0f;
  return x;
}

// sum over the chunk's pairs of a(p, col) (times b(p, col))
template <class A>
__device__ __forceinline__ float colsum(const A& a, int col) {
  float s = 0.0f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) s += a(p, col);
  return s;
}

template <class A, class B>
__device__ __forceinline__ float colsum(const A& a, const B& b, int col) {
  float s = 0.0f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) s += a(p, col) * b(p, col);
  return s;
}

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
aa_fused_bwd_kernel(const float* __restrict__ q, const float* __restrict__ u,
                    const float* __restrict__ mask, const float* __restrict__ keep,
                    const float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ out, const float* __restrict__ stats,
                    float* __restrict__ dq, double* __restrict__ partial, long long R, int Ak,
                    float keep_scale) {
  using L = Smem<H>;
  constexpr int HD = Heads<H>::HD;
  constexpr int HL = Heads<H>::LANES;
  constexpr float SCALE = Heads<H>::SCALE;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* a0t = smem + T_A0;
  float* kvt = smem + T_KV;
  float* xbt = smem + T_XB;
  float* nbt = smem + T_NB;
  float* x0t = smem + T_X0;
  float* xat = smem + T_XA;
  float* a1t = smem + T_A1;
  float* dnt = smem + T_DN;
  float* dyt = smem + T_DY;
  float* dzt = smem + T_DZ;
  float* su = smem + S_U;
  float* smask = smem + S_MASK;
  float* sdl = smem + L::S_DL;
  float* sinva = smem + L::S_INVA;
  float* sinvb = smem + L::S_INVB;
  float* sq = smem + L::S_Q;
  float* sg = smem + L::S_G;
  float* sdq = smem + L::S_DQ;
  float* ssm = smem + L::S_SM;
  float* ssl = smem + L::S_SL;
  float* sdelta = smem + L::S_DELTA;
  float* sak = smem + L::S_AK;
  float* sds = smem + L::S_DS;
  float* salpha = smem + T_AL;
  float* vg = smem + L::S_VG;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // column group
  const int c0 = cg * 4;        // forward products: columns c0 .. c0+3 (and D + ...)
  const int rg = tid >> 4;      // row group
  const int r0 = rg * NR;
  const int warp = tid >> 5;    // tensor-core products: this warp's tiles

  for (int i = tid; i < W_FLOATS; i += THREADS)
    if (i < OFF_W1 || i >= OFF_LNA0S) sw[staged(i)] = w[i];
  for (int i = tid; i < D2 * D; i += THREADS) {  // w1 folded, as K3 stages it
    const int r = i / D, c = i % D;
    sw[S_W1 + r * LW1 + c] = w[OFF_W1 + r * D2 + c] + w[OFF_W1 + r * D2 + D + c];
  }
  if (tid < D) sw[S_B1 + tid] = w[OFF_B1 + tid] + w[OFF_B1 + D + tid];
  for (int i = tid; i < V_FLOATS; i += THREADS) vg[i] = 0.0f;

  double* part = partial + static_cast<size_t>(blockIdx.x) * W_FLOATS;  // this block's slice
  // the group's matrix gradients, C fragments of this warp's 16 x 8 tiles:
  // a0^T dz [128 x 64] rows 16 warp.., all 8 column tiles; nbr^T dkv
  // [64 x 128] rows 16 (warp % 4).., columns 64 (warp / 4) + 8 j; a1^T dy3
  // [64 x 64] rows 16 (warp % 4).., columns 32 (warp / 4) + 8 j
  float gw1[1][8][4], gkv[1][8][4], gagg[1][4][4];
  const int wm = 16 * (warp & 3);

  const long long groups = (R + RB - 1) / RB;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long rbase = grp * RB;
    const int nrecv = static_cast<int>(R - rbase < RB ? R - rbase : RB);
    const int npairs = nrecv * Ak;
    const long long pbase = rbase * Ak;
    zero_tiles<1, 8>(gw1);
    zero_tiles<1, 8>(gkv);
    zero_tiles<1, 4>(gagg);

    __syncthreads();  // the previous group's dq is written out
    for (int i = tid; i < RB * D; i += THREADS) {
      const int rl = i / D;
      const long long at = (rbase + rl) * D + (i % D);
      sq[i] = rl < nrecv ? q[at] : 0.0f;
      sg[i] = rl < nrecv ? g[at] : 0.0f;
      sdq[i] = 0.0f;
      sak[i] = 0.0f;
    }
    for (int i = tid; i < RB * H; i += THREADS) {
      const int rl = i / H;
      const bool live = rl < nrecv;
      ssm[i] = live ? stats[rbase * H + i] : 0.0f;
      ssl[i] = live ? stats[(R + rbase) * H + i] : 0.0f;  // 0: no alpha
      sds[i] = 0.0f;
      float s = 0.0f;
      if (live) {
        const long long at = (rbase + rl) * D + (i % H) * HD;
        for (int j = 0; j < HD; ++j) s = fmaf(g[at + j], out[at + j], s);
      }
      sdelta[i] = s;
    }

    for (int cp0 = 0; cp0 < npairs; cp0 += P) {
      const int pend = min(cp0 + P, npairs);  // group-relative, exclusive
      const long long gp0 = pbase + cp0;

      __syncthreads();  // the previous chunk's tiles are read out
      if (tid < P * 4) su[tid] = cp0 + tid / 4 < pend ? u[gp0 * 4 + tid] : 0.0f;
      if (tid < P) smask[tid] = cp0 + tid < pend ? mask[gp0 + tid] : 0.0f;
      __syncthreads();

      // F1. h = bu + u wu; a0 = relu(LN per branch) -> a0t
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float* up = su + (r0 + i) * 4;
        float hv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = half * D + c0 + j;
            float s = up[0] * sw[S_WU + col] + up[1] * sw[S_WU + D2 + col];
            s += up[2] * sw[S_WU + 2 * D2 + col];
            s += up[3] * sw[S_WU + 3 * D2 + col];
            hv[half][j] = sw[S_BU + col] + s;
          }
        ln_row(hv[0], sw + S_LN0S, sw + S_LN0B, c0, true);
        ln_row(hv[1], sw + S_LN0S + D, sw + S_LN0B + D, c0, true);
        store4(a0t + (r0 + i) * LA0 + c0, hv[0]);
        store4(a0t + (r0 + i) * LA0 + D + c0, hv[1]);
      }
      __syncthreads();

      // F2. a0 w1f -> a1t; a1 = relu(LN(. + b1f)) in place, its xhat -> xat
      // (K3's product and epilogue: the same sums in the same order)
      {
        float acc[1][2][4] = {};
        tc::mma_xwt_split<1, 2, D2, 2>(Plain{a0t, LA0}, tc::SplitAtUse<WFwd>{WFwd{sw + S_W1, LW1}},
                                       16 * (warp & 1), 16 * (warp >> 1), 8, acc);
        tc::store_c<2>(a1t, PadAt{LAC}, acc, 16 * (warp & 1), 16 * (warp >> 1));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x[4], xh[4], inv;
        load4(x, a1t + (r0 + i) * LAC + c0);
        epi_a1(x, sw + S_B1, sw + S_LNA0S, sw + S_LNA0B, c0, xh, &inv);
        store4(a1t + (r0 + i) * LAC + c0, x);
        store4(xat + (r0 + i) * D + c0, xh);
        if (cg == 0) sinva[r0 + i] = inv;
      }
      __syncthreads();

      // F3. a1 wagg -> nbt; nbr = LN(. + bagg) in place, its xhat -> xbt
      {
        float acc[1][2][4] = {};
        tc::mma_xwt_split<1, 2, D, 2>(Plain{a1t, LAC},
                                      tc::SplitAtUse<WFwd>{WFwd{sw + S_WAGG, LWAGG}},
                                      16 * (warp & 1), 16 * (warp >> 1), 8, acc);
        tc::store_c<2>(nbt, PadAt{LAC}, acc, 16 * (warp & 1), 16 * (warp >> 1));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x[4], xh[4], inv;
        load4(x, nbt + (r0 + i) * LAC + c0);
        epi_nbr(x, sw + S_BAGG, sw + S_LNA1S, sw + S_LNA1B, c0, xh, &inv);
        store4(nbt + (r0 + i) * LAC + c0, x);
        store4(xbt + (r0 + i) * D + c0, xh);
        if (cg == 0) sinvb[r0 + i] = inv;
      }
      __syncthreads();

      // F4. nbr wkv -> kvt; [k | v] + bkv; alpha from K3's statistics;
      // dlogit -> sdl, k -> kvt; dk and dv stay in registers until the dq
      // update has read k
      {
        float acc[1][4][4] = {};
        tc::mma_xwt_split<1, 4, D, 2>(Plain{nbt, LAC},
                                      tc::SplitAtUse<WFwd>{WFwd{sw + S_WKV, LWKV}},
                                      16 * (warp & 1), 32 * (warp >> 1), 8, acc);
        tc::store_c<4>(kvt, SwzAt{D2}, acc, 16 * (warp & 1), 32 * (warp >> 1));
      }
      __syncthreads();
      float dkv[NR][8];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        const bool live = cp0 + p < pend;
        const int rl = live ? (cp0 + p) / Ak : 0;
        const int h = cg / HL;
        float k[4], v[4];
        load4(k, kvt + swz(p, c0, D2));
        load4(v, kvt + swz(p, D + c0, D2));
        epi_bias(k, sw + S_BKV, c0);
        epi_bias(v, sw + S_BKV + D, c0);
        store4(kvt + swz(p, c0, D2), k);
        const float4 qv = ld4(sq + rl * D + c0);
        const float4 gv = ld4(sg + rl * D + c0);
        const float lg = head_logit<H>(qv, k);
        float gdv = gv.x * v[0];
        gdv = fmaf(gv.y, v[1], gdv);
        gdv = fmaf(gv.z, v[2], gdv);
        gdv = fmaf(gv.w, v[3], gdv);
        // a head's columns are the 4 of this lane and those of the others of its head
        gdv = head_sum<H>(gdv);
#ifdef AA_WRITE_LOGITS
        if (cg % HL == 0 && live) g_logits[(gp0 + p) * H + h] = smask[p] > 0.0f ? lg : -INFINITY;
#endif
        float dl = 0.0f, ak = 0.0f, al = 0.0f;
        const float lsum = ssl[rl * H + h];
        if (live && smask[p] > 0.0f && lsum > 0.0f) {
          al = expf(lg - ssm[rl * H + h]) / lsum;
          const float kp = (keep == nullptr ? 1.0f : keep[(gp0 + p) * H + h]) * keep_scale;
          ak = al * kp;
          dl = al * (kp * gdv - sdelta[rl * H + h]);
        }
        if (cg % HL == 0) {  // the head's first lane
          sdl[p * H + h] = dl;
          salpha[p * H + h] = al;
        }
        const float dls = dl * SCALE;
        dkv[i][0] = dls * qv.x; dkv[i][1] = dls * qv.y; dkv[i][2] = dls * qv.z; dkv[i][3] = dls * qv.w;
        dkv[i][4] = ak * gv.x; dkv[i][5] = ak * gv.y; dkv[i][6] = ak * gv.z; dkv[i][7] = ak * gv.w;
      }
      __syncthreads();

      // B1. dq[r] += sum_j dlogit_j k_j / sqrt(hd), per (receiver, column),
      // and the sums sum_j alpha_j k_j and sum_j dlogit_j of its correction
      {
        const int rl_lo = cp0 / Ak;
        const int nspan = (pend - 1) / Ak - rl_lo + 1;
        for (int item = tid; item < nspan * D; item += THREADS) {
          const int rl = rl_lo + item / D;
          const int c = item % D;
          const int h = c / HD;
          const int pa = max(cp0, rl * Ak) - cp0;
          const int pb = min(pend, (rl + 1) * Ak) - cp0;
          float s = 0.0f, a = 0.0f, sd = 0.0f;
          for (int p = pa; p < pb; ++p) {
            const float d = sdl[p * H + h], k = kvt[swz(p, c, D2)];
            s = fmaf(d, k, s);
            a = fmaf(salpha[p * H + h], k, a);
            sd += d;
          }
          sdq[rl * D + c] += s * SCALE;
          sak[rl * D + c] += a;
          if (c % HD == 0) sds[rl * H + h] += sd;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        store4(kvt + swz(r0 + i, c0, D2), dkv[i]);
        store4(kvt + swz(r0 + i, D + c0, D2), dkv[i] + 4);
      }
      __syncthreads();

      // B2. dbkv; dwkv += nbr^T dkv; dnbr = dkv wkv^T -> dnt, LN VJP -> dy3
      if (tid < D2) vg[V_BKV + tid] += colsum(Swz{kvt, D2}, tid);
      {
        float dn[1][2][4];
        zero_tiles<1, 2>(dn);
        tc::mma_xty<1, 8, P, 2>(Plain{nbt, LAC}, Swz{kvt, D2}, wm, 64 * (warp >> 2), gkv);
        tc::mma_xwt<1, 2, D2, 2>(Swz{kvt, D2}, Plain{sw + S_WKV, LWKV}, 16 * (warp & 1),
                                 16 * (warp >> 1), dn);
        tc::store_c<2>(dnt, SwzAt{D}, dn, 16 * (warp & 1), 16 * (warp >> 1));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        float dn[4], xh[4], sc[4], dy[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dn[m] = dnt[swz(p, cg + 16 * m, D)];
          xh[m] = xbt[p * D + cg + 16 * m];
          sc[m] = sw[S_LNA1S + cg + 16 * m];
        }
        ln_vjp<4>(dn, xh, sc, sinvb[p], dy);
#pragma unroll
        for (int m = 0; m < 4; ++m) dyt[swz(p, cg + 16 * m, D)] = dy[m];
      }
      __syncthreads();

      // B3. lna1 and bagg gradients; dwagg += a1^T dy3; da1 = dy3 wagg^T
      // (into dzt, free since B1) -> ReLU, LN VJP -> dz
      if (tid < D) vg[V_LNA1B + tid] += colsum(Swz{dnt, D}, tid);
      else if (tid < 2 * D) vg[V_LNA1S + tid - D] += colsum(Swz{dnt, D}, Plain{xbt, D}, tid - D);
      else if (tid < 3 * D) vg[V_BAGG + tid - 2 * D] += colsum(Swz{dyt, D}, tid - 2 * D);
      {
        float da[1][2][4];
        zero_tiles<1, 2>(da);
        tc::mma_xty<1, 4, P, 2>(Plain{a1t, LAC}, Swz{dyt, D}, wm, 32 * (warp >> 2), gagg);
        tc::mma_xwt<1, 2, D, 2>(Swz{dyt, D}, Plain{sw + S_WAGG, LWAGG}, 16 * (warp & 1),
                                16 * (warp >> 1), da);
        tc::store_c<2>(dzt, SwzAt{D}, da, 16 * (warp & 1), 16 * (warp >> 1));
      }
      __syncthreads();  // dnt is read above and rewritten below
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        float da1[4], xh[4], sc[4], dz[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = cg + 16 * m;
          da1[m] = a1t[p * LAC + col] > 0.0f ? dzt[swz(p, col, D)] : 0.0f;
          xh[m] = xat[p * D + col];
          sc[m] = sw[S_LNA0S + col];
        }
        ln_vjp<4>(da1, xh, sc, sinva[p], dz);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dnt[swz(p, cg + 16 * m, D)] = da1[m];
          dzt[swz(p, cg + 16 * m, D)] = dz[m];
        }
      }
      __syncthreads();

      // B4. lna0 and b1 gradients; dw1 += a0^T dz; da0 = dz (w1[:, :D] +
      // w1[:, D:])^T (into kvt, free since B2) -> ReLU, the two branch LN
      // VJPs -> dh
      if (tid < D) vg[V_LNA0B + tid] += colsum(Swz{dnt, D}, tid);
      else if (tid < 2 * D) vg[V_LNA0S + tid - D] += colsum(Swz{dnt, D}, Plain{xat, D}, tid - D);
      else if (tid < 3 * D) vg[V_B1 + tid - 2 * D] += colsum(Swz{dzt, D}, tid - 2 * D);
      {
        float da[1][4][4];
        zero_tiles<1, 4>(da);
        tc::mma_xty<1, 8, P, 2>(Plain{a0t, LA0}, Swz{dzt, D}, 16 * warp, 0, gw1);
        tc::mma_xwt<1, 4, D, 2>(Swz{dzt, D}, Plain{sw + S_W1, LW1}, 16 * (warp & 1),
                                32 * (warp >> 1), da);
        tc::store_c<4>(kvt, SwzAt{D2}, da, 16 * (warp & 1), 32 * (warp >> 1));
      }
      __syncthreads();  // a0t is read above and rewritten below
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        const float* up = su + p * 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // recompute this branch's LayerNorm input h and its statistics
          float xh[4], sc[4], dh[4], dpre[4], sum = 0.0f, ss = 0.0f;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int col = cg + 16 * (half * 4 + m);
            float s = up[0] * sw[S_WU + col] + up[1] * sw[S_WU + D2 + col];
            s += up[2] * sw[S_WU + 2 * D2 + col];
            s += up[3] * sw[S_WU + 3 * D2 + col];
            xh[m] = sw[S_BU + col] + s;
            sum += xh[m];
          }
          const float mean = row_sum16(sum) * (1.0f / D);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            xh[m] -= mean;
            ss = fmaf(xh[m], xh[m], ss);
          }
          const float inv = 1.0f / sqrtf(row_sum16(ss) * (1.0f / D) + LN_EPS);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int col = cg + 16 * (half * 4 + m);
            xh[m] *= inv;
            sc[m] = sw[S_LN0S + col];
            dpre[m] = a0t[p * LA0 + col] > 0.0f ? kvt[swz(p, col, D2)] : 0.0f;
          }
          ln_vjp<4>(dpre, xh, sc, inv, dh);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int col = cg + 16 * (half * 4 + m);
            a0t[p * LA0 + col] = dh[m];
            kvt[swz(p, col, D2)] = dpre[m];
            x0t[p * D2 + col] = xh[m];
          }
        }
      }
      __syncthreads();

      // B5. ln0, bu and wu gradients
      for (int item = tid; item < 7 * D2; item += THREADS) {
        const int c = item % D2;
        if (item < D2) {
          vg[V_LN0B + c] += colsum(Swz{kvt, D2}, c);
        } else if (item < 2 * D2) {
          vg[V_LN0S + c] += colsum(Swz{kvt, D2}, Plain{x0t, D2}, c);
        } else if (item < 3 * D2) {
          vg[V_BU + c] += colsum(Plain{a0t, LA0}, c);
        } else {
          const int k = item / D2 - 3;
          float s = 0.0f;
#pragma unroll 8
          for (int p = 0; p < P; ++p) s = fmaf(su[p * 4 + k], a0t[p * LA0 + c], s);
          vg[V_WU + k * D2 + c] += s;
        }
      }
    }

    __syncthreads();
    // sum_j dlogit_j is 0 in exact arithmetic; the rounding of g . out
    // (K3's output) against the recomputed alpha leaves it at
    // S = delta_exact - delta, the same for every sender, so dlogit_j is
    // alpha_j S too large: take sum_j alpha_j S k_j = S sum_j alpha_j k_j off
    for (int i = tid; i < nrecv * D; i += THREADS)
      dq[rbase * D + i] = sdq[i] - SCALE * sds[(i / D) * H + (i % D) / HD] * sak[i];

    // the group's weight gradients into this block's slice, in the packed
    // layout (stored by its first group, added after: a two-level sum, so
    // no f32 accumulator runs over more than one group's pairs)
    const bool first = grp == blockIdx.x;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tc::for_fragment(gw1[0][j], 16 * warp, 8 * j, [&](int r, int c, float v0, float v1) {
        put2(part + OFF_W1 + r * D2 + c, v0, v1, first);  // dz1 = [dz | dz]: both halves
        put2(part + OFF_W1 + r * D2 + D + c, v0, v1, first);
      });
      tc::for_fragment(gkv[0][j], wm, 64 * (warp >> 2) + 8 * j,
                       [&](int r, int c, float v0, float v1) {
                         put2(part + OFF_WKV + r * D2 + c, v0, v1, first);
                       });
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tc::for_fragment(gagg[0][j], wm, 32 * (warp >> 2) + 8 * j,
                       [&](int r, int c, float v0, float v1) {
                         put2(part + OFF_WAGG + r * D + c, v0, v1, first);
                       });
    for (int i = tid; i < V_B1; i += THREADS) put(part + i, take(vg + i), first);  // wu .. ln0b
    if (tid < D) {
      const float b1 = take(vg + V_B1 + tid);
      put(part + OFF_B1 + tid, b1, first);
      put(part + OFF_B1 + D + tid, b1, first);
      put(part + OFF_LNA0S + tid, take(vg + V_LNA0S + tid), first);
      put(part + OFF_LNA0B + tid, take(vg + V_LNA0B + tid), first);
      put(part + OFF_BAGG + tid, take(vg + V_BAGG + tid), first);
      put(part + OFF_LNA1S + tid, take(vg + V_LNA1S + tid), first);
      put(part + OFF_LNA1B + tid, take(vg + V_LNA1B + tid), first);
    }
    if (tid < D2) put(part + OFF_BKV + tid, take(vg + V_BKV + tid), first);
  }
}

// K4 at H heads, then the sum of the blocks' slices, on the stream;
// returns cudaGetLastError()
template <int H>
int launch(const float* q, const float* u, const float* mask, const float* keep, const float* w,
           const float* g, const float* out, const float* stats, float* dq, float* dw,
           double* partial, long long R, int Ak, float keep_scale, int grid, void* stream) {
  if (R <= 0 || Ak <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * Smem<H>::S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_fused_bwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_fused_bwd_kernel<H><<<grid, THREADS, smem, s>>>(q, u, mask, keep, w, g, out, stats, dq,
                                                      partial, R, Ak, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<(W_FLOATS + 255) / 256, 256, 0, s>>>(partial, grid, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One set of entry points per head count: aa_fused_bwd_* at the flagship's
// 8 heads, aa_fused_bwd_h4_* at the HiVT baseline's 4 (ops/aa_fused.py picks
// by the head count and refuses any other; K4b's are in
// aa_fused_bwd_bf16.cu).
extern "C" {

// floats the packed weight buffer (and its gradient) holds
int aa_fused_bwd_weight_floats() { return W_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_fused_bwd_receivers_per_group() { return RB; }
int aa_fused_bwd_h4_receivers_per_group() { return RB; }

#ifdef AA_WRITE_LOGITS
// where the next launches write each pair's recomputed head logits, [R * Ak][H]
int aa_fused_bwd_set_logits(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_logits, &p, sizeof(p)));
}
#endif

// dq [R, 64] and dw [W_FLOATS] (packed like w) from K3's inputs q [R, 64],
// u [R, Ak, 4], mask [R, Ak], keep [R, Ak, H] or NULL, w; the cotangent
// g [R, 64]; K3's output out [R, 64] and statistics stats [2, R, H] of the
// same inputs.  keep_scale is 1 / (1 - p) with keep, else 1.  partial is a
// [grid, W_FLOATS] f64 workspace.  H is 8 here and 4 in
// aa_fused_bwd_h4_launch.  Returns cudaGetLastError().
int aa_fused_bwd_launch(const float* q, const float* u, const float* mask, const float* keep,
                        const float* w, const float* g, const float* out, const float* stats,
                        float* dq, float* dw, double* partial, long long R, int Ak,
                        float keep_scale, int grid, void* stream) {
  return launch<8>(q, u, mask, keep, w, g, out, stats, dq, dw, partial, R, Ak, keep_scale, grid,
                   stream);
}

int aa_fused_bwd_h4_launch(const float* q, const float* u, const float* mask, const float* keep,
                           const float* w, const float* g, const float* out, const float* stats,
                           float* dq, float* dw, double* partial, long long R, int Ak,
                           float keep_scale, int grid, void* stream) {
  return launch<4>(q, u, mask, keep, w, g, out, stats, dq, dw, partial, R, Ak, keep_scale, grid,
                   stream);
}

}  // extern "C"
