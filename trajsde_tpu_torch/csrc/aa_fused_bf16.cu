// Fused AA pair chain in bf16, forward (kernel K3b).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_fused.py::_fwd_call
// with FusedCfg(dtype="bfloat16") (pallas_call body _fwd_kernel ->
// pair_chain, ln_mm a runtime argument).  It computes what K3
// (aa_fused.cu) computes, with pair_chain's bf16 rounding points: the
// LayerNorm outputs a0, a1 and nbr and the matrices w1, wagg and wkv are
// bf16, each product sums in f32; the rank-1 first layer, the biases, the
// logits, the softmax and the aggregate stay f32.  With ln_mm (the JAX
// encoders' default) each LayerNorm's mean is taken over its bf16-rounded
// inputs and its variance over the bf16-rounded squares, as _ln_mm's
// averaging matmuls do.  w1 is not folded: z1[:D] + z1[D:] is one K = 4D
// product [a0 | a0] . [bf16(w1[:, :D]); bf16(w1[:, D:])].  For a receiver
// with no sender the output is exactly 0.  The launch can also write each
// (receiver, head)'s softmax statistics, the max and the sum of exp
// ([2][R][H]), which K4b (aa_fused_bwd_bf16.cu) reads.
//
// Bound on an H100 SXM at the serving bucket-128 shape (B 128, T 21,
// Aq 49, Ak 48, D 64, H 8: 6.32 M pairs; chip_smoke.aa_fused_bound with
// bf16): the three products (10 D^2 a pair) at the bf16 tensor-core rate
// take 0.263 ms, the rest of the function on the CUDA cores as long, the
// inputs and the output 0.06 ms.  This design adds a bound of its own: the
// B fragments are read from shared memory once per 16-row m-tile, 56 KB a
// tile, 3.5 KB a pair, 22.6 GB at bucket 128, 0.68 ms at the SMs' 33 TB/s.
//
// Design.  K3's form of this chain (the BF form of aa_fused_kernel, up to
// this kernel) walked 64-pair chunks in lockstep, 512 threads of one block
// per SM, with eleven barriers a chunk, every activation stored to shared
// memory in f32 and read back by an epilogue on another thread layout.
// Here each warp walks receivers of its own, one at a time, and carries
// each 16-row m-tile of the receiver's senders from the features to the
// softmax in registers; nothing in the walk waits for another warp.
//   * The m-tile's rows are one receiver's senders 16r .. 16r + 15; rows
//     past Ak are computed on zeros and masked (48 senders: 3 m-tiles).
//   * A lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of each
//     8-column n-tile at columns 2t, 2t + 1: the C fragment of
//     mma.sync.m16n8k16.  F1 (the rank-1 first layer) writes a0 in that
//     layout; each LayerNorm runs on it; rounded to bf16 and packed in
//     pairs, the C fragments of n-tiles 2s and 2s + 1 are the A fragment of
//     k-step s of the next product.  F2 (a0 . w1 over K = 4D), F3 (a1 .
//     wagg), F4 (nbr . wkv, k then v, each N = 64) take their A fragments
//     from registers and their B fragments from the staged bf16 weights by
//     ldmatrix.x4 (a 32-deep k block of one n-tile an instruction).
//   * The softmax is an online one per m-tile: the tile's max per head by
//     shuffles over the rows, the running max, sum of exp and sum of
//     e keep v in registers (per lane over its rows), reduced over the
//     lanes once per receiver by shuffles.  u, the mask, keep and q of the
//     next m-tile come into the other stage of a two-stage ring per warp by
//     cp.async while this one computes.
//   * One 256-thread block (8 warps) walks 8 receivers at a time; 2 blocks
//     per SM (128 registers a thread); shared memory: the weights (bf16
//     matrices 61,440 B, f32 vectors 6,144 B) and the rings (2,176 B a warp
//     at 8 heads): 84,992 B a block.
//   Measured on an H100 (scripts/compare_aa_fwd_builds_torch.py --bf16, in
//   turns with the former form): 3.49-3.64 ms at bucket 128 against
//   8.42-8.48, 3.14-3.28 at the baseline's 4 heads against 8.13-8.28, 1.84
//   at batch 64 with keep against 4.48; without its products 2.0 ms (the
//   former form 5.3-5.5).  ptxas: 128 registers, 44 B of spill stores at 8
//   heads (68 at 4), a few loads and stores a tile.  A 12-warp block at 168
//   registers was no faster.  Selecting a pointer into the tile by the
//   lane's parity (rather than the values) put the tile in local memory and
//   cost a third of the time.
// Bits.  Every pair's a0, a1, nbr, k, v and logits are the bits of K3's
// bf16 form, which K4b's recompute reproduces (mma_bf16.cuh's mma_xwt_bf16
// and aa_common.cuh's BF epilogues): the order of each element's arithmetic
// does not depend on the tiling, and this layout keeps it.
//   * A product: per 32-deep k block two k-steps into a fresh fragment,
//     added to the f32 accumulator in k order (mma_xwt_bf16).
//   * A LayerNorm's sums (ln_row_t, row_sum16): a column group's four
//     columns 4G .. 4G + 3 lie in lanes t = 2 (G mod 2) (columns 0, 1) and
//     t + 1 (2, 3) of n-tile G / 2.  The group's partial ((x0 + x1) +
//     (x2 + x3) for the mean, the FMA chain of the squares x0 .. x3 for the
//     variance, or their bf16 forms) is finished by one shuffle between the
//     two lanes, the even lane finishing the groups of even n-tiles and the
//     odd one those of odd n-tiles; row_sum16's tree over the 16 groups
//     (pairs G ^ 8, then G ^ 4, G ^ 2, G ^ 1) is then two register adds
//     (n-tiles j ^ 4, j ^ 2) and two shuffles (lanes t ^ 1, t ^ 2).
//   * A head's logit (head_logit, head_sum): the partial of each 4-column
//     group is q0 k0, then FMAs over the other three in column order, the
//     even lane's half shuffled to the odd one; the groups are summed as
//     head_sum pairs them (lanes t ^ 2), then scaled.
//   * F1: the expression of K3's F1, which nvcc contracts the same way.
//   Only the softmax's sums take another order (per lane over its rows,
//   then over the lanes, per m-tile rather than per 64-pair chunk), so the
//   output and the statistics' sum of exp move within rounding of the
//   plain version; the statistics' max does not move.  Each output is
//   summed in a fixed order and no atomics are used: reruns are bit-equal.
// Heads: a template on the head count H, 8 (the flagship's) or 4 (the HiVT
// baseline's), with an entry point each.
// Built with -DAA_WRITE_LOGITS (a check copy, tests/test_torch_cuda.py,
// chip_smoke.py) it also writes every pair's head logits (-inf where
// masked) to the buffer given by aa_fused_bf16_set_logits; that changes no
// output, and the normal build compiles none of it.

#include "aa_common.cuh"
#include "mma_tf32.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace aa;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;           // warps of a block, each walking receivers of its own
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;      // blocks per SM: 128 registers a thread
constexpr int TM = 16;             // pair rows of an m-tile

// the bf16 weights, transposed ([N][K], a row padded by 8 values, so that
// ldmatrix's 8 rows of 16 bytes fall in 32 banks): w1 as the K = 4D operand
// [w1[:, :D]; w1[:, D:]] [D][4D], wagg [D][D], wkv [2D][D]
constexpr int LB_W1 = 2 * D2 + 8;
constexpr int LB = D + 8;
constexpr int B_W1 = 0;
constexpr int B_AGG = B_W1 + D * LB_W1;
constexpr int B_KV = B_AGG + D * LB;
constexpr int B_VALUES = B_KV + D2 * LB;

// the f32 vectors after them (floats), by the column pair (c, c + 1) of a
// lane's C fragments, c even: F1's [D][12] (wu[0][c], wu[0][c + 1],
// wu[1][c], wu[1][c + 1], then wu[2], wu[3], then bu[c], bu[c + 1] and two
// unused), the LayerNorms' [pairs][4] (scale[c], scale[c + 1], bias[c],
// bias[c + 1]), then b1f = b1[:D] + b1[D:], bagg and bkv as they are
constexpr int V_F1 = 0;
constexpr int V_LN0 = V_F1 + D * 12;      // 64 pairs: both branches of a0
constexpr int V_LNA0 = V_LN0 + D * 4;     // 32 pairs
constexpr int V_LNA1 = V_LNA0 + D2;       // 32 pairs
constexpr int V_B1F = V_LNA1 + D2;
constexpr int V_BAGG = V_B1F + D;
constexpr int V_BKV = V_BAGG + D;
constexpr int V_FLOATS = V_BKV + D2;

// a warp's ring stage (floats): q [D] of the m-tile's receiver, u [TM][4],
// the mask [TM] and keep [TM][H]
template <int H>
struct Ring {
  static constexpr int Q = 0, U = D, MASK = U + TM * 4, KEEP = MASK + TM, STAGE = KEEP + TM * H;
  static_assert(U % 4 == 0 && KEEP % 4 == 0 && STAGE % 4 == 0, "16-byte pieces");
};

template <int H>
constexpr int smem_bytes() {
  return 2 * B_VALUES + 4 * (V_FLOATS + WARPS * 2 * Ring<H>::STAGE);
}

static_assert(B_VALUES % 8 == 0 && V_FLOATS % 4 == 0, "16-byte alignment");
static_assert(smem_bytes<8>() * MIN_BLOCKS <= 227 * 1024, "shared memory of an SM");

#ifdef AA_WRITE_LOGITS
__device__ float* g_logits;  // [R * Ak][H]
#endif

// cp.async of 16 (or 4) bytes from device to shared memory, zeros where
// !valid (src then only has to be a device address)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the last committed group have landed (this lane's copies)
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the m-tile of receiver r from sender j0 into a ring stage: u, the mask
// (zeros past Ak), keep (if given) and q
template <int H>
__device__ __forceinline__ void load_tile(float* st, const float* __restrict__ q,
                                          const float* __restrict__ u,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ keep, long long r, int j0,
                                          int Ak, int lane) {
  using G = Ring<H>;
  const int row = lane & 15;
  const bool valid = j0 + row < Ak;
  const long long gp = r * Ak + j0 + (valid ? row : 0);
  if (lane < 16) {
    cp16(st + G::U + 4 * row, u + 4 * gp, valid);
    cp4(st + G::MASK + row, mask + gp, valid);
  } else {
    cp16(st + G::Q + 4 * row, q + r * D + 4 * row, true);
  }
  if (keep != nullptr) {
    constexpr int PER_ROW = H / 4;  // 16-byte pieces of a pair's keep
    for (int i = lane; i < TM * PER_ROW; i += 32) {
      const int kr = i / PER_ROW;
      const bool kv = j0 + kr < Ak;
      cp16(st + G::KEEP + 4 * i, keep + (r * Ak + j0 + (kv ? kr : 0)) * H + 4 * (i % PER_ROW),
           kv);
    }
  }
}

// ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8 (16
// bytes); register i receives matrix i's row lane / 4, values 2 (lane % 4)
// and 2 (lane % 4) + 1.  Volatile: the walk must not hoist the weights'
// loads out of its loop.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// acc[j] = the C fragment of n-tile j (rows n0 + 8j .. of W^T) of A W over
// K = 16 KS, A's k-step s being a[s & KMASK] (KMASK = 7 with KS = 16 gives
// [a0 | a0]); per 32-deep k block two k-steps into a fresh fragment, added
// to acc in k order, as mma_bf16.cuh's mma_xwt_bf16.  B: matrices 0 .. 3
// of the ldmatrix are k 0-7, 8-15, 16-23, 24-31 of the block, so registers
// 0, 1 are k-step 0's b0, b1 and 2, 3 k-step 1's.
template <int NT, int KS, int KMASK>
__device__ __forceinline__ void mma_rows(const uint32_t (*a)[4], const __nv_bfloat16* wt, int ld,
                                         int n0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base = wt + (n0 + (lane & 7)) * ld + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < KS / 2; ++kb) {
      uint32_t b[4];
      ldsm4(b, base + 8 * j * ld + 32 * kb);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      tc::mma_bf16(c, a[(2 * kb) & KMASK], b);
      tc::mma_bf16(c, a[(2 * kb + 1) & KMASK], b + 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += c[e];
    }
  }
}

// row_sum16's tree over a row's 16 column groups, from this lane's half of
// each: pp[j] holds columns 2t, 2t + 1 of n-tile j (the group's columns 0,
// 1 on an even lane, 2, 3 on an odd one), and a group's partial is the sum
// of its two halves.  The even lane finishes the groups of even n-tiles,
// the odd lane those of odd ones; then n-tiles j ^ 4 and j ^ 2 in
// registers, lanes t ^ 1 (j ^ 1) and t ^ 2 (the group's half of the tile)
// by shuffles.  Every lane of the row's quad gets the same bits.
__device__ __forceinline__ float group_tree(const float pp[8], bool odd) {
  float p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    p[k] = (odd ? pp[2 * k + 1] : pp[2 * k]) +
           __shfl_xor_sync(FULL, odd ? pp[2 * k] : pp[2 * k + 1], 1);
  float s = (p[0] + p[2]) + (p[1] + p[3]);
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  return s;
}

// the bf16 values held in a bf16x2 register, as f32: the low half, the high half
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// the same tree over the groups' variance partials, from this lane's
// centred values x[j][2h], x[j][2h + 1] of row h: ln_row_t's FMA chain of
// the four squares in column order, or (stats16) the sum of their bf16
// roundings.  stats16: every lane sends the other its bf16 squares of one
// n-tile, packed, and finishes the group it owns as ((b0 + b1) + b2) + b3
// (ln_row_t's 0 + b0 is b0: a square is not negative).  Else the chain
// starts on the even lane: for an odd n-tile it sends its two columns'
// partial to the odd lane; for an even one the odd lane sends its two
// columns.
__device__ __forceinline__ float var_tree(const float (*x)[4], int h, bool odd, bool stats16) {
  // (values, not pointers, are selected by the lane's parity: a pointer
  // into x would put the whole tile in local memory)
  float p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a0 = x[2 * k][2 * h], a1 = x[2 * k][2 * h + 1];          // n-tile 2k
    const float b0 = x[2 * k + 1][2 * h], b1 = x[2 * k + 1][2 * h + 1];  // n-tile 2k + 1
    if (stats16) {
      const uint32_t sa = tc::pack_bf16x2(a0 * a0, a1 * a1);
      const uint32_t sb = tc::pack_bf16x2(b0 * b0, b1 * b1);
      const uint32_t got = __shfl_xor_sync(FULL, odd ? sa : sb, 1);
      const uint32_t first = odd ? got : sa, second = odd ? sb : got;  // columns 0, 1; 2, 3
      p[k] = ((lo_bf16(first) + hi_bf16(first)) + lo_bf16(second)) + hi_bf16(second);
    } else {
      const float m0 = odd ? b0 : a0, m1 = odd ? b1 : a1;  // the group this lane finishes
      const float l0 = odd ? a0 : b0, l1 = odd ? a1 : b1;  // the half it gives the other lane
      float s01 = 0.0f;
      s01 = fmaf(l0, l0, s01);
      s01 = fmaf(l1, l1, s01);
      const float got0 = __shfl_xor_sync(FULL, odd ? l0 : s01, 1);
      const float got1 = __shfl_xor_sync(FULL, l1, 1);  // used by the even lane
      float ss;
      if (odd) {
        ss = got0;
        ss = fmaf(m0, m0, ss);
        ss = fmaf(m1, m1, ss);
      } else {
        ss = 0.0f;
        ss = fmaf(m0, m0, ss);
        ss = fmaf(m1, m1, ss);
        ss = fmaf(got0, got0, ss);
        ss = fmaf(got1, got1, ss);
      }
      p[k] = ss;
    }
  }
  float s = (p[0] + p[2]) + (p[1] + p[3]);
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  return s;
}

// max(v, 0) on both bf16 halves
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hmax2(x, __float2bfloat162_rn(0.0f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// ln_row_t<true> on 16 rows x 64 columns held as C fragments x[j][e] of
// n-tiles j (e 0, 1 row g; 2, 3 row g + 8), with an optional ReLU, into
// the result's bf16 A fragments af[s] of k-steps s = 0 .. 3 (x is left
// centred).  The output's rounding to bf16 is the packing; 1 / std is
// taken once per lane pair (the even lane row g's, the odd row g + 8's).
// prm: the [32][4] (scale, bias) pairs of these columns.
template <bool RELU>
__device__ __forceinline__ void ln_tile(float x[8][4], const float* prm, bool stats16,
                                        uint32_t af[4][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const bool odd = t & 1;
  float var[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float pp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (stats16) {
        const uint32_t b = tc::pack_bf16x2(x[j][2 * h], x[j][2 * h + 1]);
        pp[j] = lo_bf16(b) + hi_bf16(b);
      } else {
        pp[j] = x[j][2 * h] + x[j][2 * h + 1];
      }
    }
    const float mean = group_tree(pp, odd) * (1.0f / D);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j][2 * h] = x[j][2 * h] - mean;
      x[j][2 * h + 1] = x[j][2 * h + 1] - mean;
    }
    var[h] = var_tree(x, h, odd, stats16);
  }
  const float mine = 1.0f / sqrtf((odd ? var[1] : var[0]) * (1.0f / D) + LN_EPS);
  const float inv[2] = {__shfl_sync(FULL, mine, lane & ~1), __shfl_sync(FULL, mine, lane | 1)};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 sb = *reinterpret_cast<const float4*>(prm + 4 * (4 * j + t));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t y = tc::pack_bf16x2(fmaf(x[j][2 * h] * inv[h], sb.x, sb.z),
                                   fmaf(x[j][2 * h + 1] * inv[h], sb.y, sb.w));
      if (RELU) y = relu_bf16x2(y);
      af[j >> 1][2 * (j & 1) + h] = y;
    }
  }
}

// acc[j][e] += b[c] at the lane's columns c = 8j + 2t + (e & 1)
__device__ __forceinline__ void add_bias(float acc[8][4], const float* b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
    acc[j][0] += bb.x;
    acc[j][1] += bb.y;
    acc[j][2] += bb.x;
    acc[j][3] += bb.y;
  }
}

// a, b, c or d by t = 0 .. 3
__device__ __forceinline__ float pick4(int t, float a, float b, float c, float d) {
  return t == 0 ? a : t == 1 ? b : t == 2 ? c : d;
}

// F1 at one row and column: K3's expression, contracted by nvcc as K3's
__device__ __forceinline__ float rank1(const float4 u, float w0, float w1, float w2, float w3,
                                       float bu) {
  float s = u.x * w0 + u.y * w1;
  s += u.z * w2;
  s += u.w * w3;
  return bu + s;
}

template <int H>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
aa_fused_bf16_kernel(const float* __restrict__ q, const float* __restrict__ u,
                     const float* __restrict__ mask, const float* __restrict__ keep,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ stats, long long R, int Ak, float keep_scale,
                     int ln_mm) {
  using G = Ring<H>;
  constexpr int NPH = 8 / H;  // n-tiles of a head: 1 at 8 heads, 2 at 4
  constexpr int OWN = H / 4;  // heads whose exps a lane takes: t + 4o, o < OWN
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* swb = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sv = smem + B_VALUES / 2;
  const bool stats16 = ln_mm != 0;
  const int tid = threadIdx.x;

  // stage the matrices rounded to bf16 and transposed (w1 [r][c] to row
  // c mod D, depth r (c < D) or 2D + r (c >= D)), and the vectors in f32
  for (int i = tid; i < D2 * D2; i += THREADS) {
    const int r = i / D2, c = i % D2;
    swb[B_W1 + (c % D) * LB_W1 + (c / D) * D2 + r] = __float2bfloat16_rn(w[OFF_W1 + i]);
  }
  for (int i = tid; i < D * D; i += THREADS)
    swb[B_AGG + (i % D) * LB + i / D] = __float2bfloat16_rn(w[OFF_WAGG + i]);
  for (int i = tid; i < D * D2; i += THREADS)
    swb[B_KV + (i % D2) * LB + i / D2] = __float2bfloat16_rn(w[OFF_WKV + i]);
  for (int i = tid; i < D2; i += THREADS) {  // column i of a0's 2D
    float* f1 = sv + V_F1 + 12 * (i / 2) + (i & 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) f1[2 * k] = w[OFF_WU + k * D2 + i];
    f1[8] = w[OFF_BU + i];
    f1[10] = 0.0f;
    float* ln = sv + V_LN0 + 4 * (i / 2) + (i & 1);
    ln[0] = w[OFF_LN0S + i];
    ln[2] = w[OFF_LN0B + i];
    sv[V_BKV + i] = w[OFF_BKV + i];
  }
  for (int i = tid; i < D; i += THREADS) {
    const int p = 4 * (i / 2) + (i & 1);
    sv[V_LNA0 + p] = w[OFF_LNA0S + i];
    sv[V_LNA0 + p + 2] = w[OFF_LNA0B + i];
    sv[V_LNA1 + p] = w[OFF_LNA1S + i];
    sv[V_LNA1 + p + 2] = w[OFF_LNA1B + i];
    sv[V_B1F + i] = w[OFF_B1 + i] + w[OFF_B1 + D + i];
    sv[V_BAGG + i] = w[OFF_BAGG + i];
  }
  __syncthreads();  // the only barrier: from here each warp walks on its own

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* ring = sv + V_FLOATS + 2 * G::STAGE * warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  const int ntiles = (Ak + TM - 1) / TM;

  // the walk: receivers r = this warp's index + k nwarps, each in m-tiles
  // it = 0 .. ntiles - 1; the next m-tile is loaded while this one computes
  long long r = static_cast<long long>(blockIdx.x) * WARPS + warp;
  int it = 0, st = 0;
  if (r < R) load_tile<H>(ring, q, u, mask, keep, r, 0, Ak, lane);
  cp_commit();

  float m[H], l[OWN], acc_o[8][2];
  for (; r < R; st ^= 1) {
    long long rn = r;
    int itn = it + 1;
    if (itn == ntiles) {
      itn = 0;
      rn += nwarps;
    }
    if (rn < R) load_tile<H>(ring + G::STAGE * (st ^ 1), q, u, mask, keep, rn, TM * itn, Ak, lane);
    cp_commit();
    cp_wait_prev();
    __syncwarp();
    const float* sr = ring + G::STAGE * st;
    const int j0 = TM * it;

    if (it == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) m[h] = -INFINITY;
#pragma unroll
      for (int o = 0; o < OWN; ++o) l[o] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_o[j][0] = acc_o[j][1] = 0.0f;
    }

    // F1. four rank-1 products, LayerNorm per D-wide branch, ReLU -> a0
    uint32_t a0f[8][4];
    {
      const float4 ug = *reinterpret_cast<const float4*>(sr + G::U + 4 * g);
      const float4 uh = *reinterpret_cast<const float4*>(sr + G::U + 4 * (g + 8));
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float x[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* f1 = sv + V_F1 + 12 * (4 * (8 * b + j) + t);
          const float4 w01 = *reinterpret_cast<const float4*>(f1);
          const float4 w23 = *reinterpret_cast<const float4*>(f1 + 4);
          const float2 bu = *reinterpret_cast<const float2*>(f1 + 8);
          x[j][0] = rank1(ug, w01.x, w01.z, w23.x, w23.z, bu.x);
          x[j][1] = rank1(ug, w01.y, w01.w, w23.y, w23.w, bu.y);
          x[j][2] = rank1(uh, w01.x, w01.z, w23.x, w23.z, bu.x);
          x[j][3] = rank1(uh, w01.y, w01.w, w23.y, w23.w, bu.y);
        }
        ln_tile<true>(x, sv + V_LN0 + 128 * b, stats16, a0f + 4 * b);
      }
    }

    // F2. [a0 | a0] . [w1[:, :D]; w1[:, D:]] + b1f; a1 = relu(LN(.))
    uint32_t a1f[4][4];
    float acc[8][4];
    mma_rows<8, 16, 7>(a0f, swb + B_W1, LB_W1, 0, acc);
    add_bias(acc, sv + V_B1F);
    ln_tile<true>(acc, sv + V_LNA0, stats16, a1f);

    // F3. nbr = LN(a1 . wagg + bagg)
    uint32_t nbf[4][4];
    mma_rows<8, 4, 3>(a1f, swb + B_AGG, LB, 0, acc);
    add_bias(acc, sv + V_BAGG);
    ln_tile<false>(acc, sv + V_LNA1, stats16, nbf);

    // F4, k: nbr . wkv[:, :D] + bkv[:D]; each head's logit of q, masked
    mma_rows<8, 4, 3>(nbf, swb + B_KV, LB, 0, acc);
    add_bias(acc, sv + V_BKV);
    float lg[H][2];
    {
      float gp[8][2];  // on an odd lane: the partial of its column group of n-tile j
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 qv = *reinterpret_cast<const float2*>(sr + G::Q + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float k0 = acc[j][2 * h], k1 = acc[j][2 * h + 1];
          float part = qv.x * k0;
          part = fmaf(qv.y, k1, part);
          const float got = __shfl_xor_sync(FULL, part, 1);
          float tail = fmaf(qv.x, k0, got);
          tail = fmaf(qv.y, k1, tail);
          gp[j][h] = tail;
        }
      }
      const float mg = sr[G::MASK + g], mh = sr[G::MASK + g + 8];
      const bool live_g = j0 + g < Ak && mg > 0.0f, live_h = j0 + g + 8 < Ak && mh > 0.0f;
#pragma unroll
      for (int hd = 0; hd < H; ++hd)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = gp[NPH * hd][h] + __shfl_xor_sync(FULL, gp[NPH * hd][h], 2);
          if constexpr (NPH == 2)
            s += gp[NPH * hd + 1][h] + __shfl_xor_sync(FULL, gp[NPH * hd + 1][h], 2);
          s = __fmul_rn(s, Heads<H>::SCALE);
          // the odd lanes' values to their quad
          s = __shfl_sync(FULL, s, lane | 1);
          lg[hd][h] = (h == 0 ? live_g : live_h) ? s : -INFINITY;
        }
#ifdef AA_WRITE_LOGITS
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = j0 + g + 8 * h;
          if (row < Ak) {
#pragma unroll
            for (int hd = 0; hd < H; ++hd) g_logits[(r * Ak + row) * H + hd] = lg[hd][h];
          }
        }
      }
#endif
    }

    // the online softmax over this m-tile: its max per head over the 16
    // rows, the running max and the rescale of the running sums; e (0 for
    // masked rows) of the heads t + 4o this lane takes, added to their
    // running sums, e keep of every head from the lane of its quad that
    // took it
    float ek[H][2];
    {
#pragma unroll
      for (int hd = 0; hd < H; ++hd) {
        float tmax = fmaxf(lg[hd][0], lg[hd][1]);
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 4));
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 8));
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 16));
        if (tmax != -INFINITY) {
          const float m_new = fmaxf(m[hd], tmax);
          const float corr = expf(m[hd] - m_new);  // 0 while nothing was seen
          m[hd] = m_new;
          if (hd % 4 == t) l[hd / 4] *= corr;
#pragma unroll
          for (int j = NPH * hd; j < NPH * hd + NPH; ++j) {
            acc_o[j][0] *= corr;
            acc_o[j][1] *= corr;
          }
        }
      }
      float eo[OWN][2];
#pragma unroll
      for (int o = 0; o < OWN; ++o) {
        const float mo = pick4(t, m[4 * o], m[4 * o + 1], m[4 * o + 2], m[4 * o + 3]);
        const bool seen = mo != -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = pick4(t, lg[4 * o][h], lg[4 * o + 1][h], lg[4 * o + 2][h],
                                lg[4 * o + 3][h]);
          eo[o][h] = seen ? expf(x - mo) : 0.0f;
        }
        l[o] += eo[o][0] + eo[o][1];
        if (keep != nullptr) {
          eo[o][0] *= sr[G::KEEP + H * g + 4 * o + t];
          eo[o][1] *= sr[G::KEEP + H * (g + 8) + 4 * o + t];
        }
      }
#pragma unroll
      for (int hd = 0; hd < H; ++hd)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ek[hd][h] = __shfl_sync(FULL, eo[hd / 4][h], (lane & ~3) | (hd % 4));
    }

    // F4, v: nbr . wkv[:, D:] + bkv[D:]; the running sum of e keep v
    mma_rows<8, 4, 3>(nbf, swb + B_KV, LB, D, acc);
    add_bias(acc, sv + V_BKV + D);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hd = j / NPH;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc_o[j][e] = fmaf(ek[hd][0], acc[j][e], acc_o[j][e]);
        acc_o[j][e] = fmaf(ek[hd][1], acc[j][2 + e], acc_o[j][e]);
      }
    }

    if (itn == 0) {
      // the receiver's last m-tile: its sums over the warp's rows, then
      // alpha = e / max(sum e, 1e-16) (a receiver with no sender gives 0)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int o = 0; o < OWN; ++o) l[o] += __shfl_xor_sync(FULL, l[o], off);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_o[j][0] += __shfl_xor_sync(FULL, acc_o[j][0], off);
          acc_o[j][1] += __shfl_xor_sync(FULL, acc_o[j][1], off);
        }
      }
      float den[H];
#pragma unroll
      for (int hd = 0; hd < H; ++hd)
        den[hd] = fmaxf(__shfl_sync(FULL, l[hd / 4], (lane & ~3) | (hd % 4)), 1e-16f);
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(out + r * D + 8 * j + 2 * t) =
              make_float2(acc_o[j][0] / den[j / NPH] * keep_scale,
                          acc_o[j][1] / den[j / NPH] * keep_scale);
        }
        if (stats != nullptr) {
#pragma unroll
          for (int o = 0; o < OWN; ++o) {
            stats[r * H + 4 * o + t] = pick4(t, m[4 * o], m[4 * o + 1], m[4 * o + 2], m[4 * o + 3]);
            stats[(R + r) * H + 4 * o + t] = l[o];
          }
        }
      }
    }
    __syncwarp();  // the stage is read out before the next m-tile's load reuses it
    r = rn;
    it = itn;
  }
  cp_wait_prev();  // nothing left in flight (the last group is empty)
}

// K3b at H heads on the stream; returns cudaGetLastError()
template <int H>
int launch(const float* q, const float* u, const float* mask, const float* keep, const float* w,
           float* out, float* stats, long long R, int Ak, float keep_scale, int ln_mm, int grid,
           void* stream) {
  if (R <= 0 || Ak <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(aa_fused_bf16_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_fused_bf16_kernel<H><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, u, mask, keep, w, out, stats, R, Ak, keep_scale, ln_mm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3b's entry points at the flagship's 8 heads (aa_fused_bf16_*) and the
// HiVT baseline's 4 (aa_fused_bf16_h4_*); ops/aa_fused.py picks by the head
// count and refuses any other.
extern "C" {

// floats the packed weight buffer must hold (W_ORDER, flattened)
int aa_fused_weight_floats() { return W_FLOATS; }

// receivers a block walks at a time (one a warp), and blocks an SM holds
// (the wrapper sizes the grid with both)
int aa_fused_bf16_receivers_per_group() { return WARPS; }
int aa_fused_bf16_h4_receivers_per_group() { return WARPS; }
int aa_fused_bf16_blocks_per_sm() { return MIN_BLOCKS; }
int aa_fused_bf16_h4_blocks_per_sm() { return MIN_BLOCKS; }

#ifdef AA_WRITE_LOGITS
// where the next launches write each pair's head logits, [R * Ak][H]
int aa_fused_bf16_set_logits(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_logits, &p, sizeof(p)));
}
#endif

// out [R, 64] from q [R, 64], u [R, Ak, 4], mask [R, Ak] (0/1 f32), keep
// [R, Ak, H] (0/1 f32) or NULL, w packed; keep_scale multiplies the output
// (1 / (1 - p) with keep, else 1); ln_mm != 0 takes each LayerNorm's
// statistics from bf16-rounded inputs (JAX's ln_mm).  stats [2, R, H]
// (softmax max, then sum of exp, per receiver and head) or NULL.  H is 8
// here and 4 in aa_fused_bf16_h4_launch.  Returns cudaGetLastError().
int aa_fused_bf16_launch(const float* q, const float* u, const float* mask, const float* keep,
                         const float* w, float* out, float* stats, long long R, int Ak,
                         float keep_scale, int ln_mm, int grid, void* stream) {
  return launch<8>(q, u, mask, keep, w, out, stats, R, Ak, keep_scale, ln_mm, grid, stream);
}

int aa_fused_bf16_h4_launch(const float* q, const float* u, const float* mask, const float* keep,
                            const float* w, float* out, float* stats, long long R, int Ak,
                            float keep_scale, int ln_mm, int grid, void* stream) {
  return launch<4>(q, u, mask, keep, w, out, stats, R, Ak, keep_scale, ln_mm, grid, stream);
}

}  // extern "C"
