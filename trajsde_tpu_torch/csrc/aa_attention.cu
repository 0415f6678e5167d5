// Agent-agent attention from positions, forward (kernel K5; its bf16 form
// K5b below).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_attention.py::aa_attention
// (pallas_call body _aa_kernel, with the pair features that the JAX op builds
// before the call, build_pair_features).  It computes the fused AA pair
// chain of K3 (aa_fused.cu) with the chain's two prologues inside the kernel:
//   q[r]    = center[r] . wq + bq                    (per receiver r = (b, t, i))
//   u[r, j] = (R_bi^T x_k[b,t,j], R_bi^T (pos_k[b,t,j] - pos_q[b,t,i]))
// with rot[b, i] = (r0, r1, r2, r3) row-major and the JAX index convention
//   xl0 = r0 x0 + r2 x1,  xl1 = r1 x0 + r3 x1       (the same on the edge),
// each product and sum rounded on its own (no FMA contraction), so u has
// the bits of the plain version's.  Then, per pair, as K3: the packed
// two-branch MLP to nbr, [k | v] = nbr . wkv + bkv, a masked per-head
// softmax over the senders (the bool mask read as bytes; a receiver with no
// sender gives exactly 0) and out[r] = sum_j alpha v.  No dropout.
//
// Bound on an H100 SXM at the twin shape (B 128, T 21, Aq 49, Ak 48, D 64,
// H 8: 6.32 M pairs): K3's 4.4e4 operations per pair, the u build's 14 and
// the q projection's 2 D^2 per receiver, 2.8e11 in all.  The three chain
// products (10 D^2 a pair) run on the tensor cores at f32 accuracy (3 TF32
// products each, at most 495 / 3 = 165 TFLOP/s): 1.57 ms; the rest on the
// CUDA cores 0.31 ms, at the same time.  The inputs and output (the
// centres, positions, rotations, the byte mask, the aggregate) are 0.08 GB,
// 0.02 ms at 3.35 TB/s.  (Every operation on the CUDA cores at 67 TFLOP/s:
// 4.15 ms.)  Against K3 it reads no u (101 MB at this shape) and no q.
//
// Design: K3's (aa_fused.cu, which this kernel leaves untouched so that K3's
// and K4's bits cannot move), with its products, epilogues and softmax:
//   * A persistent grid (one 512-thread block per SM) walks groups of 8
//     receivers with all their senders, in chunks of 64 pairs.
//   * a0 . w1f (w1 folded, K 128), a1 . wagg and nbr . wkv run on the
//     tensor cores through mma_tf32.cuh's mma_xwt_split (3xTF32, the small
//     terms summed apart, mma3x2_apart); the weights are split once per
//     block into swizzled (big, small) pairs, the activations where they
//     are read.  tests/test_torch_aa_attention_tf32.py models this
//     arithmetic on the CPU.
//   * The epilogues run per row, 16 lanes a row, through aa_common.cuh's
//     ln_row, epi_a1, epi_nbr, epi_bias and head_logit<H>.
//   * The softmax is online, once per (receiver, head): K3's S1-S3 without
//     the keep mask and without writing the statistics.
//   * Heads: a template on the head count (Heads<H>), with an entry point
//     at 8 (the flagship's) and at 4 (the HiVT baseline's).
// The prologues:
//   * q: at each group's start wq (16,384 B) is staged into the first chunk
//     tile and the group's centre rows into the second; each thread then
//     projects one (receiver, column) of q in f32 FMAs into the group's q
//     slot, and the first chunk overwrites both tiles.  The projection is
//     2 D^2 = 8,192 operations a receiver against about 2.1 M for its 48
//     pairs; wq does not fit beside the split weights (16 KB in f32, 32 KB
//     split).
//   * u: the group's receiver positions and rotations are staged at its
//     start; at each chunk 64 threads build one pair's 4 features each from
//     x_k and pos_k (1 MB each at the twin shape, read through L2).
//   * Shared memory: K3's split weights, vectors and tiles, with bq, the
//     positions and rotations where K3 keeps its keep and e keep tiles:
//     227,776 B at 8 heads, one block per SM.
// K5b, the bf16 form (template parameter BF; entry points
// aa_attention_bf16_*), computes as _aa_kernel does with compute_dtype
// "bfloat16", whose rounding points are not pair_chain's (K3b's):
//   * all 16 packed weights are rounded to bf16, the biases and the
//     LayerNorm scales and shifts too; they are staged once per block as
//     bf16 values (the three chain matrices as bf16, transposed, as K3b
//     stages them; wq and the vectors as f32 copies of bf16 values);
//   * u and the centres are rounded to bf16 (u built in f32 first, as K5);
//   * h = bf16(u . wu + bu): the four products of bf16 values are exact in
//     f32, summed in the plain version's order;
//   * z1 = a0 . w1 is one product over all 2D columns (w1 is not folded:
//     JAX rounds each half, bf16(z1 + b1), and then their sum, so the sum of
//     the halves is bf16(h[:D] + h[D:])); its 128 columns land in two
//     [P][D] tiles;
//   * each LayerNorm takes f32 statistics of its bf16 input, with no
//     rounding of the squares (aa_common.cuh's ln_row_t<true> with stats16
//     off), and rounds its output; nbr is rounded before its LayerNorm;
//   * kv, q, the logits, the softmax and the aggregate stay f32.
// Its products run as one bf16 term each on the tensor cores
// (mma_bf16.cuh's mma_xwt_bf16, two k-steps a fresh fragment added in
// f32, as K3b), the q projection and the rank-4 first layer on the CUDA
// cores (products of bf16 values, exact in f32).  Shared memory: the bf16
// matrices (62,464 B), wq (16,384 B), K5's vectors, its tiles with a fourth
// [P][D] tile for z1's second half (65,536 B in all), the chunk's and the
// group's state: 159,168 B at 8 heads.
// Bound at the twin shape: the function's products (10 D^2 a pair, as
// K5's) at the bf16 tensor-core rate (989 TFLOP/s) take 0.26 ms, the rest
// on the CUDA cores 0.28 ms at the same time.  K5b is right first; it is
// not tuned.
// The ragged last chunk and group are bounds-checked, and every output is
// summed by one thread in a fixed order, so reruns are bit-equal.

#include "aa_common.cuh"
#include "mma_tf32.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace aa;

constexpr int P = 64;          // pairs per chunk
constexpr int RB = 8;          // receivers per group
constexpr int THREADS = 512;   // epilogues: 32 row groups (2 rows each) x 16 column groups
constexpr int NR = 2;          // rows per thread in the epilogues
constexpr int UNROLL = 2;      // k-loop unrolling of a0 . w1f and a1 . wagg
constexpr int UNROLL_KV = 1;   // and of nbr . wkv (K3's)

// the packed buffer: the 14 chain weights in W_ORDER, then wq [D][D], bq [D]
constexpr int OFF_WQ = W_FLOATS;
constexpr int OFF_BQ = OFF_WQ + D * D;
constexpr int WQ_FLOATS = OFF_BQ + D;

// K5's split weights (uint2 slots): w1f [2D][D], wagg [D][D], wkv [D][2D]
constexpr int W_W1 = 0;
constexpr int W_AGG = W_W1 + D2 * D;
constexpr int W_KV = W_AGG + D * D;
constexpr int W_SLOTS = W_KV + D * D2;

// K5b's bf16 weights, transposed ([N][K], a row padded by 8 values so that
// the B fragments' 32-bit reads of 8 rows fall in 32 banks): w1 [2D][2D],
// wagg [D][D], wkv [2D][D]; then wq [D][D] as f32 copies of bf16 values
constexpr int LB_W1 = D2 + 8;
constexpr int LB = D + 8;
constexpr int B_W1 = 0;
constexpr int B_AGG = B_W1 + D2 * LB_W1;
constexpr int B_KV = B_AGG + D * LB;
constexpr int B_VALUES = B_KV + D2 * LB;
constexpr int B_WQ = B_VALUES / 2;             // floats

// the floats the staged weights take: K5's split pairs or K5b's bf16 and wq
template <bool BF>
constexpr int weight_floats() { return BF ? B_WQ + D * D : 2 * W_SLOTS; }

// f32 shared memory (floats), after the staged weights (relative offsets)
constexpr int S_WU = 0;                        // wu, bu, ln0s, ln0b as packed
constexpr int S_BU = S_WU + (OFF_BU - OFF_WU);
constexpr int S_LN0S = S_WU + (OFF_LN0S - OFF_WU);
constexpr int S_LN0B = S_WU + (OFF_LN0B - OFF_WU);
constexpr int S_B1 = S_WU + (OFF_W1 - OFF_WU);  // [2D]: K5's folded b1f [D], K5b's b1
constexpr int S_LNA0S = S_B1 + D2;
constexpr int S_LNA0B = S_LNA0S + D;
constexpr int S_BAGG = S_LNA0B + D;
constexpr int S_LNA1S = S_BAGG + D;
constexpr int S_LNA1B = S_LNA1S + D;
constexpr int S_BKV = S_LNA1B + D;             // [2D]
constexpr int S_BQ = S_BKV + D2;               // [D]
constexpr int T0 = S_BQ + D;                   // [P][2D] wq (K5), then a0; then [P][D] nbr and [P][D] v
constexpr int T0B = T0 + P * D;                //   (v: the second [P][D] half)
constexpr int T1 = T0 + P * D2;                // [P][D] the group's centres, then a1 (K5b: z1's
                                               // first half, then a1), then k
constexpr int T2 = T1 + P * D;                 // [P][D] K5b: z1's second half

// the rest of the layout, per head count H and compute type
template <int H, bool BF>
struct Smem {
  static constexpr int S0 = weight_floats<BF>();  // where the f32 part starts
  static constexpr int S_U = T2 + (BF ? P * D : 0);  // [P][4]
  static constexpr int S_MASK = S_U + P * 4;   // [P]
  static constexpr int S_PQ = S_MASK + P;      // [RB][2] receiver positions
  static constexpr int S_ROT = S_PQ + RB * 2;  // [RB][4] receiver rotations
  static constexpr int S_LG = S_ROT + RB * 4;  // [P][H] masked logits (-inf: no edge), then e
  static constexpr int S_Q = S_LG + P * H;     // [RB][D]
  static constexpr int S_ACC = S_Q + RB * D;   // [RB][D] running sum of e * v
  static constexpr int S_M = S_ACC + RB * D;   // [RB][H] running max
  static constexpr int S_L = S_M + RB * H;     // [RB][H] running sum of e
  static constexpr int S_MNEW = S_L + RB * H;  // [RB][H] this chunk's max (-inf: no edge)
  static constexpr int S_CORR = S_MNEW + RB * H;  // [RB][H] exp(old max - new max)
  static constexpr int S_FLOATS = S0 + S_CORR + RB * H;

  static_assert(S0 % 4 == 0 && T0 % 4 == 0 && T1 % 4 == 0 && S_U % 4 == 0 && S_Q % 4 == 0 &&
                    B_VALUES % 8 == 0,
                "float4 alignment");
  static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");
  static_assert(D * D <= P * D2 && RB * D <= P * D && RB * D == THREADS,
                "wq and the centres fit the chunk tiles; one q element a thread");
  // S2 takes one (pair, head) a thread: all of them at 8 heads, half at 4
  static_assert(P * H <= THREADS && P * 4 <= THREADS && NR * 32 == P && RB * H * 8 <= THREADS,
                "thread layout");
};

// slot of the split pair (r, c) of a matrix of row length ld
__device__ __forceinline__ int w_at(int r, int c, int ld) { return r * ld + (c ^ ((r & 3) << 2)); }

struct WSplit {  // B of x W from a pre-split W [K][N]: w(n, k) = the pair of W[k][n]
  const uint2* p;
  int ld;
  __device__ __forceinline__ uint2 operator()(int n, int k) const { return p[w_at(k, n, ld)]; }
};

struct SwzBf {  // K5b's A from a swizzled f32 tile of bf16 values: (m, k even) -> the pair
  const float* p;
  int ld;
  __device__ __forceinline__ uint32_t operator()(int m, int k) const {
    const float2 v = *reinterpret_cast<const float2*>(p + swz(m, k, ld));
    return tc::pack_bf16x2(v.x, v.y);
  }
};

// a staged weight: as packed (K5), or rounded to bf16 (K5b)
template <bool BF>
__device__ __forceinline__ float wval(float x) { return BF ? bf16r(x) : x; }

// BF: K5b, the chain at _aa_kernel's bf16 rounding points (see the note above)
template <int H, bool BF>
__global__ void __launch_bounds__(THREADS, 1)
aa_attention_kernel(const float* __restrict__ center, const float* __restrict__ x_k,
                    const float* __restrict__ pos_q, const float* __restrict__ pos_k,
                    const float* __restrict__ rot, const unsigned char* __restrict__ mask,
                    const float* __restrict__ w, float* __restrict__ out, long long R, int T,
                    int Aq, int Ak) {
  using L = Smem<H, BF>;
  constexpr int HD = Heads<H>::HD;
  constexpr int HL = Heads<H>::LANES;
  extern __shared__ __align__(16) float smem[];
  uint2* sw2 = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* swb = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sw = smem + L::S0;
  float* t0 = sw + T0;
  float* t0b = sw + T0B;
  float* t1 = sw + T1;
  float* t2 = sw + T2;
  float* su = sw + L::S_U;
  float* smask = sw + L::S_MASK;
  float* spq = sw + L::S_PQ;
  float* srot = sw + L::S_ROT;
  float* slg = sw + L::S_LG;
  float* sq = sw + L::S_Q;
  float* sacc = sw + L::S_ACC;
  float* sm = sw + L::S_M;
  float* sl = sw + L::S_L;
  float* smnew = sw + L::S_MNEW;
  float* scorr = sw + L::S_CORR;
  // wq: K5 stages it into t0 at each group's start, K5b once per block
  const float* swq = BF ? smem + B_WQ : t0;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // epilogue column group: columns c0 .. c0+3 (and D + ...)
  const int c0 = cg * 4;
  const int r0 = (tid >> 4) * NR;
  const int warp = tid >> 5;    // products: m-tile warp % 4, column quarter warp / 4
  const int wm = 16 * (warp & 3);
  const int wn = warp >> 2;

  if constexpr (BF) {
    // stage the three matrices rounded to bf16 and transposed, wq rounded
    for (int i = tid; i < D2 * D2; i += THREADS)
      swb[B_W1 + (i % D2) * LB_W1 + i / D2] = __float2bfloat16_rn(w[OFF_W1 + i]);
    for (int i = tid; i < D * D; i += THREADS)
      swb[B_AGG + (i % D) * LB + i / D] = __float2bfloat16_rn(w[OFF_WAGG + i]);
    for (int i = tid; i < D * D2; i += THREADS)
      swb[B_KV + (i % D2) * LB + i / D2] = __float2bfloat16_rn(w[OFF_WKV + i]);
    for (int i = tid; i < D * D; i += THREADS) smem[B_WQ + i] = bf16r(w[OFF_WQ + i]);
  } else {
    // stage the three matrices split (w1 folded)
    for (int i = tid; i < D2 * D; i += THREADS) {
      const int r = i / D, c = i % D;
      sw2[W_W1 + w_at(r, c, D)] =
          tc::split2(w[OFF_W1 + r * D2 + c] + w[OFF_W1 + r * D2 + D + c]);
    }
    for (int i = tid; i < D * D; i += THREADS)
      sw2[W_AGG + w_at(i / D, i % D, D)] = tc::split2(w[OFF_WAGG + i]);
    for (int i = tid; i < D * D2; i += THREADS)
      sw2[W_KV + w_at(i / D2, i % D2, D2)] = tc::split2(w[OFF_WKV + i]);
  }
  // and the vectors in f32 (K5b: bf16 values); K5 folds b1
  for (int i = tid; i < OFF_W1; i += THREADS) sw[S_WU + i] = wval<BF>(w[OFF_WU + i]);
  if (tid < D) {
    if constexpr (BF) {
      sw[S_B1 + tid] = bf16r(w[OFF_B1 + tid]);
      sw[S_B1 + D + tid] = bf16r(w[OFF_B1 + D + tid]);
    } else {
      sw[S_B1 + tid] = w[OFF_B1 + tid] + w[OFF_B1 + D + tid];
    }
    sw[S_LNA0S + tid] = wval<BF>(w[OFF_LNA0S + tid]);
    sw[S_LNA0B + tid] = wval<BF>(w[OFF_LNA0B + tid]);
    sw[S_BAGG + tid] = wval<BF>(w[OFF_BAGG + tid]);
    sw[S_LNA1S + tid] = wval<BF>(w[OFF_LNA1S + tid]);
    sw[S_LNA1B + tid] = wval<BF>(w[OFF_LNA1B + tid]);
    sw[S_BQ + tid] = wval<BF>(w[OFF_BQ + tid]);
  }
  if (tid < D2) sw[S_BKV + tid] = wval<BF>(w[OFF_BKV + tid]);

  const long long groups = (R + RB - 1) / RB;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long rbase = g * RB;
    const int nrecv = static_cast<int>(R - rbase < RB ? R - rbase : RB);
    const int npairs = nrecv * Ak;
    const long long pbase = rbase * Ak;  // the group's first pair

    __syncthreads();  // the previous group's outputs and tiles are read out
    // Q1. stage wq [D][D] (K5: t0, by rows), the group's centre rows [RB][D]
    // (t1; K5b rounds them to bf16), its receivers' positions and
    // rotations; reset the softmax
    if constexpr (!BF)
      for (int i = tid; i < D * D / 4; i += THREADS)
        reinterpret_cast<float4*>(t0)[i] = reinterpret_cast<const float4*>(w + OFF_WQ)[i];
    if (tid < RB * D / 4) {
      const int rl = tid / (D / 4);
      float4 c = rl < nrecv ? reinterpret_cast<const float4*>(center + rbase * D)[tid]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (BF) c = make_float4(bf16r(c.x), bf16r(c.y), bf16r(c.z), bf16r(c.w));
      reinterpret_cast<float4*>(t1)[tid] = c;
    }
    sacc[tid] = 0.0f;  // RB * D == THREADS
    if (tid < RB * H) {
      sm[tid] = -INFINITY;
      sl[tid] = 0.0f;
    }
    if (tid < RB) {
      const long long r = rbase + tid;
      const bool live = tid < nrecv;
      const long long br = (r / Aq / T) * Aq + r % Aq;  // rot row of receiver (b, i)
#pragma unroll
      for (int k = 0; k < 2; ++k) spq[tid * 2 + k] = live ? pos_q[r * 2 + k] : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) srot[tid * 4 + k] = live ? rot[br * 4 + k] : 0.0f;
    }
    __syncthreads();

    // Q2. q = center . wq + bq, one (receiver, column) a thread, k in order
    {
      const int rl = tid / D, c = tid % D;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(t1[rl * D + k], swq[k * D + c], acc);
      sq[tid] = acc + sw[S_BQ + c];
    }

    for (int cp0 = 0; cp0 < npairs; cp0 += P) {
      const int pend = min(cp0 + P, npairs);  // group-relative, exclusive

      __syncthreads();  // the previous chunk's softmax update (or q) is done
      if (tid < P) {
        // U. pair (receiver rl, sender j): its 4 rotated features (K5b:
        // rounded to bf16) and mask bit
        const int p = cp0 + tid;
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float live_edge = 0.0f;
        if (p < pend) {
          const int rl = p / Ak;
          const long long bt = (rbase + rl) / Aq;  // (b, t) of the receiver
          const long long s = (bt * Ak + p % Ak) * 2;
          const float2 xk = *reinterpret_cast<const float2*>(x_k + s);
          const float2 pk = *reinterpret_cast<const float2*>(pos_k + s);
          const float* rr = srot + rl * 4;
          const float e0 = __fsub_rn(pk.x, spq[rl * 2]);
          const float e1 = __fsub_rn(pk.y, spq[rl * 2 + 1]);
          f[0] = __fadd_rn(__fmul_rn(rr[0], xk.x), __fmul_rn(rr[2], xk.y));
          f[1] = __fadd_rn(__fmul_rn(rr[1], xk.x), __fmul_rn(rr[3], xk.y));
          f[2] = __fadd_rn(__fmul_rn(rr[0], e0), __fmul_rn(rr[2], e1));
          f[3] = __fadd_rn(__fmul_rn(rr[1], e0), __fmul_rn(rr[3], e1));
          if (BF) {
#pragma unroll
            for (int k = 0; k < 4; ++k) f[k] = bf16r(f[k]);
          }
          live_edge = mask[pbase + p] != 0 ? 1.0f : 0.0f;
        }
        store4(su + tid * 4, f);
        smask[tid] = live_edge;
      }
      __syncthreads();

      // F1. four rank-1 products, LayerNorm per D-wide branch, ReLU -> a0
      // (t0); K5b rounds h, and each LayerNorm's output, to bf16
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
            hv[half][j] = wval<BF>(sw[S_BU + col] + s);
          }
        ln_row_t<BF>(hv[0], sw + S_LN0S, sw + S_LN0B, c0, true, false, nullptr, nullptr);
        ln_row_t<BF>(hv[1], sw + S_LN0S + D, sw + S_LN0B + D, c0, true, false, nullptr, nullptr);
        store4(t0 + swz(r0 + i, c0, D2), hv[0]);
        store4(t0 + swz(r0 + i, D + c0, D2), hv[1]);
      }
      __syncthreads();

      // F2. K5: a0 . w1f -> t1; a1 = relu(LN(. + b1f)) in place.  K5b:
      // z1 = a0 . w1, its columns [0, D) -> t1 and [D, 2D) -> t2; then
      // a1 = relu(LN(bf16(bf16(z1[:D] + b1[:D]) + bf16(z1[D:] + b1[D:])))) -> t1
      if constexpr (BF) {
        float acc[1][4][4] = {};
        tc::mma_xwt_bf16<1, 4, D2, UNROLL>(SwzBf{t0, D2}, tc::WBf{swb + B_W1, LB_W1}, wm,
                                           32 * wn, 8, acc);
        tc::store_c<4>(wn < 2 ? t1 : t2, SwzAt{D}, acc, wm, 32 * (wn & 1));
      } else {
        float acc[1][2][4] = {};
        tc::mma_xwt_split<1, 2, D2, UNROLL>(Swz{t0, D2}, WSplit{sw2 + W_W1, D}, wm, 16 * wn, 8,
                                            acc);
        tc::store_c<2>(t1, SwzAt{D}, acc, wm, 16 * wn);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x[4];
        load4(x, t1 + swz(r0 + i, c0, D));
        if constexpr (BF) {
          float y[4];
          load4(y, t2 + swz(r0 + i, c0, D));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = bf16r(bf16r(x[j] + sw[S_B1 + c0 + j]) + bf16r(y[j] + sw[S_B1 + D + c0 + j]));
          ln_row_t<true>(x, sw + S_LNA0S, sw + S_LNA0B, c0, true, false, nullptr, nullptr);
        } else {
          epi_a1(x, sw + S_B1, sw + S_LNA0S, sw + S_LNA0B, c0);
        }
        store4(t1 + swz(r0 + i, c0, D), x);
      }
      __syncthreads();

      // F3. a1 . wagg -> t0 (a0 is read out); nbr = LN(. + bagg) in place
      // (K5b: LN(bf16(. + bagg)))
      {
        float acc[1][2][4] = {};
        if constexpr (BF)
          tc::mma_xwt_bf16<1, 2, D, UNROLL>(SwzBf{t1, D}, tc::WBf{swb + B_AGG, LB}, wm, 16 * wn,
                                            8, acc);
        else
          tc::mma_xwt_split<1, 2, D, UNROLL>(Swz{t1, D}, WSplit{sw2 + W_AGG, D}, wm, 16 * wn, 8,
                                             acc);
        tc::store_c<2>(t0, SwzAt{D}, acc, wm, 16 * wn);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x[4];
        load4(x, t0 + swz(r0 + i, c0, D));
        if constexpr (BF) {
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = bf16r(x[j] + sw[S_BAGG + c0 + j]);
          ln_row_t<true>(x, sw + S_LNA1S, sw + S_LNA1B, c0, false, false, nullptr, nullptr);
        } else {
          epi_nbr(x, sw + S_BAGG, sw + S_LNA1S, sw + S_LNA1B, c0);
        }
        store4(t0 + swz(r0 + i, c0, D), x);
      }
      __syncthreads();

      // F4. nbr . wkv: k -> t1 (a1 is read out), v -> t0b; + bkv; masked
      // head logits
      {
        float acc[1][4][4] = {};
        if constexpr (BF)
          tc::mma_xwt_bf16<1, 4, D, UNROLL_KV>(SwzBf{t0, D}, tc::WBf{swb + B_KV, LB}, wm, 32 * wn,
                                               8, acc);
        else
          tc::mma_xwt_split<1, 4, D, UNROLL_KV>(Swz{t0, D}, WSplit{sw2 + W_KV, D2}, wm, 32 * wn,
                                                8, acc);
        tc::store_c<4>(wn < 2 ? t1 : t0b, SwzAt{D}, acc, wm, 32 * (wn & 1));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        const bool live = cp0 + p < pend;
        const int rl = live ? (cp0 + p) / Ak : 0;
        float k[4], v[4];
        load4(k, t1 + swz(p, c0, D));
        load4(v, t0b + swz(p, c0, D));
        epi_bias(k, sw + S_BKV, c0);
        epi_bias(v, sw + S_BKV + D, c0);
        const float lg = head_logit<H>(*reinterpret_cast<const float4*>(sq + rl * D + c0), k);
        if (cg % HL == 0)  // the head's first lane
          slg[p * H + cg / HL] = (live && smask[p] > 0.0f) ? lg : -INFINITY;
        store4(t0b + swz(p, c0, D), v);
      }
      __syncthreads();

      // S1. per (receiver, head), 8 lanes each: the chunk's largest logit
      // (a max: the same in any order), the new running max and the
      // rescale of the running sums
      const int rl_lo = cp0 / Ak;
      const int nspan = (pend - 1) / Ak - rl_lo + 1;
      {
        const int item = tid >> 3;
        const int rl = rl_lo + item / H;
        const int h = item % H;
        float cmax = -INFINITY;
        if (item < nspan * H) {
          const int pa = max(cp0, rl * Ak) - cp0;
          const int pb = min(pend, (rl + 1) * Ak) - cp0;
          for (int p = pa + (tid & 7); p < pb; p += 8) cmax = fmaxf(cmax, slg[p * H + h]);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const int si = rl * H + h;
        if (item < nspan * H && (tid & 7) == 0) {
          if (cmax == -INFINITY) {
            smnew[si] = -INFINITY;  // no edge of this receiver in the chunk
          } else {
            const float m_new = fmaxf(sm[si], cmax);
            scorr[si] = expf(sm[si] - m_new);  // 0 while nothing was seen
            smnew[si] = m_new;
            sm[si] = m_new;
          }
        }
      }
      __syncthreads();

      // S2. per (pair, head): e = exp(logit - max) (0 for a masked pair), in
      // place of the logit
      {
        const int p = tid / H, h = tid % H;
        if ((P * H == THREADS || tid < P * H) && cp0 + p < pend) {
          const float m_new = smnew[((cp0 + p) / Ak) * H + h];
          if (m_new != -INFINITY) slg[tid] = expf(slg[tid] - m_new);
        }
      }
      __syncthreads();

      // S3. per (receiver, column): the running sum of e v in pair order;
      // per (receiver, head): the running sum of e
      for (int item = tid; item < nspan * (D + H); item += THREADS) {
        const bool col = item < nspan * D;
        const int j = col ? item : item - nspan * D;
        const int rl = rl_lo + (col ? j / D : j / H);
        const int h = col ? (j % D) / HD : j % H;
        const int si = rl * H + h;
        if (smnew[si] == -INFINITY) continue;
        const int pa = max(cp0, rl * Ak) - cp0;
        const int pb = min(pend, (rl + 1) * Ak) - cp0;
        const float corr = scorr[si];
        if (col) {
          const int c = j % D;
          float a = sacc[rl * D + c] * corr;
          for (int p = pa; p < pb; ++p) a = fmaf(slg[p * H + h], t0b[swz(p, c, D)], a);
          sacc[rl * D + c] = a;
        } else {
          float l = sl[si] * corr;
          for (int p = pa; p < pb; ++p) l += slg[p * H + h];
          sl[si] = l;
        }
      }
    }

    __syncthreads();
    // alpha = e / max(sum e, 1e-16): a receiver with no sender gives exactly 0
    for (int i = tid; i < nrecv * D; i += THREADS)
      out[rbase * D + i] = sacc[i] / fmaxf(sl[(i / D) * H + (i % D) / HD], 1e-16f);
  }
}

// K5 (K5b with BF) at H heads on the stream; returns cudaGetLastError()
template <int H, bool BF>
int launch(const float* center, const float* x_k, const float* pos_q, const float* pos_k,
           const float* rot, const unsigned char* mask, const float* w, float* out, long long R,
           int T, int Aq, int Ak, int grid, void* stream) {
  if (R <= 0 || T <= 0 || Aq <= 0 || Ak <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Smem<H, BF>::S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_attention_kernel<H, BF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_attention_kernel<H, BF><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One set of entry points per compute type and head count: aa_attention_*
// at the flagship's 8 heads, aa_attention_h4_* at the HiVT baseline's 4,
// and K5b's aa_attention_bf16_* and aa_attention_bf16_h4_*
// (ops/aa_attention.py picks by the compute dtype and the head count and
// refuses any other).
extern "C" {

// floats the packed weight buffer must hold (W_ORDER, then wq and bq)
int aa_attention_weight_floats() { return WQ_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_attention_receivers_per_group() { return RB; }
int aa_attention_h4_receivers_per_group() { return RB; }
int aa_attention_bf16_receivers_per_group() { return RB; }
int aa_attention_bf16_h4_receivers_per_group() { return RB; }

// out [R, 64] (R = B T Aq, receivers in (b, t, i) order) from center
// [R, 64], x_k [B, T, Ak, 2], pos_q [R, 2], pos_k [B, T, Ak, 2], rot
// [B, Aq, 4], mask [R, Ak] (bytes, 0 = no edge) and the packed weights w.
// H is 8 here and 4 in aa_attention_h4_launch.  Returns cudaGetLastError().
int aa_attention_launch(const float* center, const float* x_k, const float* pos_q,
                        const float* pos_k, const float* rot, const unsigned char* mask,
                        const float* w, float* out, long long R, int T, int Aq, int Ak, int grid,
                        void* stream) {
  return launch<8, false>(center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak, grid,
                          stream);
}

int aa_attention_h4_launch(const float* center, const float* x_k, const float* pos_q,
                           const float* pos_k, const float* rot, const unsigned char* mask,
                           const float* w, float* out, long long R, int T, int Aq, int Ak,
                           int grid, void* stream) {
  return launch<4, false>(center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak, grid,
                          stream);
}

// K5b: as aa_attention_launch, at _aa_kernel's bf16 rounding points
int aa_attention_bf16_launch(const float* center, const float* x_k, const float* pos_q,
                             const float* pos_k, const float* rot, const unsigned char* mask,
                             const float* w, float* out, long long R, int T, int Aq, int Ak,
                             int grid, void* stream) {
  return launch<8, true>(center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak, grid,
                         stream);
}

int aa_attention_bf16_h4_launch(const float* center, const float* x_k, const float* pos_q,
                                const float* pos_k, const float* rot, const unsigned char* mask,
                                const float* w, float* out, long long R, int T, int Aq, int Ak,
                                int grid, void* stream) {
  return launch<4, true>(center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak, grid,
                         stream);
}

}  // extern "C"
