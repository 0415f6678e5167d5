// Fused AA pair chain, forward (kernel K3; its bf16 form K3b is
// aa_fused_bf16.cu).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_fused.py::_fwd_call
// (pallas_call body _fwd_kernel -> pair_chain).  For every receiver r and
// sender j of the encoder's agent-agent attention (r runs over B*T*Aq rows,
// j over Ak senders) it embeds the 4 rotated pair features u[r, j]:
//   h   = bu + sum_k u_k wu[k]                       (four rank-1 products, 2D wide)
//   a0  = relu(LN(h[:D]) | LN(h[D:]))                (one LayerNorm per D-wide branch)
//   a1  = relu(LN(z1[:D] + z1[D:])), z1 = a0 . w1 + b1,  taken as a0 . w1f + b1f
//   nbr = LN(a1 . wagg + bagg)
//   [k | v] = nbr . wkv + bkv
// then per head h a masked softmax over the senders of q[r]_h . k_h / sqrt(hd)
// (empty receivers give exactly 0), an optional 0/1 dropout keep mask times
// 1/(1-p) on the weights after normalisation, and out[r] = sum_j alpha v.
// LayerNorms use eps 1e-5 and a two-pass variance, as pair_chain does.
// w1 is folded when it is staged: w1f = w1[:, :D] + w1[:, D:] [2D, D] and
// b1f = b1[:D] + b1[D:], since z1[:D] + z1[D:] is linear in them; for the
// model's block-diagonal w1 the fold adds zeros, so it is exact, and for any
// other w1 it costs one f32 rounding per weight.
//
// Bound on an H100 SXM at the serving bucket-128 shape (B 128, T 21, Aq 49,
// Ak 48, D 64, H 8: 6.32 M pairs): 4.4e4 operations of the function per
// pair, of which the three products are 10 D^2 = 40,960.  Those run on the
// tensor cores at f32 accuracy (3 TF32 products each, at most 495 / 3 =
// 165 TFLOP/s): 1.57 ms; the rest on the CUDA cores 0.31 ms, at the same
// time; the inputs and output are 0.19 GB, 0.06 ms at 3.35 TB/s.  (Every
// operation on the CUDA cores at 67 TFLOP/s: 4.1 ms.)  What the kernel keeps
// out of device memory are the pair tensors (each [P, 128] activation would
// be 3.2 GB).  At the HiVT baseline's shape (B 128, T 21, Aq = Ak = 48, H 4:
// 6.19 M pairs) the same count gives 1.54 ms on the route.
//
// Design.  A persistent grid (one 512-thread block per SM) walks groups of
// 8 receivers with all their senders, in chunks of 64 pairs.
//   * The products a0 . w1f (K 128, N 64), a1 . wagg (64, 64) and
//     nbr . wkv (64, 128) run on the tensor cores (mma_tf32.cuh's
//     mma_xwt_split: mma.sync m16n8k8 TF32, each operand split into
//     big = rna_tf32(x) and small = rna_tf32(x - big); per two k-steps the
//     small terms go into one fresh fragment and big * big into another,
//     both added to f32 accumulators on the CUDA cores).  A CPU model of
//     this arithmetic (tests/test_torch_aa_fused_fwd_tf32.py) keeps out
//     within 0.76 of twice the f32 plain version's distance from f64; one
//     TF32 product alone is 1,300-1,600 times that.  Each of the 16 warps
//     owns one 16-row m-tile (warp mod 4) and 16 columns (F2, F3) or 32
//     columns of [k | v] (F4) (warp / 4).
//   * The weights are split once per block, when it stages them: w1f, wagg
//     and wkv as (big, small) TF32 pairs, 20,480 uint2 = 163,840 B; the
//     pair (r, c) of a matrix of row length ld lies at
//     r ld + (c ^ 4 (r mod 4)), so the B fragments (W[k = t][n = g]) are
//     read conflict-free.  Only the activations are split where they are
//     read (their chunk tiles change every chunk); split tiles would need
//     twice their 49,152 B, which do not fit beside the weights.
//   * Swizzled chunk tiles (aa_common.cuh's swz), 49,152 B: T0 [64][128]
//     a0, then two [64][64] halves, nbr and v; T1 [64][64] a1, then k.  A
//     product's raw sums land in its output tile as C fragments; after a
//     barrier its epilogue (aa_common.cuh: the bias, the LayerNorm, the
//     ReLU, the head logits) runs per row, each row's 64 columns in 16
//     lanes of one warp, 2 rows a thread, and writes the tile in place.
//     K4 (aa_fused_bwd.cu) recomputes the chain through the same product
//     and epilogue calls, so its logits are K3's bit for bit (the order
//     of each element's sums does not depend on the tiling).
//   * The softmax is an online one, once per (receiver, head): per chunk
//     the largest logit of each (receiver, head), 8 lanes each, and the
//     rescale of the running sums (S1); exp once per (pair, head) and e
//     times the keep mask (S2); then each (receiver, column) adds e keep v
//     in pair order and each (receiver, head) the sum of e (S3).  The exp
//     inputs and the order of every sum are those of the per-column
//     softmax this replaced, which took each exp 8 times.  No pair-sized
//     tensor is ever written.
//   * Shared memory: 163,840 B of split weights, 5,632 B of vectors (wu,
//     bu, the LayerNorm parameters, b1f, bagg, bkv), 49,152 B of tiles,
//     7,424 B of the chunk's u, mask, logits (then e), keep and e keep,
//     5,120 B of the group's q, sums and softmax state: 231,168 B, one
//     block per SM.  ptxas (sm_90a): 128 registers (the most 512 threads
//     may have), no spills, with the nbr . wkv k-loop not unrolled
//     (unrolled by 2 it spills 32 B and is no faster).  Eleven barriers a
//     chunk.
//   * Heads: the kernel is a template on the head count H, 8 (the
//     flagship's) or 4 (the HiVT baseline's), with an entry point each.  A
//     head's HD = 64 / H columns lie in HD / 4 neighbouring lanes of a row,
//     whose partial dot products head_logit sums by a butterfly
//     (aa_common.cuh); S1's lanes and S3's items follow H, and the [.][H]
//     tiles shrink with it.  S2 takes one (pair, head) a thread, so at 4
//     heads half the block waits there.  Nothing in the products depends
//     on H.
//   Measured on an H100 (scripts/compare_aa_fwd_builds_torch.py, PERF.md):
//   32-pair chunks with 8 warps took 14.6-14.9 ms at the serving shape,
//   64-pair chunks with 8 warps 12.1-12.4, with 16 warps 11.4-11.8, against
//   the FMA build's 14.6-15.2.  Loading the next chunk's u, mask and keep
//   while a chunk runs (into registers, or by cp.async) took 10.9-11.1 ms
//   but spilled 8-48 B at the 128-register cap, so it is not kept.
// The ragged last chunk and group are bounds-checked, and every output is
// summed by one thread in a fixed order, so reruns are bit-equal.
//
// For training, the launch can also write each (receiver, head)'s softmax
// statistics -- the running max and the sum of exp at the end of the walk,
// [2][R][H] -- which the backward kernel K4 reads instead of walking the
// senders twice.  The output does not depend on whether they are written.
// Built with -DAA_WRITE_LOGITS (a check copy, tests/test_torch_cuda.py) it
// also writes every pair's head logits (-inf where masked) to the buffer
// given by aa_fused_set_logits; built with -DAA_WRITE_PRERELU (a check copy,
// scripts/check_aa_bwd_f64_torch.py), every pair's a0 and a1 before their
// ReLUs to the buffer given by aa_fused_set_prerelu.  Neither changes the
// outputs, and the normal build compiles none of it.

#include "aa_common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace aa;

constexpr int P = 64;          // pairs per chunk
constexpr int RB = 8;          // receivers per group
constexpr int THREADS = 512;   // epilogues: 32 row groups (2 rows each) x 16 column groups
constexpr int NR = 2;          // rows per thread in the epilogues
constexpr int UNROLL = 2;      // k-loop unrolling of a0 . w1f and a1 . wagg
constexpr int UNROLL_KV = 1;   // and of nbr . wkv (unrolled by 2 it spills)

// split weights (uint2 slots): w1f [2D][D], wagg [D][D], wkv [D][2D]
constexpr int W_W1 = 0;
constexpr int W_AGG = W_W1 + D2 * D;
constexpr int W_KV = W_AGG + D * D;
constexpr int W_SLOTS = W_KV + D * D2;

// f32 shared memory (floats), after the staged weights (relative offsets)
constexpr int S_WU = 0;                        // wu, bu, ln0s, ln0b as packed
constexpr int S_BU = S_WU + (OFF_BU - OFF_WU);
constexpr int S_LN0S = S_WU + (OFF_LN0S - OFF_WU);
constexpr int S_LN0B = S_WU + (OFF_LN0B - OFF_WU);
constexpr int S_B1F = S_WU + (OFF_W1 - OFF_WU);  // [D]
constexpr int S_LNA0S = S_B1F + D;
constexpr int S_LNA0B = S_LNA0S + D;
constexpr int S_BAGG = S_LNA0B + D;
constexpr int S_LNA1S = S_BAGG + D;
constexpr int S_LNA1B = S_LNA1S + D;
constexpr int S_BKV = S_LNA1B + D;             // [2D]
constexpr int T0 = S_BKV + D2;                 // [P][2D] a0; then [P][D] nbr and [P][D] v
constexpr int T0B = T0 + P * D;                //   (v: the second [P][D] half)
constexpr int T1 = T0 + P * D2;                // [P][D] a1, then k
constexpr int S_U = T1 + P * D;                // [P][4]
constexpr int S_MASK = S_U + P * 4;            // [P]

// the rest of the layout, per head count H
template <int H>
struct Smem {
  static constexpr int S0 = 2 * W_SLOTS;       // where the f32 part starts (after the split weights)
  static constexpr int S_LG = S_MASK + P;      // [P][H] masked logits (-inf: no edge), then e
  static constexpr int S_KEEP = S_LG + P * H;  // [P][H]
  static constexpr int S_EK = S_KEEP + P * H;  // [P][H] e * keep
  static constexpr int S_Q = S_EK + P * H;     // [RB][D]
  static constexpr int S_ACC = S_Q + RB * D;   // [RB][D] running sum of e * keep * v
  static constexpr int S_M = S_ACC + RB * D;   // [RB][H] running max
  static constexpr int S_L = S_M + RB * H;     // [RB][H] running sum of e
  static constexpr int S_MNEW = S_L + RB * H;  // [RB][H] this chunk's max (-inf: no edge)
  static constexpr int S_CORR = S_MNEW + RB * H;  // [RB][H] exp(old max - new max)
  static constexpr int S_FLOATS = S0 + S_CORR + RB * H;

  static_assert(S0 % 4 == 0 && T0 % 4 == 0 && S_Q % 4 == 0 && S_WU % 4 == 0, "float4 alignment");
  static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");
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

#ifdef AA_WRITE_LOGITS
__device__ float* g_logits;  // [R * Ak][H]
#endif

#ifdef AA_WRITE_PRERELU
__device__ float* g_prerelu;  // [R * Ak][3 D]: a0 before its ReLU (2 D), then a1's (D)

// columns col .. col + 3 of the chunk's pair p (group-relative cp0 + p)
// before their ReLU, if the pair is live
__device__ __forceinline__ void write_prerelu(long long gp0, int cp0, int pend, int p, int col,
                                              const float x[4]) {
  if (cp0 + p < pend) store4(g_prerelu + (gp0 + p) * (3 * D) + col, x);
}

__device__ __forceinline__ void relu4(float x[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = fmaxf(x[j], 0.0f);
}
#endif

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
aa_fused_kernel(const float* __restrict__ q, const float* __restrict__ u,
                const float* __restrict__ mask, const float* __restrict__ keep,
                const float* __restrict__ w, float* __restrict__ out,
                float* __restrict__ stats, long long R, int Ak, float keep_scale) {
  using L = Smem<H>;
  constexpr int HD = Heads<H>::HD;
  constexpr int HL = Heads<H>::LANES;
  extern __shared__ __align__(16) float smem[];
  uint2* sw2 = reinterpret_cast<uint2*>(smem);
  float* sw = smem + L::S0;
  float* t0 = sw + T0;
  float* t0b = sw + T0B;
  float* t1 = sw + T1;
  float* su = sw + S_U;
  float* smask = sw + S_MASK;
  float* slg = sw + L::S_LG;
  float* skeep = sw + L::S_KEEP;
  float* sek = sw + L::S_EK;
  float* sq = sw + L::S_Q;
  float* sacc = sw + L::S_ACC;
  float* sm = sw + L::S_M;
  float* sl = sw + L::S_L;
  float* smnew = sw + L::S_MNEW;
  float* scorr = sw + L::S_CORR;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // epilogue column group: columns c0 .. c0+3 (and D + ...)
  const int c0 = cg * 4;
  const int r0 = (tid >> 4) * NR;
  const int warp = tid >> 5;    // products: m-tile warp % 4, column quarter warp / 4
  const int wm = 16 * (warp & 3);
  const int wn = warp >> 2;

  // stage the three matrices split (w1 folded)
  for (int i = tid; i < D2 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    sw2[W_W1 + w_at(r, c, D)] = tc::split2(w[OFF_W1 + r * D2 + c] + w[OFF_W1 + r * D2 + D + c]);
  }
  for (int i = tid; i < D * D; i += THREADS)
    sw2[W_AGG + w_at(i / D, i % D, D)] = tc::split2(w[OFF_WAGG + i]);
  for (int i = tid; i < D * D2; i += THREADS)
    sw2[W_KV + w_at(i / D2, i % D2, D2)] = tc::split2(w[OFF_WKV + i]);
  // and the vectors in f32
  for (int i = tid; i < OFF_W1; i += THREADS) sw[S_WU + i] = w[OFF_WU + i];
  if (tid < D) {
    sw[S_B1F + tid] = w[OFF_B1 + tid] + w[OFF_B1 + D + tid];
    sw[S_LNA0S + tid] = w[OFF_LNA0S + tid];
    sw[S_LNA0B + tid] = w[OFF_LNA0B + tid];
    sw[S_BAGG + tid] = w[OFF_BAGG + tid];
    sw[S_LNA1S + tid] = w[OFF_LNA1S + tid];
    sw[S_LNA1B + tid] = w[OFF_LNA1B + tid];
  }
  if (tid < D2) sw[S_BKV + tid] = w[OFF_BKV + tid];

  const long long groups = (R + RB - 1) / RB;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long rbase = g * RB;
    const int nrecv = static_cast<int>(R - rbase < RB ? R - rbase : RB);
    const int npairs = nrecv * Ak;
    const long long pbase = rbase * Ak;  // the group's first pair

    __syncthreads();  // the previous group's outputs are read out
    for (int i = tid; i < RB * D; i += THREADS) {
      const int rl = i / D;
      sq[i] = rl < nrecv ? q[(rbase + rl) * D + (i % D)] : 0.0f;
      sacc[i] = 0.0f;
    }
    if (tid < RB * H) {
      sm[tid] = -INFINITY;
      sl[tid] = 0.0f;
    }

    for (int cp0 = 0; cp0 < npairs; cp0 += P) {
      const int pend = min(cp0 + P, npairs);  // group-relative, exclusive
      const long long gp0 = pbase + cp0;      // global index of the chunk's first pair

      __syncthreads();  // the previous chunk's softmax update is done
      if (tid < P * 4) su[tid] = cp0 + tid / 4 < pend ? u[gp0 * 4 + tid] : 0.0f;
      if (tid < P) smask[tid] = cp0 + tid < pend ? mask[gp0 + tid] : 0.0f;
      if (P * H == THREADS || tid < P * H)
        skeep[tid] = keep == nullptr ? 1.0f : (cp0 + tid / H < pend ? keep[gp0 * H + tid] : 0.0f);
      __syncthreads();

      // F1. four rank-1 products, LayerNorm per D-wide branch, ReLU -> a0 (t0)
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
#ifdef AA_WRITE_PRERELU
        ln_row(hv[0], sw + S_LN0S, sw + S_LN0B, c0, false);
        ln_row(hv[1], sw + S_LN0S + D, sw + S_LN0B + D, c0, false);
        write_prerelu(gp0, cp0, pend, r0 + i, c0, hv[0]);
        write_prerelu(gp0, cp0, pend, r0 + i, D + c0, hv[1]);
        relu4(hv[0]);
        relu4(hv[1]);
#else
        ln_row(hv[0], sw + S_LN0S, sw + S_LN0B, c0, true);
        ln_row(hv[1], sw + S_LN0S + D, sw + S_LN0B + D, c0, true);
#endif
        store4(t0 + swz(r0 + i, c0, D2), hv[0]);
        store4(t0 + swz(r0 + i, D + c0, D2), hv[1]);
      }
      __syncthreads();

      // F2. a0 . w1f -> t1; a1 = relu(LN(. + b1f)) in place
      {
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
#ifdef AA_WRITE_PRERELU
        // epi_a1 with the ReLU after the write
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] += sw[S_B1F + c0 + j];
        ln_row(x, sw + S_LNA0S, sw + S_LNA0B, c0, false);
        write_prerelu(gp0, cp0, pend, r0 + i, D2 + c0, x);
        relu4(x);
#else
        epi_a1(x, sw + S_B1F, sw + S_LNA0S, sw + S_LNA0B, c0);
#endif
        store4(t1 + swz(r0 + i, c0, D), x);
      }
      __syncthreads();

      // F3. a1 . wagg -> t0 (a0 is read out); nbr = LN(. + bagg) in place
      {
        float acc[1][2][4] = {};
        tc::mma_xwt_split<1, 2, D, UNROLL>(Swz{t1, D}, WSplit{sw2 + W_AGG, D}, wm, 16 * wn, 8,
                                           acc);
        tc::store_c<2>(t0, SwzAt{D}, acc, wm, 16 * wn);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x[4];
        load4(x, t0 + swz(r0 + i, c0, D));
        epi_nbr(x, sw + S_BAGG, sw + S_LNA1S, sw + S_LNA1B, c0);
        store4(t0 + swz(r0 + i, c0, D), x);
      }
      __syncthreads();

      // F4. nbr . wkv: k -> t1 (a1 is read out), v -> t0b; + bkv; masked
      // head logits
      {
        float acc[1][4][4] = {};
        tc::mma_xwt_split<1, 4, D, UNROLL_KV>(Swz{t0, D}, WSplit{sw2 + W_KV, D2}, wm, 32 * wn, 8,
                                              acc);
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
        if (cg % HL == 0) {  // the head's first lane
          const float masked = (live && smask[p] > 0.0f) ? lg : -INFINITY;
          slg[p * H + cg / HL] = masked;
#ifdef AA_WRITE_LOGITS
          if (live) g_logits[(gp0 + p) * H + cg / HL] = masked;
#endif
        }
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
      // place of the logit, and e keep
      {
        const int p = tid / H, h = tid % H;
        if ((P * H == THREADS || tid < P * H) && cp0 + p < pend) {
          const float m_new = smnew[((cp0 + p) / Ak) * H + h];
          if (m_new != -INFINITY) {
            const float e = expf(slg[tid] - m_new);
            slg[tid] = e;
            sek[tid] = e * skeep[tid];
          }
        }
      }
      __syncthreads();

      // S3. per (receiver, column): the running sum of e keep v in pair
      // order; per (receiver, head): the running sum of e
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
          for (int p = pa; p < pb; ++p) a = fmaf(sek[p * H + h], t0b[swz(p, c, D)], a);
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
      out[rbase * D + i] = sacc[i] / fmaxf(sl[(i / D) * H + (i % D) / HD], 1e-16f) * keep_scale;
    if (stats != nullptr)
      for (int i = tid; i < nrecv * H; i += THREADS) {
        stats[rbase * H + i] = sm[i];
        stats[(R + rbase) * H + i] = sl[i];
      }
  }
}

// K3 at H heads on the stream; returns cudaGetLastError()
template <int H>
int launch(const float* q, const float* u, const float* mask, const float* keep, const float* w,
           float* out, float* stats, long long R, int Ak, float keep_scale, int grid,
           void* stream) {
  if (R <= 0 || Ak <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Smem<H>::S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_fused_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_fused_kernel<H><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, u, mask, keep, w, out, stats, R, Ak, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One set of entry points per head count: aa_fused_* at the flagship's 8
// heads, aa_fused_h4_* at the HiVT baseline's 4 (ops/aa_fused.py picks by
// the head count and refuses any other).  K3b's are in aa_fused_bf16.cu.
extern "C" {

// floats the packed weight buffer must hold (W_ORDER, flattened)
int aa_fused_weight_floats() { return W_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_fused_receivers_per_group() { return RB; }
int aa_fused_h4_receivers_per_group() { return RB; }

#ifdef AA_WRITE_LOGITS
// where the next launches write each pair's head logits, [R * Ak][H]
int aa_fused_set_logits(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_logits, &p, sizeof(p)));
}
#endif

#ifdef AA_WRITE_PRERELU
// where the next launches write each pair's a0 and a1 before their ReLUs,
// [R * Ak][3 * 64]
int aa_fused_set_prerelu(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_prerelu, &p, sizeof(p)));
}
#endif

// out [R, 64] from q [R, 64], u [R, Ak, 4], mask [R, Ak] (0/1 f32), keep
// [R, Ak, H] (0/1 f32) or NULL, w packed; keep_scale multiplies the output
// (1 / (1 - p) with keep, else 1).  stats [2, R, H] (softmax max, then sum
// of exp, per receiver and head) or NULL.  H is 8 here and 4 in
// aa_fused_h4_launch.  Returns cudaGetLastError().
int aa_fused_launch(const float* q, const float* u, const float* mask, const float* keep,
                    const float* w, float* out, float* stats, long long R, int Ak,
                    float keep_scale, int grid, void* stream) {
  return launch<8>(q, u, mask, keep, w, out, stats, R, Ak, keep_scale, grid, stream);
}

int aa_fused_h4_launch(const float* q, const float* u, const float* mask, const float* keep,
                       const float* w, float* out, float* stats, long long R, int Ak,
                       float keep_scale, int grid, void* stream) {
  return launch<4>(q, u, mask, keep, w, out, stats, R, Ak, keep_scale, grid, stream);
}

}  // extern "C"
