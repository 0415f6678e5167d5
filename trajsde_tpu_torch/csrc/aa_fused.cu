// Fused AA pair chain, forward (kernel K3).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_fused.py::_fwd_call
// (pallas_call body _fwd_kernel -> pair_chain).  For every receiver r and
// sender j of the encoder's agent-agent attention (r runs over B*T*Aq rows,
// j over Ak senders) it embeds the 4 rotated pair features u[r, j]:
//   h   = bu + sum_k u_k wu[k]                       (four rank-1 products, 2D wide)
//   a0  = relu(LN(h[:D]) | LN(h[D:]))                (one LayerNorm per D-wide branch)
//   z1  = a0 . w1 + b1                               (the full [2D, 2D] product)
//   a1  = relu(LN(z1[:D] + z1[D:]));  nbr = LN(a1 . wagg + bagg)
//   [k | v] = nbr . wkv + bkv
// then per head h a masked softmax over the senders of q[r]_h . k_h / sqrt(hd)
// (empty receivers give exactly 0), an optional 0/1 dropout keep mask times
// 1/(1-p) on the weights after normalisation, and out[r] = sum_j alpha v.
// LayerNorms use eps 1e-5 and a two-pass variance, as pair_chain does.
//
// Bound on an H100 SXM at the serving bucket-128 shape (B 128, T 21, Aq 49,
// Ak 48, D 64, H 8: 6.32 M pairs): about 4.4e4 f32 operations of the
// function per pair (2.8e11 in all, 4.1 ms at the 67 TFLOP/s CUDA-core
// peak) against 0.19 GB of inputs and output (0.06 ms at 3.35 TB/s).  The
// kernel is bound by arithmetic, and what it keeps out of device memory
// are the pair tensors (each [P, 128] activation would be 3.2 GB): a block
// stages the 14 weights (120,576 B) in shared memory once, owns a group of
// 16 receivers with all their senders, and walks their pairs in chunks of
// 64; each chunk's activations live in two shared-memory tiles, and the
// softmax is an online one per (receiver, column) -- running max, sum and
// weighted sum -- so no pair-sized tensor is ever written.  Each of the
// 256 threads computes a 4-row x 8-column (or 4 x 4) register tile of
// every product from float4 shared-memory loads; a row's 64 columns sit in
// 16 lanes of one warp, so LayerNorm statistics and the head dot products
// are shuffle reductions.  f32 FMAs throughout (no TF32).  The grid is
// persistent (one block per SM walks the groups), the ragged last chunk
// and group are bounds-checked, and every output is summed by one thread
// in a fixed order, so reruns are bit-equal.
//
// For training, the launch can also write each (receiver, head)'s softmax
// statistics -- the running max and the sum of exp at the end of the walk,
// [2][R][H] -- which the backward kernel K4 (aa_fused_bwd.cu) reads instead
// of walking the senders twice.  The output does not depend on whether
// they are written.

#include "aa_common.cuh"

namespace {

using namespace aa;

constexpr int P = 64;          // pairs per chunk
constexpr int RB = 16;         // receivers per group
constexpr int THREADS = 256;   // 16 row groups x 16 column groups

// shared memory (floats)
constexpr int S_W = 0;
constexpr int S_BUF0 = S_W + W_FLOATS;         // [P][2D]: a0, then nbr (first D columns)
constexpr int S_BUF1 = S_BUF0 + P * D2;        // [P][D]: a1, then v
constexpr int S_U = S_BUF1 + P * D;            // [P][4]
constexpr int S_MASK = S_U + P * 4;            // [P]
constexpr int S_LG = S_MASK + P;               // [P][H] masked logits (-inf: no edge)
constexpr int S_KEEP = S_LG + P * H;           // [P][H]
constexpr int S_Q = S_KEEP + P * H;            // [RB][D]
constexpr int S_M = S_Q + RB * D;              // [RB][D] running max
constexpr int S_L = S_M + RB * D;              // [RB][D] running sum of exp
constexpr int S_ACC = S_L + RB * D;            // [RB][D] running sum of exp * keep * v
constexpr int S_FLOATS = S_ACC + RB * D;

static_assert(S_BUF0 % 4 == 0 && S_Q % 4 == 0, "float4 alignment");
static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");

__global__ void __launch_bounds__(THREADS, 1)
aa_fused_kernel(const float* __restrict__ q, const float* __restrict__ u,
                const float* __restrict__ mask, const float* __restrict__ keep,
                const float* __restrict__ w, float* __restrict__ out,
                float* __restrict__ stats, long long R, int Ak, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem + S_W;
  float* buf0 = smem + S_BUF0;
  float* buf1 = smem + S_BUF1;
  float* su = smem + S_U;
  float* smask = smem + S_MASK;
  float* slg = smem + S_LG;
  float* skeep = smem + S_KEEP;
  float* sq = smem + S_Q;
  float* sm = smem + S_M;
  float* sl = smem + S_L;
  float* sacc = smem + S_ACC;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // column group
  const int c0 = cg * 4;
  const int r0 = (tid >> 4) * 4;

  for (int i = tid; i < W_FLOATS / 4; i += THREADS)
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(w)[i];

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
      sm[i] = -INFINITY;
      sl[i] = 0.0f;
      sacc[i] = 0.0f;
    }

    for (int cp0 = 0; cp0 < npairs; cp0 += P) {
      const int pend = min(cp0 + P, npairs);  // group-relative, exclusive
      const long long gp0 = pbase + cp0;      // global index of the chunk's first pair

      __syncthreads();  // the previous chunk's softmax update is done
      {
        const int p = tid >> 2;  // 64 pairs x 4 features
        su[tid] = cp0 + p < pend ? u[gp0 * 4 + tid] : 0.0f;
      }
      if (tid < P) smask[tid] = cp0 + tid < pend ? mask[gp0 + tid] : 0.0f;
      for (int i = tid; i < P * H; i += THREADS)
        skeep[i] = keep == nullptr ? 1.0f : (cp0 + i / H < pend ? keep[gp0 * H + i] : 0.0f);
      __syncthreads();

      float acc[4][8];

      // 1. four rank-1 products, LayerNorm per D-wide branch, ReLU -> buf0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* up = su + (r0 + i) * 4;
        float hv[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = half * D + c0 + j;
            float s = up[0] * sw[OFF_WU + col] + up[1] * sw[OFF_WU + D2 + col];
            s += up[2] * sw[OFF_WU + 2 * D2 + col];
            s += up[3] * sw[OFF_WU + 3 * D2 + col];
            hv[half][j] = sw[OFF_BU + col] + s;
          }
        ln_row(hv[0], sw + OFF_LN0S, sw + OFF_LN0B, c0, true);
        ln_row(hv[1], sw + OFF_LN0S + D, sw + OFF_LN0B + D, c0, true);
        store4(buf0 + (r0 + i) * D2 + c0, hv[0]);
        store4(buf0 + (r0 + i) * D2 + D + c0, hv[1]);
      }
      __syncthreads();

      // 2. z1 = a0 . w1 + b1; the halves summed, LayerNorm, ReLU -> buf1
      zero<4>(acc);
      mm<4, D2, D2, D2, true>(buf0, sw + OFF_W1, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = (acc[i][j] + sw[OFF_B1 + c0 + j]) + (acc[i][4 + j] + sw[OFF_B1 + D + c0 + j]);
        ln_row(s, sw + OFF_LNA0S, sw + OFF_LNA0B, c0, true);
        store4(buf1 + (r0 + i) * D + c0, s);
      }
      __syncthreads();

      // 3. nbr = LN(a1 . wagg + bagg) -> buf0 (first D columns)
      zero<4>(acc);
      mm<4, D, D, D, false>(buf1, sw + OFF_WAGG, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = acc[i][j] + sw[OFF_BAGG + c0 + j];
        ln_row(s, sw + OFF_LNA1S, sw + OFF_LNA1B, c0, false);
        store4(buf0 + (r0 + i) * D2 + c0, s);
      }
      __syncthreads();

      // 4. [k | v] = nbr . wkv + bkv; masked head logits -> slg, v -> buf1
      zero<4>(acc);
      mm<4, D, D2, D2, true>(buf0, sw + OFF_WKV, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = r0 + i;
        const bool live = cp0 + p < pend;
        const int rl = live ? (cp0 + p) / Ak : 0;
        const float4 qv = *reinterpret_cast<const float4*>(sq + rl * D + c0);
        float part = qv.x * (acc[i][0] + sw[OFF_BKV + c0]);
        part = fmaf(qv.y, acc[i][1] + sw[OFF_BKV + c0 + 1], part);
        part = fmaf(qv.z, acc[i][2] + sw[OFF_BKV + c0 + 2], part);
        part = fmaf(qv.w, acc[i][3] + sw[OFF_BKV + c0 + 3], part);
        // a head's 8 columns are the 4 of this lane and the 4 of its neighbour
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if ((cg & 1) == 0)
          slg[p * H + (cg >> 1)] = (live && smask[p] > 0.0f) ? part * SCALE : -INFINITY;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[i][4 + j] + sw[OFF_BKV + D + c0 + j];
        store4(buf1 + p * D + c0, v);
      }
      __syncthreads();

      // 5. online softmax over the chunk's senders, per (receiver, column)
      const int rl_lo = cp0 / Ak;
      const int nspan = (pend - 1) / Ak - rl_lo + 1;
      for (int item = tid; item < nspan * D; item += THREADS) {
        const int rl = rl_lo + item / D;
        const int c = item % D;
        const int h = c / HD;
        const int pa = max(cp0, rl * Ak) - cp0;
        const int pb = min(pend, (rl + 1) * Ak) - cp0;
        float cmax = -INFINITY;
        for (int p = pa; p < pb; ++p) cmax = fmaxf(cmax, slg[p * H + h]);
        if (cmax == -INFINITY) continue;  // no edge of this receiver in the chunk
        const int si = rl * D + c;
        const float m_new = fmaxf(sm[si], cmax);
        const float corr = expf(sm[si] - m_new);  // 0 while nothing was seen
        float l = sl[si] * corr, a = sacc[si] * corr;
        for (int p = pa; p < pb; ++p) {
          const float e = expf(slg[p * H + h] - m_new);  // 0 for a masked pair
          l += e;
          a = fmaf(e * skeep[p * H + h], buf1[p * D + c], a);
        }
        sm[si] = m_new;
        sl[si] = l;
        sacc[si] = a;
      }
    }

    __syncthreads();
    // alpha = e / max(sum e, 1e-16): a receiver with no sender gives exactly 0
    for (int i = tid; i < nrecv * D; i += THREADS)
      out[rbase * D + i] = sacc[i] / fmaxf(sl[i], 1e-16f) * keep_scale;
    // a head's 8 columns saw the same logits in the same order: its first
    // column's max and sum are the head's
    if (stats != nullptr)
      for (int i = tid; i < nrecv * H; i += THREADS) {
        const int si = (i / H) * D + (i % H) * HD;
        stats[rbase * H + i] = sm[si];
        stats[(R + rbase) * H + i] = sl[si];
      }
  }
}

}  // namespace

extern "C" {

// floats the packed weight buffer must hold (W_ORDER, flattened)
int aa_fused_weight_floats() { return W_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_fused_receivers_per_group() { return RB; }

// out [R, 64] from q [R, 64], u [R, Ak, 4], mask [R, Ak] (0/1 f32), keep
// [R, Ak, 8] (0/1 f32) or NULL, w packed; keep_scale multiplies the output
// (1 / (1 - p) with keep, else 1).  stats [2, R, 8] (softmax max, then sum
// of exp, per receiver and head) or NULL.  Returns cudaGetLastError().
int aa_fused_launch(const float* q, const float* u, const float* mask, const float* keep,
                    const float* w, float* out, float* stats, long long R, int Ak,
                    float keep_scale, int grid, void* stream) {
  if (R <= 0 || Ak <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_fused_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, u, mask, keep, w, out, stats, R, Ak, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
