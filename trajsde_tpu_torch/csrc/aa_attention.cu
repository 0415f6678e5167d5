// Agent-agent attention from positions, forward (kernel K5).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_attention.py::aa_attention
// (pallas_call body _aa_kernel).  It computes the fused AA pair chain of K3
// (aa_fused.cu) with the chain's two prologues inside the kernel:
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
// H 8: 6.32 M pairs): K3's 4.4e4 f32 operations per pair, the u build's 14
// and the q projection's 2 D^2 per receiver, 2.8e11 in all, about 4.15 ms at
// the 67 TFLOP/s CUDA-core peak, against 0.08 GB of inputs and output (the
// centres, positions, rotations, the byte mask, the aggregate: 0.02 ms at
// 3.35 TB/s).  K5 is bound by arithmetic.  Against K3 it reads no u (101 MB
// at this shape) and no q, and writes no pair tensor.
//
// Design: K3's (aa_fused.cu, which this kernel leaves untouched so that K3's
// output bits cannot move; steps 1-5 below are K3's).  One persistent
// 256-thread block per SM owns groups of 16 receivers with all their
// senders and walks their pairs in chunks of 64 through two shared-memory
// tiles, with an online softmax per (receiver, column); f32 FMA register
// tiles (no TF32), shuffle LayerNorms and head dots.  Three differences:
//   * wq [64 x 64] and bq are staged once beside the 14 chain weights
//     (16,640 B more; 206,464 B in all, one block per SM): the projection
//     is 2 D^2 per receiver against the chain's 4.4e4 per pair, so reading
//     wq from L2 instead would save nothing that shows.  At each group's
//     start the group's centre rows are staged in the first chunk tile and
//     q is computed into the group's q tile, one row per 16 threads.
//   * The group's receiver positions and rotations are staged once; at
//     each chunk 64 threads build one pair's 4 features each from x_k and
//     pos_k (1 MB each at the twin shape, read through L2).
//   * No keep mask and no softmax statistics (forward only).
// Reruns are bit-equal: every output is summed by one thread in a fixed
// order.  The ragged last chunk and group are bounds-checked; pair offsets
// are 64-bit.

#include "aa_common.cuh"

namespace {

using namespace aa;

constexpr int H = 8;           // heads: the flagship's only (ops/aa_attention.py checks)
constexpr int HD = Heads<H>::HD;
constexpr float SCALE = Heads<H>::SCALE;
constexpr int P = 64;          // pairs per chunk
constexpr int RB = 16;         // receivers per group
constexpr int THREADS = 256;   // 16 row groups x 16 column groups

// the packed buffer: the 14 chain weights in W_ORDER, then wq [D][D], bq [D]
constexpr int OFF_WQ = W_FLOATS;
constexpr int OFF_BQ = OFF_WQ + D * D;
constexpr int WQ_FLOATS = OFF_BQ + D;

// shared memory (floats)
constexpr int S_W = 0;
constexpr int S_BUF0 = S_W + WQ_FLOATS;        // [P][2D]: the group's centre rows, a0, nbr
constexpr int S_BUF1 = S_BUF0 + P * D2;        // [P][D]: a1, then v
constexpr int S_U = S_BUF1 + P * D;            // [P][4]
constexpr int S_MASK = S_U + P * 4;            // [P]
constexpr int S_LG = S_MASK + P;               // [P][H] masked logits (-inf: no edge)
constexpr int S_Q = S_LG + P * H;              // [RB][D]
constexpr int S_M = S_Q + RB * D;              // [RB][D] running max
constexpr int S_L = S_M + RB * D;              // [RB][D] running sum of exp
constexpr int S_ACC = S_L + RB * D;            // [RB][D] running sum of exp * v
constexpr int S_PQ = S_ACC + RB * D;           // [RB][2] receiver positions
constexpr int S_ROT = S_PQ + RB * 2;           // [RB][4] receiver rotations
constexpr int S_FLOATS = S_ROT + RB * 4;

static_assert(WQ_FLOATS % 4 == 0 && S_BUF0 % 4 == 0 && S_U % 4 == 0 && S_Q % 4 == 0,
              "float4 alignment");
static_assert(RB * D <= P * D2, "the centre rows fit the first chunk tile");
static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");

__global__ void __launch_bounds__(THREADS, 1)
aa_attention_kernel(const float* __restrict__ center, const float* __restrict__ x_k,
                    const float* __restrict__ pos_q, const float* __restrict__ pos_k,
                    const float* __restrict__ rot, const unsigned char* __restrict__ mask,
                    const float* __restrict__ w, float* __restrict__ out, long long R, int T,
                    int Aq, int Ak) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem + S_W;
  float* buf0 = smem + S_BUF0;
  float* buf1 = smem + S_BUF1;
  float* su = smem + S_U;
  float* smask = smem + S_MASK;
  float* slg = smem + S_LG;
  float* sq = smem + S_Q;
  float* sm = smem + S_M;
  float* sl = smem + S_L;
  float* sacc = smem + S_ACC;
  float* spq = smem + S_PQ;
  float* srot = smem + S_ROT;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // column group
  const int c0 = cg * 4;
  const int r0 = (tid >> 4) * 4;

  for (int i = tid; i < WQ_FLOATS / 4; i += THREADS)
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
      buf0[i] = rl < nrecv ? center[(rbase + rl) * D + (i % D)] : 0.0f;
      sm[i] = -INFINITY;
      sl[i] = 0.0f;
      sacc[i] = 0.0f;
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

    // q = center . wq + bq: row tid / 16, columns c0 .. c0+3
    {
      float acc[1][8];
      zero<1>(acc);
      mm<1, D, D, D, false>(buf0, sw + OFF_WQ, tid >> 4, c0, acc);
      float qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = acc[0][j] + sw[OFF_BQ + c0 + j];
      store4(sq + (tid >> 4) * D + c0, qv);
    }

    for (int cp0 = 0; cp0 < npairs; cp0 += P) {
      const int pend = min(cp0 + P, npairs);  // group-relative, exclusive

      __syncthreads();  // the previous chunk's softmax update (or q) is done
      if (tid < P) {
        // pair (receiver rl, sender j): its 4 rotated features and mask bit
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
          live_edge = mask[pbase + p] != 0 ? 1.0f : 0.0f;
        }
        store4(su + tid * 4, f);
        smask[tid] = live_edge;
      }
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
          a = fmaf(e, buf1[p * D + c], a);
        }
        sm[si] = m_new;
        sl[si] = l;
        sacc[si] = a;
      }
    }

    __syncthreads();
    // alpha = e / max(sum e, 1e-16): a receiver with no sender gives exactly 0
    for (int i = tid; i < nrecv * D; i += THREADS)
      out[rbase * D + i] = sacc[i] / fmaxf(sl[i], 1e-16f);
  }
}

}  // namespace

extern "C" {

// floats the packed weight buffer must hold (W_ORDER, then wq and bq)
int aa_attention_weight_floats() { return WQ_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_attention_receivers_per_group() { return RB; }

// out [R, 64] (R = B T Aq, receivers in (b, t, i) order) from center
// [R, 64], x_k [B, T, Ak, 2], pos_q [R, 2], pos_k [B, T, Ak, 2], rot
// [B, Aq, 4], mask [R, Ak] (bytes, 0 = no edge) and the packed weights w.
// Returns cudaGetLastError().
int aa_attention_launch(const float* center, const float* x_k, const float* pos_q,
                        const float* pos_k, const float* rot, const unsigned char* mask,
                        const float* w, float* out, long long R, int T, int Aq, int Ak, int grid,
                        void* stream) {
  if (R <= 0 || T <= 0 || Aq <= 0 || Ak <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      center, x_k, pos_q, pos_k, rot, mask, w, out, R, T, Aq, Ak);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
