// Reverse sweep of the decoder's Euler-Maruyama rollout (kernel K2): the
// backward of K1 (sde_rollout.cu) for the fused training rollout.
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/sde_rollout.py::_rollout_train_bwd
// (pallas_call body _rollout_bwd_kernel).  For each row, walking t = T-1 .. 0
// with lambda the cotangent of the running state:
//   lambda += ct[t]
//   recompute from the pre-step state y_t (y0, or ys[t-1] read in place):
//     h1 = tanh(y wf0 + tf + bf0), h2 = tanh(h1 wf1 + bf1),
//     hg1, hg2 likewise, g = sigmoid(hg2 wgo + bgo)      (tf: sin/cos time terms)
//   regenerate z with K1's counter hash (seed, global row, step, word)
//   drift:     dF = lambda dt;  dA2 = (dF wf2^T)(1 - h2^2);  dA1 = (dA2 wf1^T)(1 - h1^2)
//   diffusion: dO = sqrt(dt) (lambda . z) g (1 - g);  dAG2 = (dO wgo^T)(1 - hg2^2);
//              dAG1 = (dAG2 wg1^T)(1 - hg1^2)
//   weights:   dwf2 += h2^T dF, dwf1 += h1^T dA2, dwf0 += y^T dA1, dwg1 += hg1^T dAG2,
//              dwg0 += y^T dAG1, biases += column sums, dwf0t/dwg0t += (sin, cos) x sums,
//              dwgo += hg2^T dO, dbgo += sum dO
//   lambda <- lambda + dA1 wf0^T + dAG1 wg0^T;  after t = 0, dy0 = lambda.
// No draw is stored: the increments are regenerated.  t0s, dts and explicit
// noise get no gradient.
//
// Bound on an H100 SXM at the training shape (N = 61,440 rows, T = 60, D = 64):
// per row-step 4 recomputed, 5 input-gradient and 5 weight-gradient 64x64
// products plus three 64-wide dot products, 28 D^2 + 6 D = 115,072 flop,
// 4.24e11 in all.  The 14 products run on the FP64 tensor cores
// (mma_f64.cuh): 4.23e11 flop at 67 TFLOP/s is 6.3 ms; reading ys and ct is
// 1.9 GB, 0.56 ms at 3.35 TB/s.  So K2 is bound by the FP64 tensor cores.
// (In 3xTF32 on the TF32 tensor cores, three products each at 495 TFLOP/s,
// the bound was 2.56 ms; see "Every product" below for why they are f64.)
//
// Design.  A persistent grid (one 256-thread block per SM) walks 32-row
// tiles; each tile runs all T steps backwards inside the block (the loop
// replaces the TPU's reversed step grid axis).  32-row tiles give 1,920
// tiles at the training shape, 15 rounds on 132 SMs with a short last one.
//   * The five 64 x 64 weights are the same for every row, step and tile,
//     so they are widened to f64 once, when the block stages them:
//     5 x 64 x 64 doubles = 163,840 B of shared memory.  Entry (r, c) lies
//     at r * 64 + (c ^ 4 (r mod 4)) (8-byte slots): the forward products
//     read B fragments at W[k = t][n = g] and the input gradients at
//     W[n = g][k = t], and both are conflict-free under this XOR.
//   * Seven 32-row f32 activation tiles (57,344 B), XOR-swizzled by
//     16-byte granule (tile_at), so that the A fragments (X[g][t]), the
//     weight-gradient operands (X[t][g]) and the float2 stores of C
//     fragments are conflict-free; the activations change every step and
//     are widened per use.  Slots: y; dF, then dA1; h1; hg1; h2, then dAG1;
//     dA2; hg2, then dAG2.  The tanh derivatives are taken from the h1 and
//     hg1 tiles when they are needed, not kept in registers.  With the small weights (2,576 B) and the diffusion
//     logit's exchange (1,024 B): 224,784 B, one block per SM.
//   * Each of the 8 warps owns one 16-row m-tile and the n-tiles j and
//     j + 4 (columns 8 j .. and 8 j + 32 ..) of every row product, so a
//     thread holds both lanes (p, p + 32) of each Box-Muller pair it draws,
//     and lambda stays in registers as C fragments for all T steps.
//   * lambda is carried in f64: ct[t] is added in f64, and its two input
//     gradients (dA1 wf0^T, dAG1 wg0^T) go into it as the f64 mma's own C,
//     unrounded; dF = lambda dt, lambda . z and dy0 read it rounded to f32.
//     bgo's gradient sums sqrt(dt) (lambda . z) g (1 - g) over every row
//     and step, terms that cancel, so lambda's own f32 rounding over the
//     T steps reached it: with lambda in f32, K2 read bgo at 7.6x the f32
//     plain version's distance from an f64 oracle at one of sixteen
//     inputs (scripts/check_rollout_bwd_f64_inputs_torch.py), and the CPU
//     model misses 2x at seed 11 the same way, where f64 meets it.
//   * Every product is a warp-level f64 mma.sync m16n8k8 of the widened
//     f32 operands: per two k-steps the exact products are summed in f64
//     in a fresh fragment, rounded to nearest f32 once and added to f32
//     accumulators on the CUDA cores (mma_f64.cuh).  In 3xTF32, as K3 and
//     K4 sum, the TF32 tensor cores cut each addend toward zero, and over
//     61,440 rows x 60 steps that one-sided cut added up to a bias on sums
//     that cancel: K2 read up to 7.8x the f32 plain version's distance from
//     an f64 oracle on bg1 and bgo.  A CPU model of this sweep
//     (tests/test_torch_sde_rollout_tf32.py, mode f64tc-lambda) meets 2x at
//     seeds 0 and 1-30 with these products and an f64 lambda, ys from the
//     plain forward and from K1's, where f64 products for the 10 gradients
//     alone (the 4 recomputed forward products left in 3xTF32) miss it at
//     three of seeds 20-27.  The five weight
//     gradients are block-private C fragments in registers: each warp owns
//     a 32 x 16 block of each, 80 floats a thread, summed over every row of
//     every tile the block walks.
//   * The bias, time-feature and wgo gradients are column sums: each
//     thread adds its own elements in registers, and the rows are summed
//     by warp shuffles and one exchange through shared memory at the end.
//     The diffusion logit and lambda . z are row sums: shuffles over the
//     4 lanes of a row, then the 4 warps of an m-tile through shared
//     memory, in a fixed order.
//   * The next step's ys[t-2] and ct[t-1] are loaded into registers (16
//     floats a thread) at the start of a step and written to shared memory
//     at the start of the next one.
//   * Six barriers a step: y and dF in (A); h1, hg1 (B); h2, hg2, dA2 and
//     the logit's partial sums (C); dO, dAG2, dwf2, dwf1, dA1 (D); dwg1,
//     dAG1 (E); dwf0, dwg0 and lambda (F).  Where a phase has two products
//     of a kind, one loop runs both (mma_xwt2, mma_xty2), so that their
//     fragments interleave: on an H100, in 3xTF32, the pairs took K2 from
//     16.5 to 15.0 ms.  (Pairing dA1's product with dAG1's in E instead
//     gave the same time and spilled.)
//   * After each tile the block adds its weight gradients (registers, f32
//     over the tile's T steps) to its own row of a [grid, W_FLOATS] f64
//     workspace, and reduce_partials sums the rows in block order in f64.
//     So no f32 sum runs over more than one tile, as the f32 plain version
//     sums each step's products over all rows at once; summed in f32 over
//     a block's 15 tiles, the weight gradients were 4-8x farther from an
//     f64 oracle than the plain version's (scripts/check_rollout_bwd_f64_torch.py).
//     No float atomics: the gradients are the same run after run.
// The ragged last tile is bounds-checked: rows past N carry zero lambda and
// contribute nothing, so no padding copy exists.
// Registers: 80 for the weight gradients, 16 lambda, 16 prefetch, 11 column
// sums; ptxas (sm_90a) gives the three instantiations 255 registers and
// 12-36 bytes of spills with the weight-gradient products' k-loop not
// unrolled (UNROLL_W = 1).  On an H100 at the training shape K2 takes
// 12.8-13.4 ms (explicit and gaussian increments) against 14.9-15.2 for
// its 3xTF32 build and 12.7-13.2 with lambda in f32, timed in turns, of
// which 3.2-3.3 ms are the rest with the 14 products skipped
// (scripts/compare_rollout_bwd_builds_torch.py): one f64 mma in place of
// six TF32 ones and no split of the activations.

#include "mma_f64.cuh"
#include "rollout_common.cuh"

namespace {

using namespace rollout;

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int TILE = ROWS * D;                  // floats
constexpr int NSMALL = W_FLOATS - OFF_WF0T;     // wf0t .. bgo, kept in f32
constexpr int NTILES = 7;
constexpr int SMEM_BYTES = 5 * MAT * 8 + 4 * (NSMALL + NTILES * TILE + ROWS * 4 * 2);
constexpr int UNROLL = 2;     // k-loop unrolling of the row products
constexpr int UNROLL_W = 1;   // and of the weight-gradient products
enum { WF0, WF1, WF2, WG0, WG1 };   // matrix m at m * MAT in the packed layout
static_assert(OFF_WF1 == MAT && OFF_WG1 == WG1 * MAT, "packed matrices");
static_assert(NSMALL % 4 == 0 && SMEM_BYTES <= 232448, "shared memory");

// slot of a weight (r, c) in its 64 x 64 matrix
__device__ __forceinline__ int w_at(int r, int c) { return r * D + (c ^ ((r & 3) << 2)); }

// index of (r, c) in a swizzled activation tile: the row's 16-byte granules
// permuted by an XOR with 2 (r mod 4) + (r / 4 mod 2)
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * D + (c ^ ((((r & 3) << 1) | ((r >> 2) & 1)) << 2));
}

struct Tile {  // an activation tile, x(row, col)
  const float* p;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[tile_at(r, c)]; }
};
struct WFwd {  // B of x W: w(n, k) = W[k][n]
  const double* p;
  __device__ __forceinline__ double operator()(int n, int k) const { return p[w_at(k, n)]; }
};
struct WTr {  // B of dY W^T: w(n, k) = W[n][k]
  const double* p;
  __device__ __forceinline__ double operator()(int n, int k) const { return p[w_at(n, k)]; }
};

template <class V, int A, int B, int C>
__device__ __forceinline__ void zero(V (&x)[A][B][C]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int c = 0; c < C; ++c) x[a][b][c] = V(0);
}

// the 16 floats of the next step: the tile's 32 x 64 pre-step state, two
// float4 a thread in row order, and ct at the thread's C-fragment places
struct Prefetch {
  float4 y[2];
  float2 ct[2][2];   // [n-tile][row half]
};

__device__ __forceinline__ void prefetch(Prefetch& pf, const float* __restrict__ prev,
                                         const float* __restrict__ ctt, long long row0, int N,
                                         int tid, int frow, int fcol) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = tid + THREADS * q;
    const long long row = row0 + (f >> 4);
    pf.y[q] = row < N ? __ldg(reinterpret_cast<const float4*>(prev + row * D + 4 * (f & 15)))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + frow + 8 * h;
      pf.ct[j][h] = row < N ? __ldg(reinterpret_cast<const float2*>(ctt + row * D + fcol + 32 * j))
                            : make_float2(0.0f, 0.0f);
    }
}

// a thread's C-fragment values v[j][e] into a swizzled tile (rows frow,
// frow + 8; columns fcol, fcol + 1 of n-tiles j = 0, 1 at 32 j)
__device__ __forceinline__ void store_frag(float* tile, const float (&v)[1][2][4], int frow,
                                           int fcol) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + tile_at(frow + 8 * h, fcol + 32 * j)) =
          make_float2(v[0][j][2 * h], v[0][j][2 * h + 1]);
}

// the same places of a tile into v
__device__ __forceinline__ void load_frag(float (&v)[1][2][4], const float* tile, int frow,
                                          int fcol) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(tile + tile_at(frow + 8 * h, fcol + 32 * j));
      v[0][j][2 * h] = x.x;
      v[0][j][2 * h + 1] = x.y;
    }
}

// v *= 1 - h^2, h at the same places of a tile of tanh outputs
__device__ __forceinline__ void scale_by_tanh_derivative(float (&v)[1][2][4], const float* tile,
                                                         int frow, int fcol) {
  float h[1][2][4];
  load_frag(h, tile, frow, fcol);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[0][j][e] *= 1.0f - h[0][j][e] * h[0][j][e];
}

// the column sum over a warp's 16 rows of one of a thread's four columns:
// v's rows frow and frow + 8 are added, then the 8 row lanes (g) reduce
// and scatter the four columns (lane bits 4 and 3 pick n-tile j and column
// k of the pair), four shuffles in all.  Every lane gets the sum of column
// fcol + 32 ((lane >> 4) & 1) + ((lane >> 3) & 1); lanes g and g ^ 1 the same.
__device__ __forceinline__ float colsum(const float (&v)[1][2][4]) {
  const int lane = threadIdx.x & 31;
  const bool hi = lane & 16, odd = lane & 8;
  float cs[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) cs[j][k] = v[0][j][k] + v[0][j][k + 2];
  const float a = (hi ? cs[1][0] : cs[0][0]) +
                  __shfl_xor_sync(0xffffffffu, hi ? cs[0][0] : cs[1][0], 16);
  const float b = (hi ? cs[1][1] : cs[0][1]) +
                  __shfl_xor_sync(0xffffffffu, hi ? cs[0][1] : cs[1][1], 16);
  const float x = (odd ? b : a) + __shfl_xor_sync(0xffffffffu, odd ? a : b, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
rollout_bwd_kernel(const float* __restrict__ y0, const float* __restrict__ ys,
                   const float* __restrict__ ct, const float* __restrict__ w,
                   const float* __restrict__ tsc, const float* __restrict__ noise,
                   float* __restrict__ dy0, double* __restrict__ partial,
                   int N, int T, uint32_t k1, uint32_t k2, const uint32_t* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  load_keys(keys, k1, k2);
  double* sw = reinterpret_cast<double*>(smem_raw);                // weights, widened
  float* ssm = reinterpret_cast<float*>(smem_raw + 5 * MAT * 8);  // wf0t .. bgo
  float* sY = ssm + NSMALL;         // pre-step state y_t
  float* sDF = sY + TILE;           // lambda dt, then dA1
  float* sH1 = sDF + TILE;          // drift hidden 1
  float* sG1 = sH1 + TILE;          // diffusion hidden 1
  float* sH2 = sG1 + TILE;          // drift hidden 2, then dAG1
  float* sDA2 = sH2 + TILE;         // dA2
  float* sX = sDA2 + TILE;          // dAG2
  float2* sO = reinterpret_cast<float2*>(sX + TILE);  // [row][n-group] (logit, lambda . z)
  float* sDA1 = sDF;
  float* sDAG1 = sH2;
  const float* wf0t = ssm;
  const float* wg0t = ssm + (OFF_WG0T - OFF_WF0T);
  const float* bf0 = ssm + (OFF_BF0 - OFF_WF0T);
  const float* bf1 = ssm + (OFF_BF1 - OFF_WF0T);
  const float* bg0 = ssm + (OFF_BG0 - OFF_WF0T);
  const float* bg1 = ssm + (OFF_BG1 - OFF_WF0T);
  const float* wgo = ssm + (OFF_WGO - OFF_WF0T);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int mt = warp >> 2, jn = warp & 3;        // row products: m-tile, n-tiles jn and jn + 4
  const int frow = 16 * mt + g, fcol = 8 * jn + 2 * t4;   // this thread's C-fragment places
  const int gm0 = 32 * (warp >> 2), gn0 = 16 * (warp & 3);  // weight gradients: 32 x 16 block

  for (int i = tid; i < 5 * MAT; i += THREADS) {
    const int m = i / MAT, r = (i % MAT) / D, c = i % D;
    sw[m * MAT + w_at(r, c)] = static_cast<double>(w[i]);
  }
  for (int i = tid; i < NSMALL / 4; i += THREADS)
    reinterpret_cast<float4*>(ssm)[i] = reinterpret_cast<const float4*>(w + OFF_WF0T)[i];
  const double *wf0 = sw + WF0 * MAT, *wf1 = sw + WF1 * MAT, *wf2 = sw + WF2 * MAT,
              *wg0 = sw + WG0 * MAT, *wg1 = sw + WG1 * MAT;

  float gw[5][2][2][4];                           // weight gradients, C fragments
#pragma unroll
  for (int m = 0; m < 5; ++m) zero(gw[m]);
  // column sums over this warp's 16 rows of every tile and step, of the
  // column colsum() gives this lane; and dO summed over rows frow, frow + 8
  float cbf2 = 0.0f, cwgo = 0.0f, cbf1 = 0.0f, cbg1 = 0.0f;
  float cbf0 = 0.0f, cwf0s = 0.0f, cwf0c = 0.0f, cbg0 = 0.0f, cwg0s = 0.0f, cwg0c = 0.0f;
  float cbgo = 0.0f;

  double* part = partial + static_cast<size_t>(blockIdx.x) * W_FLOATS;   // this block's sums
  constexpr int NQ = 10;
  const int qoff[NQ] = {OFF_BF2, OFF_WGO, OFF_BF1, OFF_BG1, OFF_BF0, OFF_WF0T, OFF_WF0T + D,
                        OFF_BG0, OFF_WG0T, OFF_WG0T + D};
  const int ccol = fcol + 32 * ((lane >> 4) & 1) + ((lane >> 3) & 1);   // colsum()'s column
  const bool first = (lane & 4) == 0;                 // one of the lanes g, g ^ 1

  const int ntiles = (N + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * ROWS;
    double lam[1][2][4];   // f64: see "lambda" in the design notes
    zero(lam);
    Prefetch pf;
    prefetch(pf, T == 1 ? y0 : ys + static_cast<long long>(T - 2) * N * D,
             ct + static_cast<long long>(T - 1) * N * D, row0, N, tid, frow, fcol);
    for (int t = T - 1; t >= 0; --t) {
      const float s = tsc[4 * t], c = tsc[4 * t + 1], dt = tsc[4 * t + 2], sdt = tsc[4 * t + 3];

      // A: pre-step state; inject ct[t]; dF = lambda dt; prefetch step t - 1
      {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = tid + THREADS * q;
          *reinterpret_cast<float4*>(sY + tile_at(f >> 4, 4 * (f & 15))) = pf.y[q];
        }
        float df[1][2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            lam[0][j][2 * h] += pf.ct[j][h].x;
            lam[0][j][2 * h + 1] += pf.ct[j][h].y;
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) df[0][j][e] = static_cast<float>(lam[0][j][e]) * dt;
        store_frag(sDF, df, frow, fcol);
        cbf2 += colsum(df);
        if (t > 0)
          prefetch(pf, t == 1 ? y0 : ys + static_cast<long long>(t - 2) * N * D,
                   ct + static_cast<long long>(t - 1) * N * D, row0, N, tid, frow, fcol);
      }
      __syncthreads();

      // B: first hidden layers, time features as bias
      {
        float a[1][2][4], b[1][2][4];
        zero(a);
        zero(b);
        dtc::mma_xwt2<1, 2, D, UNROLL>(Tile{sY}, WFwd{wf0}, a, Tile{sY}, WFwd{wg0}, b,
                                            16 * mt, 8 * jn, 32);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = fcol + 32 * j + (e & 1);
            const float bf = s * wf0t[col] + c * wf0t[D + col] + bf0[col];
            const float bg = s * wg0t[col] + c * wg0t[D + col] + bg0[col];
            a[0][j][e] = tanhf(a[0][j][e] + bf);
            b[0][j][e] = tanhf(b[0][j][e] + bg);
          }
        store_frag(sH1, a, frow, fcol);
        store_frag(sG1, b, frow, fcol);
      }
      __syncthreads();

      // C: second hidden layers, dA2, the diffusion logit's and lambda . z's
      // partial row sums
      {
        float a[1][2][4], g2[1][2][4], d[1][2][4];
        zero(a);
        zero(g2);
        zero(d);
        dtc::mma_xwt2<1, 2, D, UNROLL>(Tile{sH1}, WFwd{wf1}, a, Tile{sG1}, WFwd{wg1}, g2,
                                            16 * mt, 8 * jn, 32);
        dtc::mma_xwt<1, 2, D, UNROLL>(Tile{sDF}, WTr{wf2}, 16 * mt, 8 * jn, 32, d);
        float o[2] = {0.0f, 0.0f}, dg[2] = {0.0f, 0.0f};
        float z[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + frow + 8 * h;
          if (MODE == EXPLICIT) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 v = row < N ? __ldg(reinterpret_cast<const float2*>(
                                             noise + (static_cast<long long>(t) * N + row) * D +
                                             fcol + 32 * j))
                                       : make_float2(0.0f, 0.0f);
              z[j][2 * h] = v.x;
              z[j][2 * h + 1] = v.y;
            }
          } else if (MODE == RADEMACHER) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int k = 0; k < 2; ++k)
                z[j][2 * h + k] = rademacher(k1, k2, static_cast<uint64_t>(row), t, T,
                                             fcol + 32 * j + k);
          } else {
            // columns p and p + 32 are the two lanes of Box-Muller pair p
#pragma unroll
            for (int k = 0; k < 2; ++k)
              gaussian_pair(k1, k2, static_cast<uint64_t>(row), t, T, fcol + k, &z[0][2 * h + k],
                            &z[1][2 * h + k]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = fcol + 32 * j + (e & 1);
            const float h2 = tanhf(a[0][j][e] + bf1[col]);
            g2[0][j][e] = tanhf(g2[0][j][e] + bg1[col]);
            a[0][j][e] = h2;
            d[0][j][e] *= 1.0f - h2 * h2;
            o[e >> 1] = fmaf(g2[0][j][e], wgo[col], o[e >> 1]);
            dg[e >> 1] = fmaf(static_cast<float>(lam[0][j][e]), z[j][e], dg[e >> 1]);
          }
        store_frag(sH2, a, frow, fcol);
        store_frag(sX, g2, frow, fcol);   // hg2, until dAG2 replaces it in D
        store_frag(sDA2, d, frow, fcol);
        cbf1 += colsum(d);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            o[h] += __shfl_xor_sync(0xffffffffu, o[h], off);
            dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], off);
          }
          if (t4 == 0) sO[(frow + 8 * h) * 4 + jn] = make_float2(o[h], dg[h]);
        }
      }
      __syncthreads();

      // D: dO, dAG2; dwf2 += h2^T dF; dwf1 += h1^T dA2; dA1 = (dA2 wf1^T)(1 - h1^2)
      float da1[1][2][4];
      {
        float dO[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2* v = sO + (frow + 8 * h) * 4;
          const float2 v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
          const float o = ((v0.x + v1.x) + v2.x) + v3.x, dg = ((v0.y + v1.y) + v2.y) + v3.y;
          const float gs = 1.0f / (1.0f + expf(-(o + ssm[OFF_BGO - OFF_WF0T])));
          dO[h] = sdt * dg * gs * (1.0f - gs);
        }
        cbgo += dO[0] + dO[1];
        float g2[1][2][4], dag2[1][2][4];
        load_frag(g2, sX, frow, fcol);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = fcol + 32 * j + (e & 1);
            const float x = g2[0][j][e], dOr = dO[e >> 1];
            dag2[0][j][e] = dOr * wgo[col] * (1.0f - x * x);
            g2[0][j][e] = x * dOr;            // for dwgo
          }
        store_frag(sX, dag2, frow, fcol);
        cwgo += colsum(g2);
        cbg1 += colsum(dag2);
        dtc::mma_xty2<2, 2, ROWS, UNROLL_W>(Tile{sH2}, Tile{sDF}, gw[WF2], Tile{sH1}, Tile{sDA2},
                                           gw[WF1], gm0, gn0);
        zero(da1);
        dtc::mma_xwt<1, 2, D, UNROLL>(Tile{sDA2}, WTr{wf1}, 16 * mt, 8 * jn, 32, da1);
        scale_by_tanh_derivative(da1, sH1, frow, fcol);
      }
      __syncthreads();

      // E: dA1 replaces dF; dwg1 += hg1^T dAG2; dAG1 = (dAG2 wg1^T)(1 - hg1^2)
      // replaces h2
      {
        store_frag(sDA1, da1, frow, fcol);
        {
          const float x = colsum(da1);
          cbf0 += x;
          cwf0s = fmaf(s, x, cwf0s);
          cwf0c = fmaf(c, x, cwf0c);
        }
        dtc::mma_xty<2, 2, ROWS, UNROLL_W>(Tile{sG1}, Tile{sX}, gm0, gn0, gw[WG1]);
        float dag1[1][2][4];
        zero(dag1);
        dtc::mma_xwt<1, 2, D, UNROLL>(Tile{sX}, WTr{wg1}, 16 * mt, 8 * jn, 32, dag1);
        scale_by_tanh_derivative(dag1, sG1, frow, fcol);
        store_frag(sDAG1, dag1, frow, fcol);
        {
          const float x = colsum(dag1);
          cbg0 += x;
          cwg0s = fmaf(s, x, cwg0s);
          cwg0c = fmaf(c, x, cwg0c);
        }
      }
      __syncthreads();

      // F: dwf0 += y^T dA1; dwg0 += y^T dAG1; lambda += dA1 wf0^T + dAG1 wg0^T
      dtc::mma_xty2<2, 2, ROWS, UNROLL_W>(Tile{sY}, Tile{sDA1}, gw[WF0], Tile{sY}, Tile{sDAG1},
                                         gw[WG0], gm0, gn0);
      dtc::mma_xwt2<1, 2, D, UNROLL>(Tile{sDA1}, WTr{wf0}, lam, Tile{sDAG1}, WTr{wg0}, lam,
                                          16 * mt, 8 * jn, 32);
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + frow + 8 * h;
      if (row < N)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(dy0 + row * D + fcol + 32 * j) =
              make_float2(static_cast<float>(lam[0][j][2 * h]),
                          static_cast<float>(lam[0][j][2 * h + 1]));
    }

    // this tile's weight gradients into the block's f64 sums, in the packed
    // layout; the first tile stores, the others add
    const bool first_tile = tile == static_cast<int>(blockIdx.x);
    auto put = [&](double* d, float v) { *d = first_tile ? v : *d + v; };
#pragma unroll
    for (int m = 0; m < 5; ++m) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dtc::for_fragment(gw[m][i][j], gm0 + 16 * i, gn0 + 8 * j,
                           [&](int r, int col, float v0, float v1) {
                             double* d = part + m * MAT + r * D + col;   // OFF_WF0 ..
                             put(d, v0);
                             put(d + 1, v1);
                           });
      zero(gw[m]);
    }
    // the column sums: the m-tile 1 warps leave theirs in shared memory (the
    // h1 tile is free until the next tile's phase B), the m-tile 0 warps add
    // them to theirs; dbgo over the 8 row lanes by shuffles
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) cbgo += __shfl_xor_sync(0xffffffffu, cbgo, off);
    float q[NQ] = {cbf2, cwgo, cbf1, cbg1, cbf0, cwf0s, cwf0c, cbg0, cwg0s, cwg0c};
    if (mt == 1 && first) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) sH1[i * D + ccol] = q[i];
      if (jn == 0 && lane == 0) sH1[NQ * D] = cbgo;
    }
    __syncthreads();
    if (mt == 0 && first) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) put(part + qoff[i] + ccol, q[i] + sH1[i * D + ccol]);
      if (jn == 0 && lane < 4) put(part + OFF_BGO + lane, lane == 0 ? cbgo + sH1[NQ * D] : 0.0f);
    }
    cbf2 = cwgo = cbf1 = cbg1 = cbf0 = cwf0s = cwf0c = cbg0 = cwg0s = cwg0c = cbgo = 0.0f;
  }
}

// dw[i] = sum over blocks of partial[b][i], in block order
__global__ void reduce_partials(const double* __restrict__ partial, int blocks,
                                float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W_FLOATS) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * W_FLOATS + i];
  dw[i] = static_cast<float>(s);
}

template <int MODE>
cudaError_t launch(const float* y0, const float* ys, const float* ct, const float* w,
                   const float* tsc, const float* noise, float* dy0, float* dw, double* partial,
                   int N, int T, uint32_t k1, uint32_t k2, const uint32_t* keys, int grid,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rollout_bwd_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  rollout_bwd_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(y0, ys, ct, w, tsc, noise, dy0,
                                                                  partial, N, T, k1, k2, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<(W_FLOATS + 255) / 256, 256, 0, stream>>>(partial, grid, dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sde_rollout_bwd_weight_floats() { return W_FLOATS; }

// dy0 [N, 64] and dw [W_FLOATS] (packed as in rollout_common.cuh) from
// y0 [N, 64], the forward's ys [T, N, 64], the cotangent ct [T, N, 64], w, tsc [T, 4] and, in
// mode 0, noise [T, N, 64].  partial is a [grid, W_FLOATS] f64 workspace;
// grid blocks walk the 32-row tiles.  keys: NULL or a device uint32[2] holding
// k1, k2, as in sde_rollout_launch.  Returns cudaGetLastError().
int sde_rollout_bwd_launch(const float* y0, const float* ys, const float* ct, const float* w,
                           const float* tsc, const float* noise, float* dy0, float* dw,
                           double* partial, int N, int T, unsigned int k1, unsigned int k2,
                           int mode, int grid, void* stream, const unsigned int* keys) {
  if (N <= 0 || T <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case EXPLICIT:
      if (noise == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(
          launch<EXPLICIT>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, keys,
                           grid, s));
    case RADEMACHER:
      return static_cast<int>(
          launch<RADEMACHER>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, keys,
                             grid, s));
    case GAUSSIAN:
      return static_cast<int>(
          launch<GAUSSIAN>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, keys,
                           grid, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
