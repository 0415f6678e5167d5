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
// products plus three 64-wide dot products, 28 D^2 + 6 D = 115,072 flop:
// 4.24e11 f32 flop, 6.3 ms at the 67 TFLOP/s CUDA-core peak; reading ys
// and ct is 1.9 GB, 0.56 ms at 3.35 TB/s.  K2 is bound by arithmetic.
//
// Design.  A persistent grid (one 256-thread block per SM) walks 64-row
// tiles; each tile runs all T steps backwards inside the block (the loop
// replaces the TPU's reversed step grid axis).  The 14 weights are staged in
// shared memory once per block, the five matrices with a padded row stride
// of 68 floats so that the transposed products (dX W^T) read rows of W as
// conflict-free float4s.  Seven padded activation tiles (y, dF|dA2, h1,
// hg1, h2|dA1, hg2|dAG2, dAG1) and the per-row dO live in shared memory:
// 211,728 bytes, one block per SM.
//   * Each thread owns rows r0..r0+3 and the strided columns cg + 16 j of
//     every activation (so one thread holds both lanes of its two
//     Box-Muller pairs), and holds lambda there in registers.
//   * The five 64x64 weight gradients are block-private and live in
//     registers: each thread keeps a 4x4 tile (rows k0..k0+3, columns
//     c0..c0+3) of each, 80 floats, accumulated over every row of every tile
//     the block walks.  The bias, time-feature and wgo gradients are column
//     sums over the tile, taken by one 64-thread group each.
//   * No float atomics.  Each block writes its partial gradients once to a
//     [grid, W_FLOATS] workspace, and reduce_partials sums them in block
//     order, so the gradients are the same run after run.
// The ragged last tile is bounds-checked: rows past N carry zero lambda and
// contribute nothing, so no padding copy exists.
// Shared memory is the tight spot (weights 89,616 B + tiles 121,856 B), so
// the block-private weight gradients live in registers rather than in a
// second 80 KB of shared memory: ptxas (sm_90a) gives the three
// instantiations 220 (explicit), 218 (Rademacher) and 222 (gaussian)
// registers with no spills; one 8-warp block per SM.

#include "rollout_common.cuh"

namespace {

using namespace rollout;

constexpr int ROWS = 64;
constexpr int THREADS = 256;
constexpr int LD = D + 4;                       // padded row stride (floats)
constexpr int TILE = ROWS * LD;
constexpr int SMAT = D * LD;
constexpr int NSMALL = W_FLOATS - OFF_WF0T;     // wf0t .. bgo, kept unpadded
constexpr int S_WF0 = 0, S_WF1 = SMAT, S_WF2 = 2 * SMAT, S_WG0 = 3 * SMAT, S_WG1 = 4 * SMAT;
constexpr int S_SMALL = 5 * SMAT;
constexpr int SW_FLOATS = S_SMALL + NSMALL;
constexpr int SMEM_FLOATS = SW_FLOATS + 7 * TILE + ROWS;
static_assert(NSMALL % 4 == 0 && SW_FLOATS % 4 == 0 && TILE % 4 == 0, "float4 alignment");

// shared-memory index of a small parameter at packed offset `off`
__device__ __forceinline__ int small(int off) { return S_SMALL + off - OFF_WF0T; }

// acc[i][j] += sum_k in[r0 + i][k] * W[k][cg + 16 j]
__device__ __forceinline__ void mm_fwd(const float* __restrict__ in, const float* __restrict__ W,
                                       int r0, int cg, float acc[4][4]) {
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(in + (r0 + i) * LD + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = W + (k + kk) * LD + cg;
      const float w0 = wr[0], w1 = wr[16], w2 = wr[32], w3 = wr[48];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i][kk], w0, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], w1, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], w2, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], w3, acc[i][3]);
      }
    }
  }
}

// acc[i][m] += sum_j in[r0 + i][j] * W[cg + 16 m][j]   (in times W transposed)
__device__ __forceinline__ void mm_tr(const float* __restrict__ in, const float* __restrict__ W,
                                      int r0, int cg, float acc[4][4]) {
#pragma unroll 2
  for (int j = 0; j < D; j += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * LD + j);
#pragma unroll
    for (int m = 0; m < 4; ++m) b[m] = *reinterpret_cast<const float4*>(W + (cg + 16 * m) * LD + j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float s = acc[i][m];
        s = fmaf(a[i].x, b[m].x, s);
        s = fmaf(a[i].y, b[m].y, s);
        s = fmaf(a[i].z, b[m].z, s);
        acc[i][m] = fmaf(a[i].w, b[m].w, s);
      }
  }
}

// acc[a][b] += sum_r in[r][k0 + a] * dl[r][c0 + b]   (in transposed times dl)
__device__ __forceinline__ void mm_wgrad(const float* __restrict__ in, const float* __restrict__ dl,
                                         int k0, int c0, float acc[4][4]) {
#pragma unroll 4
  for (int r = 0; r < ROWS; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(in + r * LD + k0);
    const float4 b = *reinterpret_cast<const float4*>(dl + r * LD + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

__device__ __forceinline__ float colsum(const float* __restrict__ tile, int col) {
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < ROWS; ++r) s += tile[r * LD + col];
  return s;
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// a 4x4 weight-gradient tile into the packed [in][out] matrix at `dst`
__device__ __forceinline__ void store_grad(float* dst, const float acc[4][4], int k0, int c0) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(dst + (k0 + a) * D + c0) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
rollout_bwd_kernel(const float* __restrict__ y0, const float* __restrict__ ys,
                   const float* __restrict__ ct, const float* __restrict__ w,
                   const float* __restrict__ tsc, const float* __restrict__ noise,
                   float* __restrict__ dy0, float* __restrict__ partial,
                   int N, int T, uint32_t k1, uint32_t k2) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                 // weights (padded matrices, then the small ones)
  float* sY = sw + SW_FLOATS;       // pre-step state y_t
  float* sDF = sY + TILE;           // lambda dt, then dA2
  float* sH1 = sDF + TILE;          // drift hidden 1
  float* sG1 = sH1 + TILE;          // diffusion hidden 1
  float* sH2 = sG1 + TILE;          // drift hidden 2, then dA1
  float* sG2 = sH2 + TILE;          // diffusion hidden 2, then dAG2
  float* sX = sG2 + TILE;           // dAG1
  float* sDO = sX + TILE;           // dL/d(diffusion logit) per row

  const int tid = threadIdx.x;
  const int cg = tid & 15, r0 = (tid >> 4) * 4;   // activations: rows r0.., columns cg + 16 j
  const int c0 = cg * 4, k0 = (tid >> 4) * 4;     // weight grads: rows k0.., columns c0..
  const int role = tid >> 6, rc = tid & 63;       // column sums: group, column

  for (int i = tid; i < 5 * MAT / 4; i += THREADS) {
    const int e = 4 * i, m = e / MAT, r = (e % MAT) / D, c = e % D;
    *reinterpret_cast<float4*>(sw + m * SMAT + r * LD + c) = reinterpret_cast<const float4*>(w)[i];
  }
  for (int i = tid; i < NSMALL / 4; i += THREADS)
    reinterpret_cast<float4*>(sw + S_SMALL)[i] = reinterpret_cast<const float4*>(w + OFF_WF0T)[i];

  float dwf0[4][4], dwf1[4][4], dwf2[4][4], dwg0[4][4], dwg1[4][4];
  zero(dwf0); zero(dwf1); zero(dwf2); zero(dwg0); zero(dwg1);
  float sm0 = 0.0f, sm1 = 0.0f, sm2 = 0.0f;       // this thread's column sums (see the end)

  const int ntiles = (N + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * ROWS + r0;
    float lam[4][4];
    zero(lam);
    for (int t = T - 1; t >= 0; --t) {
      const float s = tsc[4 * t], c = tsc[4 * t + 1], dt = tsc[4 * t + 2], sdt = tsc[4 * t + 3];
      const float* prev = (t == 0) ? y0 : ys + static_cast<long long>(t - 1) * N * D;

      // A: pre-step state; inject ct[t]; dF = lambda dt
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = row0 + i;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row < N) v = *reinterpret_cast<const float4*>(prev + row * D + c0);
        *reinterpret_cast<float4*>(sY + (r0 + i) * LD + c0) = v;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j;
          if (row < N) lam[i][j] += ct[(static_cast<long long>(t) * N + row) * D + col];
          sDF[(r0 + i) * LD + col] = lam[i][j] * dt;
        }
      }
      __syncthreads();

      // B: first hidden layers, time features as bias
      {
        float af[4][4], ag[4][4];
        zero(af);
        zero(ag);
        mm_fwd(sY, sw + S_WF0, r0, cg, af);
        mm_fwd(sY, sw + S_WG0, r0, cg, ag);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j;
          const float bf = s * sw[small(OFF_WF0T) + col] + c * sw[small(OFF_WF0T) + D + col] +
                           sw[small(OFF_BF0) + col];
          const float bg = s * sw[small(OFF_WG0T) + col] + c * sw[small(OFF_WG0T) + D + col] +
                           sw[small(OFF_BG0) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sH1[(r0 + i) * LD + col] = tanhf(af[i][j] + bf);
            sG1[(r0 + i) * LD + col] = tanhf(ag[i][j] + bg);
          }
        }
      }
      __syncthreads();

      // C: second hidden layers, diffusion g, increments, dO
      float dO[4];
      {
        float af[4][4], ag[4][4];
        zero(af);
        zero(ag);
        mm_fwd(sH1, sw + S_WF1, r0, cg, af);
        mm_fwd(sG1, sw + S_WG1, r0, cg, ag);
        float o[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float h2 = tanhf(af[i][j] + sw[small(OFF_BF1) + col]);
            const float g2 = tanhf(ag[i][j] + sw[small(OFF_BG1) + col]);
            sH2[(r0 + i) * LD + col] = h2;
            sG2[(r0 + i) * LD + col] = g2;
            o[i] = fmaf(g2, sw[small(OFF_WGO) + col], o[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long row = row0 + i;
          float z[4];
          if (MODE == EXPLICIT) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              z[j] = (row < N) ? noise[(static_cast<long long>(t) * N + row) * D + cg + 16 * j] : 0.0f;
          } else if (MODE == RADEMACHER) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              z[j] = rademacher(k1, k2, static_cast<uint64_t>(row), t, T, cg + 16 * j);
          } else {
            // this thread's columns cg, cg + 32 and cg + 16, cg + 48 are both
            // lanes of the Box-Muller pairs cg and cg + 16
            gaussian_pair(k1, k2, static_cast<uint64_t>(row), t, T, cg, &z[0], &z[2]);
            gaussian_pair(k1, k2, static_cast<uint64_t>(row), t, T, cg + 16, &z[1], &z[3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) dg[i] = fmaf(lam[i][j], z[j], dg[i]);
        }
        // reduce over the 16 column groups of this row group
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
            dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], off);
          }
          const float g = 1.0f / (1.0f + expf(-(o[i] + sw[small(OFF_BGO)])));
          dO[i] = sdt * dg[i] * g * (1.0f - g);
          if (cg == 0) sDO[r0 + i] = dO[i];
        }
      }
      __syncthreads();

      // D: dwf2 += h2^T dF; dA2 = (dF wf2^T)(1 - h2^2); dbf2, dwgo, dbgo
      float da2[4][4];
      zero(da2);
      mm_wgrad(sH2, sDF, k0, c0, dwf2);
      mm_tr(sDF, sw + S_WF2, r0, cg, da2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float h = sH2[(r0 + i) * LD + cg + 16 * j];
          da2[i][j] *= 1.0f - h * h;
        }
      if (role == 0) {
        float sb = 0.0f, sg = 0.0f;
#pragma unroll 8
        for (int r = 0; r < ROWS; ++r) {
          sb += sDF[r * LD + rc];
          sg = fmaf(sG2[r * LD + rc], sDO[r], sg);
        }
        sm0 += sb;
        sm1 += sg;
        if (rc == 0) {
          float so = 0.0f;
          for (int r = 0; r < ROWS; ++r) so += sDO[r];
          sm2 += so;
        }
      }
      __syncthreads();
      // dA2 replaces dF; dAG2 = dO wgo (1 - hg2^2) replaces hg2 in place
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j, at = (r0 + i) * LD + col;
          sDF[at] = da2[i][j];
          const float g2 = sG2[at];
          sG2[at] = dO[i] * sw[small(OFF_WGO) + col] * (1.0f - g2 * g2);
        }
      __syncthreads();

      // E: dwf1 += h1^T dA2; dwg1 += hg1^T dAG2; dA1 -> sH2; dAG1 -> sX; dbf1, dbg1
      mm_wgrad(sH1, sDF, k0, c0, dwf1);
      mm_wgrad(sG1, sG2, k0, c0, dwg1);
      {
        float acc[4][4];
        zero(acc);
        mm_tr(sDF, sw + S_WF1, r0, cg, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = (r0 + i) * LD + cg + 16 * j;
            const float h = sH1[at];
            sH2[at] = acc[i][j] * (1.0f - h * h);
          }
        zero(acc);
        mm_tr(sG2, sw + S_WG1, r0, cg, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = (r0 + i) * LD + cg + 16 * j;
            const float h = sG1[at];
            sX[at] = acc[i][j] * (1.0f - h * h);
          }
      }
      if (role == 1) {
        sm0 += colsum(sDF, rc);
        sm1 += colsum(sG2, rc);
      }
      __syncthreads();

      // F: dwf0 += y^T dA1; dwg0 += y^T dAG1; lambda += dA1 wf0^T + dAG1 wg0^T;
      // dbf0, dwf0t (role 2) and dbg0, dwg0t (role 3)
      mm_wgrad(sY, sH2, k0, c0, dwf0);
      mm_wgrad(sY, sX, k0, c0, dwg0);
      mm_tr(sH2, sw + S_WF0, r0, cg, lam);
      mm_tr(sX, sw + S_WG0, r0, cg, lam);
      if (role >= 2) {
        const float cs = colsum(role == 2 ? sH2 : sX, rc);
        sm0 += cs;
        sm1 = fmaf(s, cs, sm1);
        sm2 = fmaf(c, cs, sm2);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + i;
      if (row < N)
#pragma unroll
        for (int j = 0; j < 4; ++j) dy0[row * D + cg + 16 * j] = lam[i][j];
    }
  }

  // this block's partial gradients, in the packed layout
  float* part = partial + static_cast<size_t>(blockIdx.x) * W_FLOATS;
  store_grad(part + OFF_WF0, dwf0, k0, c0);
  store_grad(part + OFF_WF1, dwf1, k0, c0);
  store_grad(part + OFF_WF2, dwf2, k0, c0);
  store_grad(part + OFF_WG0, dwg0, k0, c0);
  store_grad(part + OFF_WG1, dwg1, k0, c0);
  if (role == 0) {
    part[OFF_BF2 + rc] = sm0;
    part[OFF_WGO + rc] = sm1;
    if (rc < 4) part[OFF_BGO + rc] = sm2;   // dbgo at rc 0; the 3 padding floats get 0
  } else if (role == 1) {
    part[OFF_BF1 + rc] = sm0;
    part[OFF_BG1 + rc] = sm1;
  } else {
    const int bias = role == 2 ? OFF_BF0 : OFF_BG0, wt = role == 2 ? OFF_WF0T : OFF_WG0T;
    part[bias + rc] = sm0;
    part[wt + rc] = sm1;
    part[wt + D + rc] = sm2;
  }
}

// dw[i] = sum over blocks of partial[b][i], in block order
__global__ void reduce_partials(const float* __restrict__ partial, int blocks,
                                float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W_FLOATS) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * W_FLOATS + i];
  dw[i] = s;
}

template <int MODE>
cudaError_t launch(const float* y0, const float* ys, const float* ct, const float* w,
                   const float* tsc, const float* noise, float* dy0, float* dw, float* partial,
                   int N, int T, uint32_t k1, uint32_t k2, int grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(rollout_bwd_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rollout_bwd_kernel<MODE><<<grid, THREADS, smem, stream>>>(y0, ys, ct, w, tsc, noise, dy0,
                                                            partial, N, T, k1, k2);
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
// mode 0, noise [T, N, 64].  partial is a [grid, W_FLOATS] workspace; grid
// blocks walk the 64-row tiles.  Returns cudaGetLastError().
int sde_rollout_bwd_launch(const float* y0, const float* ys, const float* ct, const float* w,
                           const float* tsc, const float* noise, float* dy0, float* dw,
                           float* partial, int N, int T, unsigned int k1, unsigned int k2,
                           int mode, int grid, void* stream) {
  if (N <= 0 || T <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case EXPLICIT:
      if (noise == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(
          launch<EXPLICIT>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, grid, s));
    case RADEMACHER:
      return static_cast<int>(
          launch<RADEMACHER>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, grid, s));
    case GAUSSIAN:
      return static_cast<int>(
          launch<GAUSSIAN>(y0, ys, ct, w, tsc, noise, dy0, dw, partial, N, T, k1, k2, grid, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
