// Forward Euler-Maruyama rollout of the decoder's latent SDE (kernel K1).
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/sde_rollout.py::sde_rollout
// (pallas_call body _rollout_kernel, step _euler_step).  Per step and row:
//   drift      f = tanh(tanh(y.wf0 + sin(t) wf0t[0] + cos(t) wf0t[1] + bf0).wf1 + bf1).wf2 + bf2
//   diffusion  g = sigmoid(tanh(tanh(y.wg0 + ... + bg0).wg1 + bg1).wgo + bgo)   (one scalar per row)
//   update     y <- y + f dt + g sqrt(dt) z,   ys[t] = y
// with z explicit, or drawn here from a counter-based hash keyed by
// (seed, global row, step, word) -- independent of the tiling.
//
// Bound on an H100 SXM at the bucket-128 serving shape (N = 61,440 rows,
// T = 60, D = 64): 5 matmuls of 2*64*64 plus 2*64 per row-step is 1.5e11
// f32 operations, 2.3 ms at the 67 TFLOP/s CUDA-core peak; writing ys is
// 0.94 GB, 0.28 ms at 3.35 TB/s.  The kernel is bound by arithmetic, so
// it keeps every operand on chip: one block owns a tile of 64 rows for all
// T steps (the loop replaces the TPU's sequential step grid axis), stages
// all 14 weights (84 KB) in shared memory once, keeps the state tile and
// the hidden activations in shared memory, and touches device memory only
// to read y0 (and explicit noise) and to write each ys[t] row coalesced.
// Each of the 256 threads computes a 4-row x 4-column register tile of
// every 64x64 product from float4 shared-memory loads; the diffusion's
// 64->1 output is a shuffle reduction across the 16 threads of a row group.
// The ragged last tile is bounds-checked instead of padded.

#include "rollout_common.cuh"

namespace {

using namespace rollout;

constexpr int ROWS = 64;       // rows per block
constexpr int THREADS = 256;   // 16 row groups x 16 column groups, 4x4 each

// acc[i][j] += sum_k in[r0 + i][k] * W[k][c0 + j]; in and W in shared memory
__device__ __forceinline__ void mm4x4(const float* __restrict__ in, const float* __restrict__ W,
                                      int r0, int c0, float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(in + (r0 + i) * D + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * D + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], w.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ void store4(float* dst, const float v[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
rollout_kernel(const float* __restrict__ y0, const float* __restrict__ w,
               const float* __restrict__ tsc, const float* __restrict__ noise,
               float* __restrict__ ys, int N, int T, uint32_t k1, uint32_t k2) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                 // weights
  float* sy = sw + W_FLOATS;        // state tile [ROWS][D]
  float* sa = sy + ROWS * D;        // drift hidden [ROWS][D]
  float* sb = sa + ROWS * D;        // diffusion hidden [ROWS][D]
  float* st = sb + ROWS * D;        // per step: sin t, cos t, dt, sqrt dt

  const int tid = threadIdx.x;
  const int c0 = (tid & 15) * 4;
  const int r0 = (tid >> 4) * 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS + r0;

  for (int i = tid; i < W_FLOATS / 4; i += THREADS)
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(w)[i];
  for (int i = tid; i < 4 * T; i += THREADS) st[i] = tsc[i];

  float y[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + i < N) v = *reinterpret_cast<const float4*>(y0 + (row0 + i) * D + c0);
    y[i][0] = v.x; y[i][1] = v.y; y[i][2] = v.z; y[i][3] = v.w;
    store4(sy + (r0 + i) * D + c0, y[i]);
  }
  __syncthreads();

  float af[4][4], ag[4][4];
  for (int t = 0; t < T; ++t) {
    const float s = st[4 * t], c = st[4 * t + 1], dt = st[4 * t + 2], sdt = st[4 * t + 3];

    // layer 0 of both nets reads the state, with the time features as bias
    zero(af);
    zero(ag);
    mm4x4(sy, sw + OFF_WF0, r0, c0, af);
    mm4x4(sy, sw + OFF_WG0, r0, c0, ag);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + j;
      const float bf = s * sw[OFF_WF0T + col] + c * sw[OFF_WF0T + D + col] + sw[OFF_BF0 + col];
      const float bg = s * sw[OFF_WG0T + col] + c * sw[OFF_WG0T + D + col] + sw[OFF_BG0 + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[i][j] = tanhf(af[i][j] + bf);
        ag[i][j] = tanhf(ag[i][j] + bg);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      store4(sa + (r0 + i) * D + c0, af[i]);
      store4(sb + (r0 + i) * D + c0, ag[i]);
    }
    __syncthreads();

    // layer 1 of both nets
    zero(af);
    zero(ag);
    mm4x4(sa, sw + OFF_WF1, r0, c0, af);
    mm4x4(sb, sw + OFF_WG1, r0, c0, ag);
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        af[i][j] = tanhf(af[i][j] + sw[OFF_BF1 + c0 + j]);
        g[i] = fmaf(tanhf(ag[i][j] + sw[OFF_BG1 + c0 + j]), sw[OFF_WGO + c0 + j], g[i]);
      }
    }
    // diffusion output: reduce the 64-wide dot product over the 16 column
    // groups of this row group (lanes differing in their low 4 bits)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) g[i] += __shfl_xor_sync(0xffffffffu, g[i], off);
      g[i] = 1.0f / (1.0f + expf(-(g[i] + sw[OFF_BGO])));
    }
    __syncthreads();  // every thread has finished reading sa / sb
#pragma unroll
    for (int i = 0; i < 4; ++i) store4(sa + (r0 + i) * D + c0, af[i]);
    __syncthreads();

    // drift output, noise, update
    zero(af);
    mm4x4(sa, sw + OFF_WF2, r0, c0, af);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + i;
      const bool live = row < N;
      float z[4];
      if (MODE == EXPLICIT) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live) v = *reinterpret_cast<const float4*>(noise + (static_cast<long long>(t) * N + row) * D + c0);
        z[0] = v.x; z[1] = v.y; z[2] = v.z; z[3] = v.w;
      } else if (MODE == RADEMACHER) {
        // one bit per lane: word c0 / 32 holds lanes c0 .. c0 + 3
        const uint64_t base = (static_cast<uint64_t>(row) * T + t) * (D / 32);
        const uint32_t bits = draw_bits(k1, k2, base + (c0 >> 5));
#pragma unroll
        for (int j = 0; j < 4; ++j) z[j] = ((bits >> ((c0 + j) & 31)) & 1u) ? 1.0f : -1.0f;
      } else {
        // pair-output Box-Muller (rollout_common.cuh)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float zc, zs;
          gaussian_pair(k1, k2, static_cast<uint64_t>(row), t, T, (c0 + j) % (D / 2), &zc, &zs);
          z[j] = (c0 + j < D / 2) ? zc : zs;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = af[i][j] + sw[OFF_BF2 + c0 + j];
        y[i][j] = y[i][j] + f * dt + g[i] * (sdt * z[j]);
      }
      if (live) store4(ys + (static_cast<long long>(t) * N + row) * D + c0, y[i]);
      store4(sy + (r0 + i) * D + c0, y[i]);
    }
    __syncthreads();
  }
}

template <int MODE>
cudaError_t launch(const float* y0, const float* w, const float* tsc, const float* noise,
                   float* ys, int N, int T, uint32_t k1, uint32_t k2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (W_FLOATS + 3 * ROWS * D + 4 * static_cast<size_t>(T));
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ROWS - 1) / ROWS);
  rollout_kernel<MODE><<<grid, THREADS, smem, stream>>>(y0, w, tsc, noise, ys, N, T, k1, k2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats the packed weight buffer must hold (the wrapper checks its layout)
int sde_rollout_weight_floats() { return W_FLOATS; }

// ys [T, N, 64] from y0 [N, 64]; w packed as in rollout_common.cuh; tsc [T, 4];
// noise [T, N, 64] for mode 0, else NULL.  Returns cudaGetLastError().
int sde_rollout_launch(const float* y0, const float* w, const float* tsc, const float* noise,
                       float* ys, int N, int T, unsigned int k1, unsigned int k2, int mode,
                       void* stream) {
  if (N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case EXPLICIT:
      if (noise == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<EXPLICIT>(y0, w, tsc, noise, ys, N, T, k1, k2, s));
    case RADEMACHER:
      return static_cast<int>(launch<RADEMACHER>(y0, w, tsc, noise, ys, N, T, k1, k2, s));
    case GAUSSIAN:
      return static_cast<int>(launch<GAUSSIAN>(y0, w, tsc, noise, ys, N, T, k1, k2, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
