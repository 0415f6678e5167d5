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
// T = 60, D = 64): 5 products of 2*64*64 plus 2*64 per row-step is 1.5e11
// operations, 2.3 ms at the 67 TFLOP/s f32 CUDA-core peak; writing ys is
// 0.94 GB, 0.28 ms at 3.35 TB/s.  The five products (1.51e11) run on the
// tensor cores at f32 accuracy (3xTF32, mma_tf32.cuh): three TF32 products
// each, 0.92 ms at 495 / 3 TFLOP/s, and on this route K1 is bound by them.
//
// Design (the layout of K2's recompute, sde_rollout_bwd.cu).  A persistent
// grid of at most one 256-thread block per SM walks 32-row tiles; each tile
// runs all T steps inside the block (the loop replaces the TPU's sequential
// step grid axis): 15 tiles at bucket 1 (480 rows), 1,920 at bucket 128.
//   * The five 64 x 64 weights are the same for every row, step and tile,
//     so they are split into TF32 (big, small) pairs once, when the block
//     stages them: 5 x 64 x 64 uint2 = 163,840 B of shared memory.  A pair
//     (r, c) lies at r * 64 + (c ^ 4 (r mod 4)) (8-byte slots), so the B
//     fragments (W[k = t][n = g]) are read without bank conflicts.
//   * Four 32-row f32 activation tiles (32,768 B), XOR-swizzled by 16-byte
//     granule (tile_at), so that the A fragments (X[g][t]) and the float2
//     stores of C fragments are conflict-free: y, h1, hg1, h2.  With the
//     small weights (2,576 B) and the diffusion logit's exchange (512 B):
//     199,696 B, one block per SM.
//   * Each of the 8 warps owns one 16-row m-tile and the n-tiles j and
//     j + 4 (columns 8 j .. and 8 j + 32 ..) of every product, so a thread
//     holds both lanes (p, p + 32) of each Box-Muller pair it draws: each
//     pair is drawn once, by gaussian_pair.  The state y stays in
//     registers as C fragments for all T steps; it is written to the y tile
//     as the next step's A operand, and ys[t] is stored from that tile in
//     whole rows (float4s, coalesced).
//   * Every product is a warp-level mma.sync m16n8k8 in 3xTF32: per two
//     k-steps the small terms go into one fresh fragment and big * big into
//     another, and both are added to f32 accumulators on the CUDA cores
//     (mma3x2_apart, as K2 sums; tests/test_torch_sde_rollout_fwd_tf32.py
//     models this sum against f64).  The two layer-0 products share their
//     A operand (y) and run in one loop, as do the two layer-1 products
//     (mma_xwt_split2), so their fragments interleave.
//   * The bias and time-feature terms, the tanhf's, the diffusion output
//     hg2.wgo and the update stay on the CUDA cores in f32.  The logit is
//     a row sum: shuffles over the 4 lanes of a row, then the 4 warps of an
//     m-tile through shared memory, in a fixed order.
//   * Explicit increments are loaded into registers at the start of a
//     step, so their latency hides behind the step's products.
//   * Three barriers a step: h1 and hg1 (after layer 0); h2 and the
//     logit's partial sums (after layer 1); the new y (after the update).
// The ragged last tile is bounds-checked: rows past N start from zero and
// write nothing, so no padding copy exists.
// ptxas (sm_90a) gives the three instantiations 149-157 registers and no
// spills.  On an H100 at bucket 128 K1 takes 5.0-5.2 ms with Rademacher
// increments against the FMA build's 5.4-5.7, of which the products are
// about 4.0 ms: the tensor cores issue well under one m16n8k8 a clock per
// SM here, and the fragments read 480 KB of shared memory per tile-step.
// Two tiles a block (16 warps) spilled at 128 registers and was slower at
// bucket 1 (scripts/compare_rollout_fwd_builds_torch.py).

#include "mma_tf32.cuh"
#include "rollout_common.cuh"

namespace {

using namespace rollout;

constexpr int ROWS = 32;                        // rows per tile
constexpr int THREADS = 256;                    // 8 warps: 2 m-tiles x 4 n-tile pairs
constexpr int TILE = ROWS * D;                  // floats
constexpr int NSMALL = W_FLOATS - OFF_WF0T;     // wf0t .. bgo, kept in f32
constexpr int NTILES = 4;
constexpr int SMEM_BYTES = 5 * MAT * 8 + 4 * (NSMALL + NTILES * TILE + ROWS * 4);
constexpr int UNROLL = 2;                       // k-loop unrolling of the products
enum { WF0, WF1, WF2, WG0, WG1 };               // matrix m at m * MAT in the packed layout
static_assert(OFF_WF1 == MAT && OFF_WG1 == WG1 * MAT, "packed matrices");
static_assert(NSMALL % 4 == 0 && SMEM_BYTES <= 232448, "shared memory");

// slot of a split weight pair (r, c) in its 64 x 64 matrix
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
  const uint2* p;
  __device__ __forceinline__ uint2 operator()(int n, int k) const { return p[w_at(k, n)]; }
};

__device__ __forceinline__ void zero(float (&x)[1][2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[0][j][e] = 0.0f;
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

// rows row0 .. of a [N, D] array at a thread's C-fragment places into v
// (zeros past N)
__device__ __forceinline__ void load_rows(float (&v)[1][2][4], const float* __restrict__ src,
                                          long long row0, int N, int frow, int fcol) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + frow + 8 * h;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 x = row < N
                           ? __ldg(reinterpret_cast<const float2*>(src + row * D + fcol + 32 * j))
                           : make_float2(0.0f, 0.0f);
      v[0][j][2 * h] = x.x;
      v[0][j][2 * h + 1] = x.y;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
rollout_kernel(const float* __restrict__ y0, const float* __restrict__ w,
               const float* __restrict__ tsc, const float* __restrict__ noise,
               float* __restrict__ ys, int N, int T, uint32_t k1, uint32_t k2,
               const uint32_t* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  load_keys(keys, k1, k2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int mt = warp >> 2, jn = warp & 3;        // m-tile, n-tiles jn and jn + 4
  const int frow = 16 * mt + g, fcol = 8 * jn + 2 * t4;   // this thread's C-fragment places

  uint2* sw = reinterpret_cast<uint2*>(smem_raw);                  // split weights
  float* ssm = reinterpret_cast<float*>(smem_raw + 5 * MAT * 8);  // wf0t .. bgo
  float* sY = ssm + NSMALL;         // state y
  float* sH1 = sY + TILE;           // drift hidden 1
  float* sG1 = sH1 + TILE;          // diffusion hidden 1
  float* sH2 = sG1 + TILE;          // drift hidden 2
  float* sO = sH2 + TILE;           // [row][n-tile pair] partial diffusion logits
  const float* wf0t = ssm;
  const float* wg0t = ssm + (OFF_WG0T - OFF_WF0T);
  const float* bf0 = ssm + (OFF_BF0 - OFF_WF0T);
  const float* bf1 = ssm + (OFF_BF1 - OFF_WF0T);
  const float* bf2 = ssm + (OFF_BF2 - OFF_WF0T);
  const float* bg0 = ssm + (OFF_BG0 - OFF_WF0T);
  const float* bg1 = ssm + (OFF_BG1 - OFF_WF0T);
  const float* wgo = ssm + (OFF_WGO - OFF_WF0T);

  for (int i = tid; i < 5 * MAT; i += THREADS) {
    const int m = i / MAT, r = (i % MAT) / D, c = i % D;
    uint32_t big, small;
    tc::split(w[i], big, small);
    sw[m * MAT + w_at(r, c)] = make_uint2(big, small);
  }
  for (int i = tid; i < NSMALL / 4; i += THREADS)
    reinterpret_cast<float4*>(ssm)[i] = reinterpret_cast<const float4*>(w + OFF_WF0T)[i];
  const uint2 *wf0 = sw + WF0 * MAT, *wf1 = sw + WF1 * MAT, *wf2 = sw + WF2 * MAT,
              *wg0 = sw + WG0 * MAT, *wg1 = sw + WG1 * MAT;
  const float bgo = __ldg(w + OFF_BGO);

  const int ntiles = (N + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * ROWS;
    float y[1][2][4];
    load_rows(y, y0, row0, N, frow, fcol);
    __syncthreads();   // the weights are staged; the last tile's ys rows are read out of sY
    store_frag(sY, y, frow, fcol);
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const float s = __ldg(tsc + 4 * t), c = __ldg(tsc + 4 * t + 1);
      const float dt = __ldg(tsc + 4 * t + 2), sdt = __ldg(tsc + 4 * t + 3);
      // explicit increments now, so that their latency hides behind the products
      float z[1][2][4];
      if (MODE == EXPLICIT) load_rows(z, noise + static_cast<long long>(t) * N * D, row0, N, frow,
                                      fcol);

      // layer 0 of both nets reads the state, with the time features as bias
      {
        float a[1][2][4], b[1][2][4];
        zero(a);
        zero(b);
        tc::mma_xwt_split2<1, 2, D, UNROLL>(Tile{sY}, WFwd{wf0}, a, Tile{sY}, WFwd{wg0}, b,
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

      // layer 1 of both nets; the diffusion logit's partial row sums
      {
        float a[1][2][4], b[1][2][4];
        zero(a);
        zero(b);
        tc::mma_xwt_split2<1, 2, D, UNROLL>(Tile{sH1}, WFwd{wf1}, a, Tile{sG1}, WFwd{wg1}, b,
                                            16 * mt, 8 * jn, 32);
        float o[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = fcol + 32 * j + (e & 1);
            a[0][j][e] = tanhf(a[0][j][e] + bf1[col]);
            o[e >> 1] = fmaf(tanhf(b[0][j][e] + bg1[col]), wgo[col], o[e >> 1]);
          }
        store_frag(sH2, a, frow, fcol);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) o[h] += __shfl_xor_sync(0xffffffffu, o[h], off);
          if (t4 == 0) sO[(frow + 8 * h) * 4 + jn] = o[h];
        }
      }
      __syncthreads();

      // drift output, increments, update
      {
        float f[1][2][4];
        zero(f);
        tc::mma_xwt_split<1, 2, D, UNROLL>(Tile{sH2}, WFwd{wf2}, 16 * mt, 8 * jn, 32, f);
        float gs[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* v = sO + (frow + 8 * h) * 4;
          const float o = ((v[0] + v[1]) + v[2]) + v[3];
          gs[h] = 1.0f / (1.0f + expf(-(o + bgo)));
          const uint64_t row = static_cast<uint64_t>(row0 + frow + 8 * h);
          if (MODE == RADEMACHER) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int k = 0; k < 2; ++k)
                z[0][j][2 * h + k] = rademacher(k1, k2, row, t, T, fcol + 32 * j + k);
          } else if (MODE == GAUSSIAN) {
            // columns p and p + 32 are the two lanes of Box-Muller pair p
#pragma unroll
            for (int k = 0; k < 2; ++k)
              gaussian_pair(k1, k2, row, t, T, fcol + k, &z[0][0][2 * h + k], &z[0][1][2 * h + k]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float fv = f[0][j][e] + bf2[fcol + 32 * j + (e & 1)];
            y[0][j][e] = y[0][j][e] + fv * dt + gs[e >> 1] * (sdt * z[0][j][e]);
          }
        store_frag(sY, y, frow, fcol);
      }
      __syncthreads();

      // ys[t] from the y tile in whole rows
      float* out = ys + static_cast<long long>(t) * N * D;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = tid + THREADS * q, r = f >> 4, col = 4 * (f & 15);
        if (row0 + r < N)
          *reinterpret_cast<float4*>(out + (row0 + r) * D + col) =
              *reinterpret_cast<const float4*>(sY + tile_at(r, col));
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const float* y0, const float* w, const float* tsc, const float* noise,
                   float* ys, int N, int T, uint32_t k1, uint32_t k2, const uint32_t* keys,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // at most one block per SM; each walks the row tiles blockIdx.x, + grid, ..
  const int tiles = (N + ROWS - 1) / ROWS;
  const int grid = tiles < sms ? tiles : sms;
  rollout_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(y0, w, tsc, noise, ys, N, T, k1, k2,
                                                                keys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats the packed weight buffer must hold (the wrapper checks its layout)
int sde_rollout_weight_floats() { return W_FLOATS; }

// ys [T, N, 64] from y0 [N, 64]; w packed as in rollout_common.cuh; tsc [T, 4];
// noise [T, N, 64] for mode 0, else NULL.  keys: NULL (the keys are k1, k2) or
// a device uint32[2] holding them (last, so a caller of the older signature
// passes the same arguments before it).  Returns cudaGetLastError().
int sde_rollout_launch(const float* y0, const float* w, const float* tsc, const float* noise,
                       float* ys, int N, int T, unsigned int k1, unsigned int k2, int mode,
                       void* stream, const unsigned int* keys) {
  if (N <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case EXPLICIT:
      if (noise == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<EXPLICIT>(y0, w, tsc, noise, ys, N, T, k1, k2, keys, s));
    case RADEMACHER:
      return static_cast<int>(launch<RADEMACHER>(y0, w, tsc, noise, ys, N, T, k1, k2, keys, s));
    case GAUSSIAN:
      return static_cast<int>(launch<GAUSSIAN>(y0, w, tsc, noise, ys, N, T, k1, k2, keys, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
