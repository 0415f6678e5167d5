// Elementwise-rate probe (kernel K6): 64 chained x = tanh(x) x + x on a
// tile, in f32 or in packed bf16.
//
// Replaces the TPU kernel scripts/bench_vpu_dtype.py::run (pallas_call body
// _kernel), the micro-probe that asks whether a bf16 spine pays on the
// elementwise side of the AA kernels: on the TPU, the VPU's f32 rate
// against its packed bf16 rate.  Here the same question is asked of the
// H100's CUDA cores and special-function units, in three variants:
//   * f32: tanhf (the accurate libdevice tanh) and one FMA per round;
//   * f32 approx: tanh.approx.f32 (one special-function instruction) and
//     one FMA, the f32 counterpart of the packed bf16 tanh;
//   * bf16: two values per 32-bit lane, __nv_bfloat162, with the packed
//     tanh.approx.bf16x2 (sm_90) and __hmul2_rn / __hadd2, each rounding to
//     bf16 as the plain version does after every operation.  The _rn
//     multiply keeps ptxas from contracting it with the add into one
//     fma.rn.bf16x2, which rounds once where the plain version rounds twice
//     (plain __hmul2 is contracted: its outputs were bit-equal to __hfma2's).
//
// Bound on an H100 SXM at the probe's [2048, 128] tile: 3 operations per
// element and round, 5.0e7 in all, 0.75 us at the 67 TFLOP/s f32 CUDA-core
// peak (packed bf16 does two per lane: 0.38 us), against 2.1 MB (f32) of
// input and output (0.63 us at 3.35 TB/s).  The bound is not reachable:
// tanh runs on the special-function units (16 results a clock per SM
// against 128 FMAs), and tanhf needs several instructions besides.  The
// TPU probe's tile gives 256 (f32) or 128 (bf16) blocks, too few to fill
// the card's 132 SMs, so it reads latency; the probe script also runs a
// tile of 65,536 rows, which fills it.  The design keeps the rounds in
// registers: each thread loads 16 bytes (4 f32 or 8 bf16), runs every
// round on them as independent chains, and stores 16 bytes; a grid of
// 256-thread blocks covers the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROUNDS = 64;
enum Kind { F32 = 0, F32_APPROX = 1, BF16 = 2 };

template <bool APPROX>
__device__ __forceinline__ float tanh_f32(float v) {
  if constexpr (APPROX) {
    float out;
    asm("tanh.approx.f32 %0, %1;" : "=f"(out) : "f"(v));
    return out;
  } else {
    return tanhf(v);
  }
}

template <bool APPROX>
__global__ void __launch_bounds__(THREADS)
chained_tanh_f32(const float4* __restrict__ x, float4* __restrict__ y, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n4) return;
  float4 v = x[i];
  for (int r = 0; r < ROUNDS; ++r) {
    v.x = fmaf(tanh_f32<APPROX>(v.x), v.x, v.x);
    v.y = fmaf(tanh_f32<APPROX>(v.y), v.y, v.y);
    v.z = fmaf(tanh_f32<APPROX>(v.z), v.z, v.z);
    v.w = fmaf(tanh_f32<APPROX>(v.w), v.w, v.w);
  }
  y[i] = v;
}

__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 v) {
  uint32_t out;
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(out) : "r"(*reinterpret_cast<const uint32_t*>(&v)));
  return *reinterpret_cast<const __nv_bfloat162*>(&out);
}

__global__ void __launch_bounds__(THREADS)
chained_tanh_bf16(const uint4* __restrict__ x, uint4* __restrict__ y, long long n8) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n8) return;
  uint4 raw = x[i];
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __hadd2(__hmul2_rn(tanh_bf16x2(v[k]), v[k]), v[k]);
  }
  y[i] = raw;
}

}  // namespace

extern "C" {

// y = 64 x (tanh(x) x + x) over n contiguous values of x; kind is 0 (f32,
// tanhf), 1 (f32, tanh.approx.f32) or 2 (bf16).  n must be a multiple of
// 16 bytes' worth of values (4 f32, 8 bf16) and both pointers 16-byte
// aligned.  Returns cudaGetLastError().
int vpu_probe_launch(const void* x, void* y, long long n, int kind, void* stream) {
  const int per = kind == BF16 ? 8 : 4;
  if (n <= 0 || n % per != 0 || kind < F32 || kind > BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = n / per;
  const unsigned blocks = static_cast<unsigned>((vecs + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x4 = static_cast<const float4*>(x);
  auto* y4 = static_cast<float4*>(y);
  if (kind == BF16)
    chained_tanh_bf16<<<blocks, THREADS, 0, s>>>(static_cast<const uint4*>(x),
                                                  static_cast<uint4*>(y), vecs);
  else if (kind == F32_APPROX)
    chained_tanh_f32<true><<<blocks, THREADS, 0, s>>>(x4, y4, vecs);
  else
    chained_tanh_f32<false><<<blocks, THREADS, 0, s>>>(x4, y4, vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
