// One m16n8k8 TF32 tensor-core product, D = A B + C, through the helper K4
// uses (trajsde_tpu_torch/csrc/mma_tf32.cuh), for
// scripts/probe_mma_rounding_torch.py: inputs whose exact result lies
// between two f32 values show how the tensor cores round their sums.
// A [16][8], B [8][8] (depth, column), C and D [16][8], all row-major f32;
// A and B must hold TF32 values (cvt.rna leaves them as they are).

#include "mma_tf32.cuh"

namespace {

__global__ void probe(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t af[4] = {tc::to_tf32(a[g * 8 + t]), tc::to_tf32(a[(g + 8) * 8 + t]),
                          tc::to_tf32(a[g * 8 + t + 4]), tc::to_tf32(a[(g + 8) * 8 + t + 4])};
  const uint32_t bf[2] = {tc::to_tf32(b[t * 8 + g]), tc::to_tf32(b[(t + 4) * 8 + g])};
  float cf[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                 c[(g + 8) * 8 + 2 * t + 1]};
  tc::mma(cf, af, bf);
  tc::for_fragment(cf, 0, 0, [&](int row, int col, float v0, float v1) {
    d[row * 8 + col] = v0;
    d[row * 8 + col + 1] = v1;
  });
}

}  // namespace

extern "C" int mma_rounding_probe_launch(const float* a, const float* b, const float* c, float* d,
                                         void* stream) {
  probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, d);
  return static_cast<int>(cudaGetLastError());
}
