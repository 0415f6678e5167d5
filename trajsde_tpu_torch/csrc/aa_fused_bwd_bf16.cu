// Fused AA pair chain, bf16 backward (kernel K4b): the VJP of K3b
// (aa_fused.cu's bf16 form) for training with encoder.fused: true and
// dtype bfloat16.
//
// Replaces the TPU kernel trajsde_tpu/ops/pallas/aa_fused.py::_bwd_call
// with FusedCfg(dtype="bfloat16") (pallas_call body _bwd_kernel: jax.vjp of
// pair_chain in bf16), a rounding's derivative taken as 1 (the VJP of
// astype).  It computes what K4 (aa_fused_bwd.cu) computes, on K3b's chain:
// given the cotangent g [R, 64] of K3b's output, dq [R, 64] and the
// gradients of the 14 packed weights, from K3b's softmax statistics, with
// K4's flash-attention identity for dlogit and its dq correction by
// S sum_j alpha_j k_j.
//   * The recompute is K3b's: its three products go through mma_bf16.cuh's
//     mma_xwt_bf16 over the same bf16 operands (w1 unfolded: [a0 | a0] over
//     K = 4D, the weights staged as K3b stages them, bf16 and transposed)
//     and its epilogues through aa_common.cuh's epi_a1, epi_nbr, epi_bias
//     and head_logit with BF and ln_mm, so its logits are K3b's bit for bit.
//   * The six backward products pair an f32 cotangent with a bf16 operand
//     (a weight in the input gradients, a LayerNorm output in the weight
//     gradients), which is exact in TF32: mma_bf16.cuh's two-term products
//     split the cotangent into two TF32 terms and take 2 products where
//     3xTF32 takes 3, at f32 accuracy.  da0 = [dz | dz] w1^T runs over
//     K = 2D, w1's halves apart.  JAX's rounding of each tile's w1, wagg and
//     wkv gradient to bf16 (the VJP of w.astype(a.dtype) in its mm) is a
//     product of its tiling and is not copied.
//   * The LayerNorm VJPs take xhat's row mean into account (aa_bwd_common.cuh's
//     ln_vjp with BF), which is not 0 when ln_mm took the mean from
//     bf16-rounded inputs.
//
// Bound on its route (chip_smoke.aa_fused_bwd_bound with bf16): the
// recompute's three products (10 D^2 a pair) at the bf16 tensor-core rate,
// the six backward products (20 D^2) at half the TF32 rate (two products
// each), the rest on the CUDA cores at the same time: 1.18 ms at the
// training twin shape at batch 64 (8 heads), against 6.19 ms with every
// operation on the CUDA cores.
//
// Design.  A persistent grid (one 256-thread block per SM) walks groups of
// 8 receivers with all their senders in chunks of 32 pairs, as K4.  K4's
// design with bf16 products put in (K4b before it had a file of its own)
// took 18.3-18.5 ms at batch 64 (scripts/compare_aa_bwd_builds_torch.py
// --bf16 on an H100): 12.8 without the six backward products, 16.9 without
// the recompute's three, 17.3 without the column and dq sums; 17 barriers a
// chunk.  This kernel keeps the products and their order and changes the
// rest:
//   * Column sums.  The vector gradients (bkv, lna1s/b, bagg, lna0s/b, b1,
//     ln0s/b, bu, wu: 1,408 columns) are summed where the epilogues hold
//     their values: each thread adds its 2 rows in registers, one shuffle
//     joins the warp's two row groups (lanes l and l ^ 16 hold the same
//     columns; each keeps half of them, reduce_cols), and the sum is added
//     to the warp's own accumulator in shared memory, all of an epilogue's
//     accumulator values read before any is written.  At the end of a group
//     the 8 warps' accumulators are summed in a fixed tree into the block's
//     f64 slice.  No phase of its own (K4's B5), and the tiles only the sums
//     read (xhat of the first LayerNorms, d(pre-ReLU a0), dh) are not
//     written.
//   * dq.  The epilogue that recomputes k stores each row's dlogit k, alpha k
//     and dlogit (dq_partials) and writes dk | dv where k | v lay; after
//     nbr's LayerNorm VJP the block sums them per (receiver, column) over the
//     chunk's rows in a fixed tree (dq_sums).  K4's dq phase and its two
//     barriers are gone.
//   * Loads.  u, the mask and keep of the next chunk, and q, g and the
//     statistics of the next group, go into the other stage of a two-stage
//     ring with cp.async while this chunk computes, and are waited for at
//     the chunk's last barrier; g . out per (receiver, head) is a
//     lane-parallel head_sum of 4-column dots.  a0 is held in bf16 (its
//     values are), which frees the room for the ring and gives the first
//     recompute product its operand pairs in one load.
//   * The group's f64 write-out reads the old values of a batch of tiles
//     before it writes any (each add waited on the last's read before).
//   So a chunk takes 13 barriers.  Measured on an H100 (the same script, in
//   turns with the parent's): 17.9-18.4 ms at batch 64 against 18.3-18.6,
//   35.3-35.4 at 128 against 36.3-36.5, 4 heads at 64 17.4 against 17.9-18.1.
//   Less than the parts suggested: the 80 weight-gradient accumulators live
//   through the chunk keep the kernel at 255 registers, which ptxas fills
//   with the two-deep products' hoisted operands (96-100 B of spills here,
//   none in K4's form); with those loops not unrolled the spills go and
//   the kernel is slower.  The parts, each removed alone, sum to far more
//   than the whole, since each removal frees registers for the rest.
//   Order of the sums: a column of a vector gradient is, per chunk and warp,
//   (row 4w + row 4w + 1) + (row 4w + 2 + row 4w + 3), added to the warp's
//   accumulator chunk by chunk, the 8 warps' then summed as ((w0 + w1) +
//   (w2 + w3)) + ((w4 + w5) + (w6 + w7)); dq's, per chunk, the receiver's
//   rows in a tree of pairs (the others as 0), added chunk by chunk
//   (tests/test_torch_aa_fused_bwd_bf16_sums.py models both in f32 against
//   f64, with K4's serial sums).  The matrix gradients, the per-group f64
//   workspace, reduce_partials' fixed order and bit-equal reruns are K4's;
//   no float atomics.
// Shared memory: the weights (f32 vectors, bf16 matrices, 67,072 B), the
// chunk tiles (83,456 B), the ring, the group's sums, the dq partials and the
// warps' vector-gradient accumulators (45,056 B): 230,400 B at 8 heads
// (228,096 at 4), one block per SM.
// Heads: a template on the head count H (8, the flagship's; 4, the HiVT
// baseline's), with an entry point each.  The ragged last chunk and group
// are bounds-checked: dead rows carry zero cotangents and add exact zeros.
// Pair offsets are 64-bit.

#include "aa_common.cuh"
#include "mma_tf32.cuh"
#include "mma_bf16.cuh"
#include "aa_bwd_common.cuh"

namespace {

using namespace aa;
using namespace aa_bwd;

constexpr int WARPS = THREADS / 32;
constexpr int LB_W1 = 2 * D2 + 8;  // row strides of the staged bf16 matrices (K3b's)
constexpr int LB = D + 8;

// staged weights (floats): the vectors in f32 in the layout of the vector
// gradients (aa_bwd_common.cuh's V_*, with b1f = b1[:D] + b1[D:] at V_B1),
// then the matrices in bf16 as K3b stages them: w1 as [w1[:, :D];
// w1[:, D:]]^T [D][LB_W1], wagg^T [D][LB], wkv^T [2D][LB]
constexpr int S_W1 = V_FLOATS;
constexpr int S_WAGG = S_W1 + D * LB_W1 / 2;
constexpr int S_WKV = S_WAGG + D * LB / 2;
constexpr int SW_FLOATS = S_WKV + D2 * LB / 2;

// chunk tiles
constexpr int LA0 = D2 + 8;    // a0's bf16 row stride
constexpr int LAC = D + 4;     // padded f32 rows of a1 and nbr
constexpr int T_A0 = SW_FLOATS;                // bf16 [P][LA0] a0
constexpr int T_KV = T_A0 + P * LA0 / 2;       // [P][2D] k|v, then dk|dv, then da0 (swizzled)
constexpr int T_XB = T_KV + P * D2;            // [P][D] xhat of LN(a1 wagg + bagg)
constexpr int T_NB = T_XB + P * D;             // [P][LAC] nbr
constexpr int T_XA = T_NB + P * LAC;           // [P][D] xhat of LN(z1[:D] + z1[D:])
constexpr int T_A1 = T_XA + P * D;             // [P][LAC] a1
constexpr int T_DN = T_A1 + P * LAC;           // [P][D] dnbr (swizzled)
constexpr int T_DY = T_DN + P * D;             // [P][D] dy3 (swizzled)
constexpr int T_DZ = T_DY + P * D;             // [P][D] da1, then dz (swizzled)
constexpr int T_END = T_DZ + P * D;

// the rest of the layout, per head count H
template <int H>
struct Smem {
  // the ring: two stages of a chunk's u [P][4], mask [P] and keep [P][H],
  // then two stages of a group's q [RB][D], g [RB][D] and K3b's statistics
  // (max, sum) [2][RB][H]
  static constexpr int C_U = 0, C_MASK = P * 4, C_KEEP = C_MASK + P, CHUNK = C_KEEP + P * H;
  static constexpr int G_Q = 0, G_G = RB * D, G_STATS = 2 * RB * D, GROUP = G_STATS + 2 * RB * H;
  static constexpr int S_CHUNKS = T_END;
  static constexpr int S_GROUPS = S_CHUNKS + 2 * CHUNK;
  // the group's sums
  static constexpr int S_DQ = S_GROUPS + 2 * GROUP;  // [RB][D] sum_j dlogit_j k_j / sqrt(hd)
  static constexpr int S_AK = S_DQ + RB * D;         // [RB][D] sum_j alpha_j k_j
  static constexpr int S_DS = S_AK + RB * D;         // [RB][H] sum_j dlogit_j
  static constexpr int S_DELTA = S_DS + RB * H;      // [RB][H] g . out per head
  static constexpr int S_INVA = S_DELTA + RB * H;    // [P] 1/std of a1's LayerNorm
  static constexpr int S_INVB = S_INVA + P;          // [P] and of nbr's
  // a chunk's dq partials per row: dlogit k [D], alpha k [D], dlogit [H]
  static constexpr int PQ = 2 * D + H;
  static constexpr int S_PQ = S_INVB + P;            // [P][PQ]
  static constexpr int S_VG = S_PQ + P * PQ;         // [WARPS][V_FLOATS] each warp's
  static constexpr int S_FLOATS = S_VG + WARPS * V_FLOATS;

  static_assert(T_A0 % 4 == 0 && T_KV % 4 == 0 && S_CHUNKS % 4 == 0 && CHUNK % 4 == 0 &&
                S_GROUPS % 4 == 0 && GROUP % 4 == 0 && S_DQ % 4 == 0 && S_PQ % 4 == 0 &&
                PQ % 4 == 0 && S_VG % 4 == 0, "float4 and 16-byte copy alignment");
  static_assert(2 * P + P * H / 4 <= THREADS, "a chunk's loads take one copy a thread");
  static_assert(S_FLOATS * 4 <= 232448, "shared memory of one block");
};

// packed index of float i of the vector layout, from lna0s on
__device__ __forceinline__ int packed_vec(int i) {
  if (i < V_BAGG) return OFF_LNA0S + (i - V_LNA0S);
  if (i < V_BKV) return OFF_BAGG + (i - V_BAGG);
  return OFF_BKV + (i - V_BKV);
}

// where float i of the vector layout goes in the packed layout (b1's
// shared half goes to both halves: also to second, else -1)
__device__ __forceinline__ int packed_target(int i, int* second) {
  *second = i >= V_B1 && i < V_LNA0S ? OFF_B1 + D + i - V_B1 : -1;
  if (i < V_B1) return i;
  if (i < V_LNA0S) return OFF_B1 + i - V_B1;
  return packed_vec(i);
}

// the C fragments c[0 .. NF) of a warp's tiles at rows m0 .., columns
// n0 + n_step f .., into part (row stride ld) at each column offset of cols,
// in f64: stored on a block's first group, else added.  Every old value is
// read before any is written (the addresses are this thread's alone), so
// the reads wait on one another's latency once.
template <int NF, int NO>
__device__ __forceinline__ void put_tiles(double* part, int ld, const int (&cols)[NO],
                                          const float (*c)[4], int m0, int n0, int n_step,
                                          bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double2 old[NF][2][NO];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < NO; ++o)
        old[f][h][o] = first ? make_double2(0.0, 0.0)
                             : *reinterpret_cast<const double2*>(
                                   part + (m0 + g + 8 * h) * ld + cols[o] + n0 + n_step * f + 2 * t);
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        double2 v = make_double2(c[f][2 * h], c[f][2 * h + 1]);
        if (!first) {
          v.x += old[f][h][o].x;
          v.y += old[f][h][o].y;
        }
        *reinterpret_cast<double2*>(part + (m0 + g + 8 * h) * ld + cols[o] + n0 + n_step * f +
                                    2 * t) = v;
      }
}

// cp.async of 16 (or 4) bytes from device to shared memory, zeros where
// !valid (src then only has to be a device address)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// a group's q, g and statistics into a group stage (zeros past its last receiver)
template <int H>
__device__ __forceinline__ void load_group(float* st, const float* q, const float* g,
                                           const float* stats, long long R, long long rbase,
                                           int nrecv) {
  using L = Smem<H>;
  constexpr int QV = RB * D / 4, SV = RB * H / 4;  // 16-byte pieces of q (or g), of one statistic
  for (int i = threadIdx.x; i < 2 * QV + 2 * SV; i += THREADS) {
    if (i < 2 * QV) {
      const int j = i % QV;
      const bool live = j / (D / 4) < nrecv;
      cp16(st + (i < QV ? L::G_Q : L::G_G) + 4 * j, (i < QV ? q : g) + (live ? rbase * D + 4 * j : 0),
           live);
    } else {
      const int k = i - 2 * QV, which = k / SV, j = k % SV;
      const bool live = 4 * j / H < nrecv;
      cp16(st + L::G_STATS + which * RB * H + 4 * j,
           stats + (live ? ((which ? R : 0) + rbase) * H + 4 * j : 0), live);
    }
  }
}

// a chunk's u, mask and keep (its n pairs from gp0; zeros after) into a chunk stage
template <int H>
__device__ __forceinline__ void load_chunk(float* st, const float* u, const float* mask,
                                           const float* keep, long long gp0, int n) {
  using L = Smem<H>;
  const int t = threadIdx.x;
  if (t < P) {
    cp16(st + L::C_U + 4 * t, u + (t < n ? (gp0 + t) * 4 : 0), t < n);
  } else if (t < 2 * P) {
    const int p = t - P;
    cp4(st + L::C_MASK + p, mask + (p < n ? gp0 + p : 0), p < n);
  } else if (keep != nullptr && t < 2 * P + P * H / 4) {
    const int j = t - 2 * P;
    const bool live = 4 * j / H < n;
    cp16(st + L::C_KEEP + 4 * j, keep + (live ? gp0 * H + 4 * j : 0), live);
  }
}

// the recompute's bf16 operands: a0 from its bf16 tile as [a0 | a0] over
// K = 4D (the unfolded w1), (m, k even) -> the pair (mma_bf16.cuh)
struct A0Twice {
  const __nv_bfloat16* p;
  __device__ __forceinline__ uint32_t operator()(int m, int k) const {
    return *reinterpret_cast<const uint32_t*>(p + m * LA0 + (k & (D2 - 1)));
  }
};

struct A0 {  // a0 as f32 values (exact), (row, col) -> value
  const __nv_bfloat16* p;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return __bfloat162float(p[r * LA0 + c]);
  }
};

struct PlainBf {  // a padded f32 tile of bf16 values, (m, k even) -> the pair
  const float* p;
  int ld;
  __device__ __forceinline__ uint32_t operator()(int m, int k) const {
    const float2 v = *reinterpret_cast<const float2*>(p + m * ld + k);
    return tc::pack_bf16x2(v.x, v.y);
  }
};

// W [N][K] of a backward product X W^T, read from a staged W^T [K][ld] in
// bf16 as the f32 bits of the value: wkv (N = D, K = 2D) or wagg
struct WBack {
  const __nv_bfloat16* p;
  int ld;
  __device__ __forceinline__ uint32_t operator()(int n, int k) const {
    return tc::bf16_bits(p[k * ld + n]);
  }
};

// w1 [2D][2D] (N = K = 2D) from K3b's staged operand, where w1[n][k] lies
// at row k mod D, depth (k / D) 2D + n
struct W1Back {
  const __nv_bfloat16* p;
  __device__ __forceinline__ uint32_t operator()(int n, int k) const {
    return tc::bf16_bits(p[(k % D) * LB_W1 + (k / D) * D2 + n]);
  }
};

struct SwzTwice {  // dz1 = [dz | dz] over K = 2D from dz's swizzled tile
  const float* p;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return p[swz(m, k & (D - 1), D)];
  }
};

#ifdef AA_WRITE_LOGITS
__device__ float* g_logits;  // [R * Ak][H]
#endif

// adds this thread's values v[a][j] (each the sum of its 2 rows) at
// columns col(j) of NV vector gradients, at acc + off[a], to its warp's
// accumulator acc: the warp's two row groups (lanes l and l ^ 16) hold the
// same columns, so the lower lane keeps the even j and the upper the odd,
// each adding the other's value (one shuffle per pair of columns; the two
// sums are the same bits).  Every accumulator value is read before any is
// written, so the reads do not wait on one another's writes.
template <int NV, int N, class Col>
__device__ __forceinline__ void reduce_cols(float* acc, const int (&off)[NV],
                                            const float (&v)[NV][N], Col col) {
  static_assert(N % 2 == 0, "columns in pairs");
  const bool upper = (threadIdx.x & 16) != 0;
  float cur[NV][N / 2];
#pragma unroll
  for (int a = 0; a < NV; ++a)
#pragma unroll
    for (int j = 0; j < N; j += 2) cur[a][j / 2] = acc[off[a] + col(upper ? j + 1 : j)];
#pragma unroll
  for (int a = 0; a < NV; ++a)
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const float theirs = __shfl_xor_sync(0xffffffffu, upper ? v[a][j] : v[a][j + 1], 16);
      cur[a][j / 2] += (upper ? v[a][j + 1] : v[a][j]) + theirs;
    }
#pragma unroll
  for (int a = 0; a < NV; ++a)
#pragma unroll
    for (int j = 0; j < N; j += 2) acc[off[a] + col(upper ? j + 1 : j)] = cur[a][j / 2];
}

// one row's dq partials at its columns c0 .. c0 + 3: dlogit k at
// pq[0 .. D), alpha k at pq[D .. 2D), and dlogit at pq[2D + h] (the head's
// first lane)
template <int H>
__device__ __forceinline__ void dq_partials(float* pq, int c0, bool head_lane, int h, float dl,
                                            float al, const float (&k)[4]) {
  const float xd[4] = {dl * k[0], dl * k[1], dl * k[2], dl * k[3]};
  const float xa[4] = {al * k[0], al * k[1], al * k[2], al * k[3]};
  store4(pq + c0, xd);
  store4(pq + D + c0, xa);
  if (head_lane) pq[2 * D + h] = dl;
}

// B1: the chunk's dq partials summed per (receiver, column) over its rows
// in a tree of pairs (the rows of another receiver, and dead ones, as 0),
// into the group's sums; a row group's 2 rows are the tree's first pair
template <int H>
__device__ __forceinline__ void dq_sums(float* sdq, float* sak, float* sds, const float* spq,
                                        int cp0, int pend, int Ak) {
  using L = Smem<H>;
  const int rl_lo = cp0 / Ak, nspan = (pend - 1) / Ak - rl_lo + 1;
  for (int item = threadIdx.x; item < nspan * L::PQ; item += THREADS) {
    const int rr = rl_lo + item / L::PQ, j = item % L::PQ;
    const int lo = rr * Ak - cp0, hi = (rr + 1) * Ak - cp0;  // its rows of the chunk
    // the tree ((v0 + v1) + (v2 + v3)) + ... built as the rows come: the
    // partial sum of each level waits in part[level] for its right half
    float part[5], v = 0.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      v = r >= lo && r < hi ? spq[r * L::PQ + j] : 0.0f;
#pragma unroll
      for (int level = 0; level < 5; ++level) {
        if (((r >> level) & 1) == 0) {
          part[level] = v;
          break;
        }
        v = part[level] + v;
      }
    }
    if (j < D)
      sdq[rr * D + j] += v * Heads<H>::SCALE;
    else if (j < 2 * D)
      sak[rr * D + j - D] += v;
    else
      sds[rr * H + j - 2 * D] += v;
  }
}

// a group's start: its sums of dlogit to 0, and K3b's g . out per
// (receiver, head), 4 columns a thread, a head's lanes summed (receivers
// past nrecv give 0)
template <int H>
__device__ __forceinline__ void group_start(float* sds, float* sdelta, const float* sg,
                                            const float* out, long long rbase, int nrecv) {
  const int tid = threadIdx.x, cg = tid & 15;
  if (tid < RB * H) sds[tid] = 0.0f;
  if (tid < RB * D / 4) {  // whole warps
    const int rl = tid / (D / 4), c = 4 * cg;
    const float4 gv = ld4(sg + rl * D + c);
    const float4 ov = rl < nrecv ? ld4(out + (rbase + rl) * D + c) : make_float4(0, 0, 0, 0);
    float s = gv.x * ov.x;
    s = fmaf(gv.y, ov.y, s);
    s = fmaf(gv.z, ov.z, s);
    s = fmaf(gv.w, ov.w, s);
    s = head_sum<H>(s);
    if (cg % Heads<H>::LANES == 0) sdelta[rl * H + cg / Heads<H>::LANES] = s;
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
aa_fused_bwd_bf16_kernel(const float* __restrict__ q, const float* __restrict__ u,
                         const float* __restrict__ mask, const float* __restrict__ keep,
                         const float* __restrict__ w, const float* __restrict__ g,
                         const float* __restrict__ out, const float* __restrict__ stats,
                         float* __restrict__ dq, double* __restrict__ partial, long long R,
                         int Ak, float keep_scale, int ln_mm) {
  using L = Smem<H>;
  constexpr int HD = Heads<H>::HD;
  constexpr int HL = Heads<H>::LANES;
  constexpr float SCALE = Heads<H>::SCALE;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  __nv_bfloat16* bw1 = reinterpret_cast<__nv_bfloat16*>(smem + S_W1);
  __nv_bfloat16* bwagg = reinterpret_cast<__nv_bfloat16*>(smem + S_WAGG);
  __nv_bfloat16* bwkv = reinterpret_cast<__nv_bfloat16*>(smem + S_WKV);
  __nv_bfloat16* a0t = reinterpret_cast<__nv_bfloat16*>(smem + T_A0);
  float* kvt = smem + T_KV;
  float* xbt = smem + T_XB;
  float* nbt = smem + T_NB;
  float* xat = smem + T_XA;
  float* a1t = smem + T_A1;
  float* dnt = smem + T_DN;
  float* dyt = smem + T_DY;
  float* dzt = smem + T_DZ;
  float* chunks = smem + L::S_CHUNKS;
  float* groups_ring = smem + L::S_GROUPS;
  float* sdq = smem + L::S_DQ;
  float* sak = smem + L::S_AK;
  float* sds = smem + L::S_DS;
  float* sdelta = smem + L::S_DELTA;
  float* sinva = smem + L::S_INVA;
  float* sinvb = smem + L::S_INVB;
  float* spq = smem + L::S_PQ;
  const bool stats16 = ln_mm != 0;

  const int tid = threadIdx.x;
  const int cg = tid & 15;      // column group
  const int c0 = cg * 4;        // forward products: columns c0 .. c0+3 (and D + ...)
  const int rg = tid >> 4;      // row group
  const int r0 = rg * NR;
  const int warp = tid >> 5;    // tensor-core products: this warp's tiles
  float* vg = smem + L::S_VG + warp * V_FLOATS;  // this warp's vector-gradient accumulator
  const auto col16 = [cg](int m) { return cg + 16 * m; };

  // the first group's and chunk's inputs, then the weights while they load
  long long grp = blockIdx.x;  // the wrapper's grid has at most one block per group
  long long rbase = grp * RB;
  int nrecv = static_cast<int>(R - rbase < RB ? R - rbase : RB);
  int npairs = nrecv * Ak;
  load_group<H>(groups_ring, q, g, stats, R, rbase, nrecv);
  load_chunk<H>(chunks, u, mask, keep, rbase * Ak, npairs < P ? npairs : P);
  cp_commit();
  for (int i = tid; i < V_FLOATS; i += THREADS) {
    if (i < V_B1)
      sw[i] = w[i];
    else if (i < V_LNA0S)
      sw[i] = w[OFF_B1 + i - V_B1] + w[OFF_B1 + D + i - V_B1];
    else
      sw[i] = w[packed_vec(i)];
  }
  for (int i = tid; i < D2 * D2; i += THREADS) {
    const int r = i / D2, c = i % D2;
    bw1[(c % D) * LB_W1 + (c / D) * D2 + r] = __float2bfloat16_rn(w[OFF_W1 + i]);
  }
  for (int i = tid; i < D * D; i += THREADS)
    bwagg[(i % D) * LB + i / D] = __float2bfloat16_rn(w[OFF_WAGG + i]);
  for (int i = tid; i < D * D2; i += THREADS)
    bwkv[(i % D2) * LB + i / D2] = __float2bfloat16_rn(w[OFF_WKV + i]);
  for (int i = tid; i < WARPS * V_FLOATS; i += THREADS) smem[L::S_VG + i] = 0.0f;
  for (int i = tid; i < RB * D; i += THREADS) sdq[i] = sak[i] = 0.0f;
  cp_wait_all();
  __syncthreads();

  // the group's matrix gradients, C fragments of this warp's 16 x 8 tiles:
  // a0^T dz [128 x 64] rows 16 warp.., all 8 column tiles; nbr^T dkv
  // [64 x 128] rows 16 (warp % 4).., columns 64 (warp / 4) + 8 j; a1^T dy3
  // [64 x 64] rows 16 (warp % 4).., columns 32 (warp / 4) + 8 j
  float gw1[1][8][4], gkv[1][8][4], gagg[1][4][4];
  const int wm = 16 * (warp & 3);
  int cs = 0, gs = 0;  // the ring's stages of this chunk and group
  group_start<H>(sds, sdelta, groups_ring + L::G_G, out, rbase, nrecv);

  for (int cp0 = 0;;) {
    if (cp0 == 0) {
      zero_tiles<1, 8>(gw1);
      zero_tiles<1, 8>(gkv);
      zero_tiles<1, 4>(gagg);
    }
    const int pend = min(cp0 + P, npairs);  // group-relative, exclusive
    // the next chunk's inputs (and its group's) into the ring's other stages
    {
      const bool last = cp0 + P >= npairs;
      const long long ngrp = last ? grp + gridDim.x : grp;
      if (ngrp * RB < R) {
        const long long nbase = ngrp * RB;
        const int nn = static_cast<int>(R - nbase < RB ? R - nbase : RB);
        const int ncp0 = last ? 0 : cp0 + P;
        if (last) load_group<H>(groups_ring + (gs ^ 1) * L::GROUP, q, g, stats, R, nbase, nn);
        load_chunk<H>(chunks + (cs ^ 1) * L::CHUNK, u, mask, keep, nbase * Ak + ncp0,
                      min(P, nn * Ak - ncp0));
        cp_commit();
      }
    }
    const int co = cs * L::CHUNK, go = gs * L::GROUP;  // this chunk's and group's stages
    const float* su = chunks + co + L::C_U;
    const float* smask = chunks + co + L::C_MASK;
    const float* skeep = chunks + co + L::C_KEEP;
    const float* sq = groups_ring + go + L::G_Q;
    const float* sg = groups_ring + go + L::G_G;
    const float* ssm = groups_ring + go + L::G_STATS;
    const float* ssl = ssm + RB * H;

    // F1. h = bu + u wu; a0 = relu(LN per branch) -> a0t (bf16, as its values are)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float* up = su + (r0 + i) * 4;
      float hv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = half * D + c0 + j;
          float s = up[0] * sw[V_WU + col] + up[1] * sw[V_WU + D2 + col];
          s += up[2] * sw[V_WU + 2 * D2 + col];
          s += up[3] * sw[V_WU + 3 * D2 + col];
          hv[half][j] = sw[V_BU + col] + s;
        }
      ln_row_t<true>(hv[0], sw + V_LN0S, sw + V_LN0B, c0, true, stats16, nullptr, nullptr);
      ln_row_t<true>(hv[1], sw + V_LN0S + D, sw + V_LN0B + D, c0, true, stats16, nullptr, nullptr);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint2*>(a0t + (r0 + i) * LA0 + half * D + c0) =
            make_uint2(tc::pack_bf16x2(hv[half][0], hv[half][1]),
                       tc::pack_bf16x2(hv[half][2], hv[half][3]));
    }
    __syncthreads();

    // F2. [a0 | a0] [w1[:, :D]; w1[:, D:]] -> a1t; a1 = relu(LN(. + b1f)) in
    // place, its xhat -> xat (K3b's product and epilogue)
    {
      float acc[1][2][4] = {};
      tc::mma_xwt_bf16<1, 2, 2 * D2, 2>(A0Twice{a0t}, tc::WBf{bw1, LB_W1}, 16 * (warp & 1),
                                        16 * (warp >> 1), 8, acc);
      tc::store_c<2>(a1t, PadAt{LAC}, acc, 16 * (warp & 1), 16 * (warp >> 1));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float x[4], xh[4], inv;
      load4(x, a1t + (r0 + i) * LAC + c0);
      epi_a1<true>(x, sw + V_B1, sw + V_LNA0S, sw + V_LNA0B, c0, xh, &inv, stats16);
      store4(a1t + (r0 + i) * LAC + c0, x);
      store4(xat + (r0 + i) * D + c0, xh);
      if (cg == 0) sinva[r0 + i] = inv;
    }
    __syncthreads();

    // F3. a1 wagg -> nbt; nbr = LN(. + bagg) in place, its xhat -> xbt
    {
      float acc[1][2][4] = {};
      tc::mma_xwt_bf16<1, 2, D, 2>(PlainBf{a1t, LAC}, tc::WBf{bwagg, LB}, 16 * (warp & 1),
                                   16 * (warp >> 1), 8, acc);
      tc::store_c<2>(nbt, PadAt{LAC}, acc, 16 * (warp & 1), 16 * (warp >> 1));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float x[4], xh[4], inv;
      load4(x, nbt + (r0 + i) * LAC + c0);
      epi_nbr<true>(x, sw + V_BAGG, sw + V_LNA1S, sw + V_LNA1B, c0, xh, &inv, stats16);
      store4(nbt + (r0 + i) * LAC + c0, x);
      store4(xbt + (r0 + i) * D + c0, xh);
      if (cg == 0) sinvb[r0 + i] = inv;
    }
    __syncthreads();

    // F4. nbr wkv -> kvt
    {
      float acc[1][4][4] = {};
      tc::mma_xwt_bf16<1, 4, D, 2>(PlainBf{nbt, LAC}, tc::WBf{bwkv, LB}, 16 * (warp & 1),
                                   32 * (warp >> 1), 8, acc);
      tc::store_c<4>(kvt, SwzAt{D2}, acc, 16 * (warp & 1), 32 * (warp >> 1));
    }
    __syncthreads();

    // [k | v] + bkv; alpha from K3b's statistics; dlogit; dk | dv into
    // kvt where k | v lay; bkv's column sums; dq's partials
    {
      const int h = cg / HL;
      float bkv[1][8];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        const bool live = cp0 + p < pend;
        const int rl = min(cp0 + p, pend - 1) / Ak;  // a dead row: the last live one's (zeros)
        float k[4], v[4];
        load4(k, kvt + swz(p, c0, D2));
        load4(v, kvt + swz(p, D + c0, D2));
        epi_bias(k, sw + V_BKV, c0);
        epi_bias(v, sw + V_BKV + D, c0);
        const float4 qv = ld4(sq + rl * D + c0);
        const float4 gv = ld4(sg + rl * D + c0);
        const float lg = head_logit<H>(qv, k);
        float gdv = gv.x * v[0];
        gdv = fmaf(gv.y, v[1], gdv);
        gdv = fmaf(gv.z, v[2], gdv);
        gdv = fmaf(gv.w, v[3], gdv);
        // a head's columns are the 4 of this lane and those of the others of its head
        gdv = head_sum<H>(gdv);
#ifdef AA_WRITE_LOGITS
        if (cg % HL == 0 && live)
          g_logits[(rbase * Ak + cp0 + p) * H + h] = smask[p] > 0.0f ? lg : -INFINITY;
#endif
        float dl = 0.0f, ak = 0.0f, al = 0.0f;
        const float lsum = ssl[rl * H + h];
        if (live && smask[p] > 0.0f && lsum > 0.0f) {
          al = expf(lg - ssm[rl * H + h]) / lsum;
          const float kp = (keep == nullptr ? 1.0f : skeep[p * H + h]) * keep_scale;
          ak = al * kp;
          dl = al * (kp * gdv - sdelta[rl * H + h]);
        }
        const float ds = dl * SCALE;
        const float dkv[8] = {ds * qv.x, ds * qv.y, ds * qv.z, ds * qv.w,
                              ak * gv.x, ak * gv.y, ak * gv.z, ak * gv.w};
        store4(kvt + swz(p, c0, D2), dkv);
        store4(kvt + swz(p, D + c0, D2), dkv + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) bkv[0][j] = i == 0 ? dkv[j] : bkv[0][j] + dkv[j];
        dq_partials<H>(spq + p * L::PQ, c0, cg % HL == 0, h, dl, al, k);
      }
      reduce_cols<1, 8>(vg, {V_BKV}, bkv, [c0](int j) { return j < 4 ? c0 + j : D + c0 + j - 4; });
    }
    __syncthreads();

    // B2. dwkv += nbr^T dkv; dnbr = dkv wkv^T -> dnt
    {
      float dn[1][2][4];
      zero_tiles<1, 2>(dn);
      tc::mma_xty_exact_x<1, 8, P, 2>(Plain{nbt, LAC}, Swz{kvt, D2}, wm, 64 * (warp >> 2), gkv);
      tc::mma_xwt_exact_w<1, 2, D2, 2>(Swz{kvt, D2}, WBack{bwkv, LB}, 16 * (warp & 1),
                                       16 * (warp >> 1), dn);
      tc::store_c<2>(dnt, SwzAt{D}, dn, 16 * (warp & 1), 16 * (warp >> 1));
    }
    __syncthreads();
    // LN VJP -> dy3; the lna1 and bagg column sums
    {
      float sums[3][4];  // lna1b, lna1s, bagg
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        float dn[4], xh[4], sc[4], dy[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dn[m] = dnt[swz(p, col16(m), D)];
          xh[m] = xbt[p * D + col16(m)];
          sc[m] = sw[V_LNA1S + col16(m)];
        }
        ln_vjp<4, true>(dn, xh, sc, sinvb[p], dy);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dyt[swz(p, col16(m), D)] = dy[m];
          sums[0][m] = i == 0 ? dn[m] : sums[0][m] + dn[m];
          sums[1][m] = i == 0 ? dn[m] * xh[m] : sums[1][m] + dn[m] * xh[m];
          sums[2][m] = i == 0 ? dy[m] : sums[2][m] + dy[m];
        }
      }
      reduce_cols<3, 4>(vg, {V_LNA1B, V_LNA1S, V_BAGG}, sums, col16);
    }
    // B1. dq, sum_j alpha_j k_j and sum_j dlogit_j per (receiver, column):
    // the chunk's row partials in a fixed tree (here, where few registers are
    // live)
    dq_sums<H>(sdq, sak, sds, spq, cp0, pend, Ak);
    __syncthreads();

    // B3. dwagg += a1^T dy3; da1 = dy3 wagg^T -> dzt
    {
      float da[1][2][4];
      zero_tiles<1, 2>(da);
      tc::mma_xty_exact_x<1, 4, P, 2>(Plain{a1t, LAC}, Swz{dyt, D}, wm, 32 * (warp >> 2), gagg);
      tc::mma_xwt_exact_w<1, 2, D, 2>(Swz{dyt, D}, WBack{bwagg, LB}, 16 * (warp & 1),
                                      16 * (warp >> 1), da);
      tc::store_c<2>(dzt, SwzAt{D}, da, 16 * (warp & 1), 16 * (warp >> 1));
    }
    __syncthreads();
    // ReLU, LN VJP -> dz in place; the lna0 and b1 column sums
    {
      float sums[3][4];  // lna0b, lna0s, b1
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        float da1[4], xh[4], sc[4], dz[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = col16(m);
          da1[m] = a1t[p * LAC + col] > 0.0f ? dzt[swz(p, col, D)] : 0.0f;
          xh[m] = xat[p * D + col];
          sc[m] = sw[V_LNA0S + col];
        }
        ln_vjp<4, true>(da1, xh, sc, sinva[p], dz);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          dzt[swz(p, col16(m), D)] = dz[m];
          sums[0][m] = i == 0 ? da1[m] : sums[0][m] + da1[m];
          sums[1][m] = i == 0 ? da1[m] * xh[m] : sums[1][m] + da1[m] * xh[m];
          sums[2][m] = i == 0 ? dz[m] : sums[2][m] + dz[m];
        }
      }
      reduce_cols<3, 4>(vg, {V_LNA0B, V_LNA0S, V_B1}, sums, col16);
    }
    __syncthreads();

    // B4. dw1 += a0^T dz; da0 = [dz | dz] w1^T over K = 2D (w1's two column
    // halves apart) -> kvt
    {
      float da[1][4][4];
      zero_tiles<1, 4>(da);
      tc::mma_xty_exact_x<1, 8, P, 2>(A0{a0t}, Swz{dzt, D}, 16 * warp, 0, gw1);
      tc::mma_xwt_exact_w<1, 4, D2, 2>(SwzTwice{dzt}, W1Back{bw1}, 16 * (warp & 1),
                                       32 * (warp >> 1), da);
      tc::store_c<4>(kvt, SwzAt{D2}, da, 16 * (warp & 1), 32 * (warp >> 1));
    }
    __syncthreads();
    // ReLU, the two branch LN VJPs -> dh; the ln0, bu and wu column sums
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sums[3][4], uh[4][4];  // ln0b, ln0s, bu; wu
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int p = r0 + i;
        const float* up = su + p * 4;
        // recompute this branch's LayerNorm input h and its statistics
        float xh[4], sc[4], dh[4], dpre[4], sum = 0.0f, sq2 = 0.0f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = half * D + col16(m);
          float s = up[0] * sw[V_WU + col] + up[1] * sw[V_WU + D2 + col];
          s += up[2] * sw[V_WU + 2 * D2 + col];
          s += up[3] * sw[V_WU + 3 * D2 + col];
          xh[m] = sw[V_BU + col] + s;
          sum += stats16 ? bf16r(xh[m]) : xh[m];
        }
        const float mean = row_sum16(sum) * (1.0f / D);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          xh[m] -= mean;
          if (stats16)
            sq2 += bf16r(xh[m] * xh[m]);
          else
            sq2 = fmaf(xh[m], xh[m], sq2);
        }
        const float inv = 1.0f / sqrtf(row_sum16(sq2) * (1.0f / D) + LN_EPS);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = half * D + col16(m);
          xh[m] *= inv;
          sc[m] = sw[V_LN0S + col];
          dpre[m] = __bfloat162float(a0t[p * LA0 + col]) > 0.0f ? kvt[swz(p, col, D2)] : 0.0f;
        }
        ln_vjp<4, true>(dpre, xh, sc, inv, dh);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          sums[0][m] = i == 0 ? dpre[m] : sums[0][m] + dpre[m];
          sums[1][m] = i == 0 ? dpre[m] * xh[m] : sums[1][m] + dpre[m] * xh[m];
          sums[2][m] = i == 0 ? dh[m] : sums[2][m] + dh[m];
#pragma unroll
          for (int k = 0; k < 4; ++k) uh[k][m] = i == 0 ? up[k] * dh[m] : uh[k][m] + up[k] * dh[m];
        }
      }
      const int o = half * D;
      reduce_cols<3, 4>(vg, {V_LN0B + o, V_LN0S + o, V_BU + o}, sums, col16);
      reduce_cols<4, 4>(vg, {V_WU + o, V_WU + D2 + o, V_WU + 2 * D2 + o, V_WU + 3 * D2 + o}, uh,
                        col16);
    }
    cp_wait_all();  // the next chunk's inputs
    __syncthreads();

    const bool last = cp0 + P >= npairs;  // the group's last chunk
    if (last) {
      // dq, less S sum_j alpha_j k_j (K4's correction)
      for (int i = tid; i < RB * D; i += THREADS) {
        const int rl = i / D;
        if (rl < nrecv) dq[rbase * D + i] = sdq[i] - SCALE * sds[rl * H + (i % D) / HD] * sak[i];
        sdq[i] = sak[i] = 0.0f;
      }
      // the group's weight gradients into this block's slice, in the packed
      // layout (stored by its first group, added after)
      const bool first = grp == blockIdx.x;
      double* part = partial + static_cast<size_t>(blockIdx.x) * W_FLOATS;  // this block's slice
#pragma unroll
      for (int j = 0; j < 8; ++j)  // dz1 = [dz | dz]: both halves of w1
        put_tiles<1, 2>(part + OFF_W1, D2, {0, D}, gw1[0] + j, 16 * warp, 8 * j, 8, first);
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        put_tiles<2, 1>(part + OFF_WKV, D2, {0}, gkv[0] + j, wm, 64 * (warp >> 2) + 8 * j, 8,
                        first);
#pragma unroll
      for (int j = 0; j < 4; j += 2)
        put_tiles<2, 1>(part + OFF_WAGG, D, {0}, gagg[0] + j, wm, 32 * (warp >> 2) + 8 * j, 8,
                        first);
      // the warps' vector gradients, ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7))
      for (int i = tid; i < V_FLOATS; i += THREADS) {
        int second;
        const int at = packed_target(i, &second);
        const double old0 = first ? 0.0 : part[at];
        const double old1 = first || second < 0 ? 0.0 : part[second];
        float s[WARPS];
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
          s[k] = smem[L::S_VG + k * V_FLOATS + i];
          smem[L::S_VG + k * V_FLOATS + i] = 0.0f;
        }
#pragma unroll
        for (int d = 1; d < WARPS; d *= 2)
#pragma unroll
          for (int k = 0; k < WARPS; k += 2 * d) s[k] += s[k + d];
        part[at] = static_cast<double>(s[0]) + old0;
        if (second >= 0) part[second] = static_cast<double>(s[0]) + old1;
      }
      grp += gridDim.x;
      if (grp * RB >= R) break;
      __syncthreads();  // sds is read above and zeroed below
      gs ^= 1;
      rbase = grp * RB;
      nrecv = static_cast<int>(R - rbase < RB ? R - rbase : RB);
      npairs = nrecv * Ak;
      group_start<H>(sds, sdelta, groups_ring + gs * L::GROUP + L::G_G, out, rbase, nrecv);
    }
    cp0 = last ? 0 : cp0 + P;
    cs ^= 1;
  }
}

// K4b at H heads, then the sum of the blocks' slices, on the stream;
// returns cudaGetLastError()
template <int H>
int launch(const float* q, const float* u, const float* mask, const float* keep, const float* w,
           const float* g, const float* out, const float* stats, float* dq, float* dw,
           double* partial, long long R, int Ak, float keep_scale, int ln_mm, int grid,
           void* stream) {
  if (R <= 0 || Ak <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * Smem<H>::S_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(aa_fused_bwd_bf16_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  aa_fused_bwd_bf16_kernel<H><<<grid, THREADS, smem, s>>>(q, u, mask, keep, w, g, out, stats, dq,
                                                           partial, R, Ak, keep_scale, ln_mm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<(W_FLOATS + 255) / 256, 256, 0, s>>>(partial, grid, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points at the flagship's 8 heads (aa_fused_bwd_bf16_*) and the HiVT
// baseline's 4 (aa_fused_bwd_bf16_h4_*); aa_fused_bwd_weight_floats is the
// packed weights' size of the aa_fused_bwd interface, as aa_fused_bwd.cu's.
extern "C" {

int aa_fused_bwd_weight_floats() { return W_FLOATS; }

// receivers one block owns at a time (the wrapper sizes the grid with it)
int aa_fused_bwd_bf16_receivers_per_group() { return RB; }
int aa_fused_bwd_bf16_h4_receivers_per_group() { return RB; }

#ifdef AA_WRITE_LOGITS
// where the next launches write each pair's recomputed head logits, [R * Ak][H]
int aa_fused_bwd_bf16_set_logits(float* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_logits, &p, sizeof(p)));
}
#endif

// dq [R, 64] and dw [W_FLOATS] (packed like w), the VJP of K3b
// (aa_fused_bf16_launch) on the same inputs q [R, 64], u [R, Ak, 4],
// mask [R, Ak], keep [R, Ak, H] or NULL, w, with K3b's output out [R, 64]
// and statistics stats [2, R, H], for the cotangent g [R, 64].  keep_scale
// is 1 / (1 - p) with keep, else 1; ln_mm as K3b's.  partial is a
// [grid, W_FLOATS] f64 workspace.  H is 8 here and 4 in
// aa_fused_bwd_bf16_h4_launch.  Returns cudaGetLastError().
int aa_fused_bwd_bf16_launch(const float* q, const float* u, const float* mask,
                             const float* keep, const float* w, const float* g, const float* out,
                             const float* stats, float* dq, float* dw, double* partial,
                             long long R, int Ak, float keep_scale, int ln_mm, int grid,
                             void* stream) {
  return launch<8>(q, u, mask, keep, w, g, out, stats, dq, dw, partial, R, Ak, keep_scale, ln_mm,
                   grid, stream);
}

int aa_fused_bwd_bf16_h4_launch(const float* q, const float* u, const float* mask,
                                const float* keep, const float* w, const float* g,
                                const float* out, const float* stats, float* dq, float* dw,
                                double* partial, long long R, int Ak, float keep_scale,
                                int ln_mm, int grid, void* stream) {
  return launch<4>(q, u, mask, keep, w, g, out, stats, dq, dw, partial, R, Ak, keep_scale, ln_mm,
                   grid, stream);
}

}  // extern "C"
