#!/usr/bin/env python3
"""Least device time (bound) of each TPU kernel of the JAX package at the
shape the port's main paths give it, on an NVIDIA H100 SXM.

    python scripts/kernel_bounds_torch.py     # one JSON line per kernel; needs no GPU

bound = max(operations / 67 TFLOP/s f32, bytes / 3.35 TB/s HBM3): every
input read once and every output written once (K6: see below).  The operation counts
follow the kernels' arithmetic (``trajsde_tpu/ops/pallas/``):

* K1 ``sde_rollout`` / K2 ``_rollout_train_bwd``: the formulas of
  ``chip_smoke.py`` (``rollout_bound``, ``bwd_bound``) at 61,440 rows
  (bucket 128 x 10 modes x 48 actors) x 60 steps x 64; both also on their
  route (``tensor_route_bound_ms``): K1's 5 products and K2's 14 on the
  tensor cores in 3xTF32, the rest on the CUDA cores, as K4's below.
* K3 ``aa_fused._fwd_call`` (``pair_chain``): ``chip_smoke.aa_fused_bound``,
  per (receiver, sender) pair the work the function needs
  (``aa_pair_ops``; the port's K3 folds w1's two column halves, so it
  multiplies none of the packed layout's zero blocks).  Inputs q
  [B,T,Aq,D], u [B,T*Aq,Ak,4] and the f32 mask; output the [B,T,Aq,D]
  aggregate.  Also ``tensor_route_bound_ms``: its three products (10 D^2
  a pair) on the tensor cores in 3xTF32, the rest on the CUDA cores.
  K3b, its bf16 form (``bf16=True``): the same function and bytes; on its
  route the three products at the bf16 tensor-core rate (989 TFLOP/s), the
  rest on the CUDA cores; at bucket 128 (8 heads), at the batch of
  ``FLAGSHIP_BF16_FUSED``'s train step (64) at the twin shape with a keep
  mask, and at the HiVT baseline's 4 heads and shape.
* K4 ``aa_fused._bwd_call``: ``chip_smoke.aa_fused_bwd_bound``, the
  forward recomputed, twice the matmul operations (input and weight
  gradients) and twice the elementwise ones; reads K3's inputs, the
  dropout keep mask [B,T,Aq,Ak,H] (training) and the cotangent, writes dq
  and the weight gradients.  Also ``tensor_route_bound_ms``, the bound on
  the route the port's kernel takes: its three recompute products and
  six backward products (30 D^2 a pair) on the tensor cores at f32
  accuracy (3 TF32 products each, 495 / 3 TFLOP/s), the rest at the f32
  peak on the CUDA cores, the two at the same time (and
  ``tensor_route_bound_by``).
  K4b, its bf16 form (``bf16=True``, the VJP of K3b): the same function
  and bytes; on its route the recompute's three products (10 D^2) at the
  bf16 tensor-core rate and the six backward products (20 D^2, an f32
  cotangent against a bf16 operand) at half the TF32 rate, two TF32
  products each; at the batch of ``FLAGSHIP_BF16_FUSED``'s train step (64)
  and at 128, and at the HiVT baseline's 4 heads and shape.
* K5 ``aa_attention``: ``chip_smoke.aa_attention_bound``, K3's chain plus
  the pair features' 14 operations per pair (the rotation of x_k and of
  pos_k - pos_q) and the q projection (2 D^2 + D per receiver); it reads
  what the function takes: the normed centres, x_k, pos_q, pos_k and rot
  in f32, the bool mask at 1 byte and the weights with wq / bq; it writes
  the aggregate.  Also ``tensor_route_bound_ms``: K3's three products on
  the tensor cores in 3xTF32, the rest on the CUDA cores, as K3's.
  K5b, its bf16 form (``compute_dtype="bfloat16"``): the same function and
  bytes; on its route the three products at the bf16 tensor-core rate
  (989 TFLOP/s), the rest on the CUDA cores.
* K6, the probe ``scripts/bench_vpu_dtype.py::run``:
  ``chip_smoke.vpu_probe_bound``, the longest of the multiply and add of
  each value and round at the f32 peak (twice it for packed bf16), the
  tanh's MUFU instructions (``chip_smoke.K6_MUFU``, read from the built
  library's SASS by ``scripts/vpu_probe_sass_torch.py``) at the
  special-function units' 16 a clock per SM, and the tile read and
  written once.  Every run of ``scripts/bench_vpu_dtype_torch.py``: the
  JAX probe's [2048, 128] tile and the [65536, 128] one.
K3-K5 (and K4b at 128) are taken at the serving bucket-128 shape: B = 128, T = 21,
Aq = 49 (48 actors and the focal agent's twin), Ak = 48, D = 64, H = 8;
K3 also at ``forward_ood``'s shape (Aq = Ak = 48), and K5 at the HiVT
baseline's 4 heads and shape (Aq = Ak = 48).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BF16_FUSED_BATCH, aa_attention_bound, aa_fused_bound,  # noqa: E402
                        aa_fused_bwd_bound, bwd_bound, rollout_bound, vpu_probe_bound)
from scripts.bench_vpu_dtype_torch import RUNS as PROBE_RUNS  # noqa: E402
from trajsde_tpu_torch.ops.vpu_probe import ROUNDS  # noqa: E402

B, T, AQ, AK, D, H = 128, 21, 49, 48, 64, 8
ROWS, STEPS = 128 * 10 * 48, 60


def main() -> None:
    report = []
    for name, (bound, by, flops, nbytes, *route) in (
            ("K1 sde_rollout", rollout_bound(ROWS, STEPS, D, False)),
            ("K2 sde_rollout_bwd", bwd_bound(ROWS, STEPS, D, False))):
        report.append(dict(kernel=name, shape=f"{ROWS} rows x {STEPS} steps x {D}", flops=flops,
                           bytes=nbytes, bound_ms=bound, bound_by=by))
        if route:
            report[-1].update(tensor_route_bound_ms=route[0], tensor_route_bound_by=route[1])
    k4b = "K4b aa_fused backward in bf16 (training, keep mask)"
    for name, fn, (b, t, aq, ak), keep, heads, bf16 in (
            ("K3 aa_fused forward", aa_fused_bound, (B, T, AQ, AK), False, H, False),
            ("K3 aa_fused forward, forward_ood", aa_fused_bound, (B, T, AK, AK), False, H, False),
            ("K3b aa_fused forward in bf16", aa_fused_bound, (B, T, AQ, AK), False, H, True),
            ("K3b aa_fused forward in bf16 (training, keep mask)", aa_fused_bound,
             (BF16_FUSED_BATCH, T, AQ, AK), True, H, True),
            ("K3b aa_fused forward in bf16, the HiVT baseline's 4 heads", aa_fused_bound,
             (B, T, AK, AK), False, 4, True),
            ("K4 aa_fused backward (training, keep mask)", aa_fused_bwd_bound, (B, T, AQ, AK),
             True, H, False),
            (k4b, aa_fused_bwd_bound, (BF16_FUSED_BATCH, T, AQ, AK), True, H, True),
            (k4b, aa_fused_bwd_bound, (B, T, AQ, AK), True, H, True),
            (f"{k4b}, the HiVT baseline's 4 heads", aa_fused_bwd_bound,
             (BF16_FUSED_BATCH, T, AK, AK), True, 4, True),
            (f"{k4b}, the HiVT baseline's 4 heads", aa_fused_bwd_bound, (B, T, AK, AK), True, 4,
             True)):
        bound, by, flops, nbytes, *route = fn(b, t, aq, ak, D, heads, keep, bf16)
        report.append(dict(kernel=name, shape=f"B={b} T={t} Aq={aq} Ak={ak} D={D} H={heads} "
                           f"({b * t * aq * ak} pairs)", flops=flops, bytes=nbytes,
                           bound_ms=bound, bound_by=by))
        if route:
            report[-1].update(tensor_route_bound_ms=route[0], tensor_route_bound_by=route[1])
    for name, (aq, heads), bf16 in (
            ("K5 aa_attention", (AQ, H), False),
            ("K5 aa_attention, the HiVT baseline's 4 heads", (AK, 4), False),
            ("K5b aa_attention in bf16", (AQ, H), True),
            ("K5b aa_attention in bf16, the HiVT baseline's 4 heads", (AK, 4), True)):
        bound, by, flops, nbytes, route, route_by = aa_attention_bound(B, T, aq, AK, D, heads,
                                                                       bf16)
        report.append(dict(kernel=name, shape=f"B={B} T={T} Aq={aq} Ak={AK} D={D} H={heads} "
                           f"({B * T * aq * AK} pairs)", flops=flops, bytes=nbytes,
                           bound_ms=bound, bound_by=by, tensor_route_bound_ms=route,
                           tensor_route_bound_by=route_by))
    for variant, rows in PROBE_RUNS:
        bound, by, flops, nbytes = vpu_probe_bound(rows * 128, ROUNDS, variant)
        report.append(dict(kernel=f"K6 vpu probe, {variant}",
                           shape=f"[{rows}, 128] x {ROUNDS} rounds", flops=flops,
                           bytes=nbytes, bound_ms=bound, bound_by=by))
    for row in report:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
