#!/usr/bin/env python3
"""Least device time (bound) of each TPU kernel of the JAX package at the
shape the port's main paths give it, on an NVIDIA H100 SXM.

    python scripts/kernel_bounds_torch.py     # one JSON line per kernel; needs no GPU

bound = max(operations / 67 TFLOP/s f32, bytes / 3.35 TB/s HBM3): every
input read once and every output written once.  The operation counts
follow the kernels' arithmetic (``trajsde_tpu/ops/pallas/``):

* K1 ``sde_rollout`` / K2 ``_rollout_train_bwd``: the formulas of
  ``chip_smoke.py`` (``rollout_bound``, ``bwd_bound``) at 61,440 rows
  (bucket 128 x 10 modes x 48 actors) x 60 steps x 64.
* K3 ``aa_fused._fwd_call`` (``pair_chain``): ``chip_smoke.aa_fused_bound``,
  per (receiver, sender) pair the work the function needs
  (``aa_pair_ops``; the kernels multiply the zero blocks of the packed
  layout too).  Inputs q [B,T,Aq,D], u [B,T*Aq,Ak,4] and the f32 mask;
  output the [B,T,Aq,D] aggregate.
* K4 ``aa_fused._bwd_call``: ``chip_smoke.aa_fused_bwd_bound``, the
  forward recomputed, twice the matmul operations (input and weight
  gradients) and twice the elementwise ones; reads K3's inputs, the
  dropout keep mask [B,T,Aq,Ak,H] (training) and the cotangent, writes dq
  and the weight gradients.
* K5 ``aa_attention``: K3's chain plus the per-row q projection (2 D^2 per
  receiver); inputs u, the normed centres and the mask.
K3-K5 are taken at the serving bucket-128 shape: B = 128, T = 21,
Aq = 49 (48 actors and the focal agent's twin), Ak = 48, D = 64, H = 8;
K3 also at ``forward_ood``'s shape (Aq = Ak = 48).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (PEAK_BYTES_PER_S, PEAK_F32_FLOPS, aa_fused_bound,  # noqa: E402
                        aa_fused_bwd_bound, aa_pair_ops, aa_weight_floats, bwd_bound,
                        rollout_bound)

B, T, AQ, AK, D, H = 128, 21, 49, 48, 64, 8
ROWS, STEPS = 128 * 10 * 48, 60


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    pairs = B * T * AQ * AK
    rows_q = B * T * AQ
    mm, ew = aa_pair_ops(D, H)
    w = aa_weight_floats(D)
    report = []
    for name, (bound, by, flops, nbytes) in (
            ("K1 sde_rollout", rollout_bound(ROWS, STEPS, D, False)),
            ("K2 sde_rollout_bwd", bwd_bound(ROWS, STEPS, D, False))):
        report.append(dict(kernel=name, shape=f"{ROWS} rows x {STEPS} steps x {D}", flops=flops,
                           bytes=nbytes, bound_ms=bound, bound_by=by))
    for name, fn, (b, t, aq, ak), keep in (
            ("K3 aa_fused forward", aa_fused_bound, (B, T, AQ, AK), False),
            ("K3 aa_fused forward, forward_ood", aa_fused_bound, (B, T, AK, AK), False),
            ("K4 aa_fused backward (training, keep mask)", aa_fused_bwd_bound, (B, T, AQ, AK),
             True)):
        bound, by, flops, nbytes = fn(b, t, aq, ak, D, H, keep)
        report.append(dict(kernel=name, shape=f"B={b} T={t} Aq={aq} Ak={ak} D={D} H={H} "
                           f"({b * t * aq * ak} pairs)", flops=flops, bytes=nbytes,
                           bound_ms=bound, bound_by=by))
    k5_flops = pairs * (mm + ew) + rows_q * 2 * D * D
    k5_bytes = 4 * (pairs * 4 + rows_q * D + pairs + w + D * D + D + rows_q * D)
    bound, by = _bound(k5_flops, k5_bytes)
    report.append(dict(kernel="K5 aa_attention",
                       shape=f"B={B} T={T} Aq={AQ} Ak={AK} D={D} H={H} ({pairs} pairs)",
                       flops=k5_flops, bytes=k5_bytes, bound_ms=bound, bound_by=by))
    for row in report:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
