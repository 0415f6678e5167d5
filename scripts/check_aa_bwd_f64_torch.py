#!/usr/bin/env python3
"""K4's gradients against an f64 oracle on the card.

    python scripts/check_aa_bwd_f64_torch.py [--batch 128] [--heads 8|4]

At the flagship's training twin shape (B x 21 steps x 49 receivers x 48
senders, D 64, H 8), or with ``--heads 4`` at the HiVT baseline's (B x 21
x 48 x 48, H 4), with a dropout keep mask (p = 0.1), for the model's
packed AA weights and for random ones with the w1 blocks off the diagonal
filled in,
it runs the fused AA backward three ways on the same inputs and cotangent:
kernel K4 (``fused_pair_attention_bwd``), the f32 plain version (autograd
through the plain chain, ``fused_pair_attention_bwd_reference``) and the
same plain version in f64, the oracle.  The oracle runs 16 scenes at a
time (its autograd tape for all 128 scenes would not fit 80 GB) and
sums the chunks' weight gradients in f64, so it is the f64 gradient at the
whole shape.  Per gradient leaf (dq and the 14 packed weights) it prints
``max|K4 - f64| / max|f64|`` and the same for the f32 plain version, then
one JSON line with every number, whether K4 is within 2x of the f32
plain version's distance on every leaf, and whether it meets the
criterion of ``tests/test_torch_cuda.py``'s f64 test, which holds the
leaves behind a ReLU's derivative within 2e-3 and the others within 2x
of the plain distance plus 1e-7.

It also counts the (pair, column) elements whose value before one of the
chain's two ReLUs (after the first LayerNorms, a0, and after the second,
a1) has one sign in the f32 plain forward and the other in f64.  There the
gradient jumps: the leaves behind a ReLU's derivative (wu, bu, ln0s, ln0b,
w1, b1, lna0s, lna0b) take that element's whole contribution on one side
and none on the other, whatever the summation.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (K3_DROPOUT, NUM_ACTORS, SEED, TRAIN_BATCH,  # noqa: E402
                        _k3_inputs, _random_aa_weights)
from trajsde_tpu_torch.config import BASELINE_TRAIN, FLAGSHIP_TRAIN_FUSED, build_model  # noqa: E402
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402

CHUNK = 16  # scenes per f64 pass


def rel(a: torch.Tensor, oracle: torch.Tensor) -> float:
    return ((a.double() - oracle).abs().max() / oracle.abs().max().clamp_min(1e-300)).item()


def f64_oracle(q, u, mask, keep, ws, g, heads, p, chunk):
    """(dq, dws) of the plain chain in f64, ``chunk`` scenes at a time."""
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dws = [torch.zeros(w.shape, dtype=torch.float64, device=w.device) for w in ws]
    w64 = [w.double() for w in ws]
    for b0 in range(0, q.shape[0], chunk):
        s = slice(b0, b0 + chunk)
        cdq, cdws = K3.fused_pair_attention_bwd_reference(
            q[s].double(), u[s].double(), mask[s].double(), keep[s].double(), w64, g[s].double(),
            heads, p)
        dq[s] = cdq
        for acc, d in zip(dws, cdws):
            acc += d
        del cdq, cdws
        torch.cuda.empty_cache()
    return dq, dws


def relu_flips(u, ws, chunk):
    """Elements whose pre-ReLU value (a0, a1) has another sign in the f32
    plain forward than in f64, counted ``chunk`` scenes at a time; the
    plain chain's own operations, in its order."""
    D = K3.KERNEL_DIM
    flips = {"a0": 0, "a1": 0}
    for b0 in range(0, u.shape[0], chunk):
        pre = {}
        for dtype in (torch.float32, torch.float64):
            wu, bu, ln0s, ln0b, w1, b1, lna0s, lna0b = (w.to(dtype) for w in ws[:8])
            uf = u[b0:b0 + chunk].reshape(-1, 4).to(dtype)
            h = bu[0] + sum(uf[:, k:k + 1] * wu[k:k + 1, :] for k in range(4))
            p0 = torch.cat([K3._ln(h[:, :D], ln0s[0, :D], ln0b[0, :D]),
                            K3._ln(h[:, D:], ln0s[0, D:], ln0b[0, D:])], dim=-1)
            z1 = torch.relu(p0) @ w1 + b1[0]
            p1 = K3._ln(z1[:, :D] + z1[:, D:], lna0s[0], lna0b[0])
            pre[dtype] = (p0 > 0, p1 > 0)
            del h, p0, z1, p1
        for name, a, b in zip(("a0", "a1"), pre[torch.float32], pre[torch.float64]):
            flips[name] += int((a != b).sum().item())
        del pre
        torch.cuda.empty_cache()
    return flips


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=TRAIN_BATCH)
    ap.add_argument("--heads", type=int, choices=K3.KERNEL_HEAD_COUNTS, default=K3.KERNEL_HEADS,
                    help="the flagship's 8 heads and twin shape, or the baseline's 4 and shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the check runs K4 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    H = args.heads
    model = build_model(FLAGSHIP_TRAIN_FUSED if H == 8 else BASELINE_TRAIN, device="cuda",
                        seed=SEED)
    Th = model.encoder.historical_steps
    model_ws = tuple(w.contiguous() for w in
                     K3.weights_of(K3.pack_aa_params(model.encoder.aa_encoder)))
    del model
    Aq = NUM_ACTORS + 1 if H == 8 else NUM_ACTORS  # the flagship's twin row
    shape = (args.batch, Th, Aq, NUM_ACTORS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    weights = {"model": model_ws, "random": _random_aa_weights(gen, model_ws)}
    cases = {}
    for wname, ws in weights.items():
        q, u, mask, keep = _k3_inputs(shape, True, gen, H)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, K3_DROPOUT)
        k4 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, K3_DROPOUT, out=out,
                                         stats=stats)
        del out, stats
        plain = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, K3_DROPOUT)
        torch.cuda.empty_cache()
        oracle = f64_oracle(q, u, mask, keep, ws, g, H, K3_DROPOUT, CHUNK)
        leaves = {}
        for name, a, b, o in zip(("dq", *K3.W_ORDER), (k4[0], *k4[1]), (plain[0], *plain[1]),
                                 (oracle[0], *oracle[1])):
            leaves[name] = dict(k4=rel(a, o), plain=rel(b, o), k4_vs_plain=rel(a, b.double()))
            print(f"[f64] {wname} weights {name:6s}: max|K4 - f64| / max|f64| "
                  f"{leaves[name]['k4']:.3e}, f32 plain {leaves[name]['plain']:.3e}, "
                  f"K4 vs plain {leaves[name]['k4_vs_plain']:.3e}", flush=True)
        flips = relu_flips(u, ws, CHUNK)
        print(f"[f64] {wname} weights: pre-ReLU elements with another sign in f32 than in f64: "
              f"a0 {flips['a0']}, a1 {flips['a1']}", flush=True)
        cases[wname] = dict(leaves=leaves, relu_flips=flips)
        del q, u, mask, keep, g, k4, plain, oracle
        torch.cuda.empty_cache()
    within = all(v["k4"] <= 2.0 * v["plain"] for case in cases.values()
                 for v in case["leaves"].values())
    behind_relu = K3.W_ORDER[:K3.W_ORDER.index("wagg")]
    criterion = all(v["k4"] < 2e-3 if name in behind_relu else v["k4"] <= 2.0 * v["plain"] + 1e-7
                    for case in cases.values() for name, v in case["leaves"].items())
    print(json.dumps({"card": card, "heads": H, "shape": list(shape), "keep_p": K3_DROPOUT,
                      "oracle_chunk": CHUNK, "cases": cases,
                      "k4_within_2x_of_f32_plain": within,
                      "k4_within_the_gpu_test_criterion": criterion}), flush=True)


if __name__ == "__main__":
    main()
