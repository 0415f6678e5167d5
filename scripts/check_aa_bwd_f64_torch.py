#!/usr/bin/env python3
"""K4's gradients against an f64 oracle on the card.

    python scripts/check_aa_bwd_f64_torch.py [--batch 128 [64 ...]] [--heads 8|4]

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
of the plain distance plus 1e-7.  Beside K4's ratio to the plain distance
it gives the ratio to the plain distance floored at its median over the
15 leaves (the criterion that closed K2's Q3-1), and whether K4 is within
2x of that on every leaf.

It also counts the (pair, column) elements whose value before one of the
chain's two ReLUs (after the first LayerNorms, a0, and after the second,
a1) has one sign in f32 and the other in f64: in the f32 plain forward,
and in K4's recompute, read from a check copy of K3 built with
``AA_WRITE_PRERELU`` (K4 recomputes the chain through K3's products and
epilogues, bit for bit, so these values are K4's; the copy's output must
be K3's bits).  There the gradient jumps: the leaves behind a ReLU's
derivative (wu, bu, ln0s, ln0b, w1, b1, lna0s, lna0b) take that element's
whole contribution on one side and none on the other, whatever the
summation.  So it also holds each f32 run against the f64 gradient taken
on that run's own ReLU signs (:class:`ReluPattern`): what is left is
rounding alone, and the same ratios (plain and floored) are given for it.
Each batch of ``--batch`` is a draw of its own, made from the same seed as
a run with that batch alone.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (K3_DROPOUT, NUM_ACTORS, SEED, TRAIN_BATCH,  # noqa: E402
                        _k3_inputs, _random_aa_weights)
from trajsde_tpu_torch.config import BASELINE_TRAIN, FLAGSHIP_TRAIN_FUSED, build_model  # noqa: E402
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

CHUNK = 16  # scenes per f64 pass


def rel(a: torch.Tensor, oracle: torch.Tensor) -> float:
    return ((a.double() - oracle).abs().max() / oracle.abs().max().clamp_min(1e-300)).item()


class ReluPattern:
    """Stands in for ``torch.relu`` in one pass of the plain chain: its two
    calls (a0's, then a1's) give x times the 0/1 pattern ``m0``
    ([pairs, 2 D]), then ``m1`` ([pairs, D]), so the pass's gradient
    follows those signs, whatever the pass's own pre-ReLU values are."""

    def __init__(self, m0: torch.Tensor, m1: torch.Tensor):
        self.masks = [m0, m1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.masks.pop(0)
        if x.shape != m.shape:
            raise RuntimeError(f"a ReLU of shape {tuple(x.shape)}, pattern {tuple(m.shape)}")
        return x * m


def f64_oracle(q, u, mask, keep, ws, g, heads, p, chunk, pattern=None):
    """(dq, dws) of the plain chain in f64, ``chunk`` scenes at a time; with
    ``pattern(b0, b1)`` -> (m0, m1), its ReLUs follow those signs for the
    scenes b0 .. b1 (see :class:`ReluPattern`)."""
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dws = [torch.zeros(w.shape, dtype=torch.float64, device=w.device) for w in ws]
    w64 = [w.double() for w in ws]
    for b0 in range(0, q.shape[0], chunk):
        s = slice(b0, b0 + chunk)
        relu = torch.relu if pattern is None else ReluPattern(*pattern(b0, b0 + chunk))
        with mock.patch.object(torch, "relu", relu):
            cdq, cdws = K3.fused_pair_attention_bwd_reference(
                q[s].double(), u[s].double(), mask[s].double(), keep[s].double(), w64,
                g[s].double(), heads, p)
        dq[s] = cdq
        for acc, d in zip(dws, cdws):
            acc += d
        del cdq, cdws
        torch.cuda.empty_cache()
    return dq, dws


def plain_prerelu(u, ws, dtype):
    """a0 and a1 before their ReLUs in the plain chain's own operations, in
    ``dtype``, for the pairs of ``u``: ([pairs, 2 D], [pairs, D])."""
    D = K3.KERNEL_DIM
    wu, bu, ln0s, ln0b, w1, b1, lna0s, lna0b = (w.to(dtype) for w in ws[:8])
    uf = u.reshape(-1, 4).to(dtype)
    h = bu[0] + sum(uf[:, k:k + 1] * wu[k:k + 1, :] for k in range(4))
    p0 = torch.cat([K3._ln(h[:, :D], ln0s[0, :D], ln0b[0, :D]),
                    K3._ln(h[:, D:], ln0s[0, D:], ln0b[0, D:])], dim=-1)
    z1 = torch.relu(p0) @ w1 + b1[0]
    return p0, K3._ln(z1[:, :D] + z1[:, D:], lna0s[0], lna0b[0])


def prerelu_copy():
    """K3 built with ``AA_WRITE_PRERELU`` under the build directory's
    ``prerelu/``, configured, with ``aa_fused_set_prerelu`` declared."""
    out_dir = os.path.join(build.BUILD_DIR, "prerelu")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "aa_fused.cu")
    with open(os.path.join(build.CSRC_DIR, "aa_fused.cu")) as f:
        text = f.read()
    with open(cu, "w") as f:
        f.write("#define AA_WRITE_PRERELU\n" + text)
    lib = K3.configure_fwd(build.build_copies({"aa_fused_prerelu": cu}, out_dir)
                           ["aa_fused_prerelu"][0])
    lib.aa_fused_set_prerelu.argtypes = [ctypes.c_void_p]
    return lib


def k4_prerelu(lib, q, u, mask, keep, ws, heads, p, out):
    """Every pair's a0 and a1 before their ReLUs as K4's recompute has them
    (K3's, from the check copy), [pairs, 3 D]; the copy's output must be
    ``out``, the shipped K3's, bit for bit."""
    pairs = q.shape[0] * q.shape[1] * q.shape[2] * u.shape[3]
    pre = torch.full((pairs, 3 * K3.KERNEL_DIM), float("nan"), device=q.device)
    if lib.aa_fused_set_prerelu(pre.data_ptr()) != 0:
        raise RuntimeError("aa_fused_set_prerelu failed")
    got, _ = K3.launch_fwd(lib, q, u, mask, keep, ws, heads, p, with_stats=True)
    torch.cuda.synchronize()
    if not torch.equal(got, out):
        raise RuntimeError("the AA_WRITE_PRERELU copy of K3 gave another output than K3")
    if bool(torch.isnan(pre).any()):
        raise RuntimeError("a pair's pre-ReLU values were not written")
    return pre


def relu_flips(u, ws, chunk, kernel_pre):
    """Elements whose pre-ReLU value (a0, a1) has another sign than in f64,
    counted ``chunk`` scenes at a time: in the f32 plain forward (the plain
    chain's own operations, in its order) and in ``kernel_pre`` (K4's,
    [pairs, 3 D])."""
    D = K3.KERNEL_DIM
    flips = {"plain": {"a0": 0, "a1": 0}, "k4": {"a0": 0, "a1": 0}}
    per_scene = u.shape[1] * u.shape[2] * u.shape[3]
    for b0 in range(0, u.shape[0], chunk):
        exact = [x > 0 for x in plain_prerelu(u[b0:b0 + chunk], ws, torch.float64)]
        plain = [x > 0 for x in plain_prerelu(u[b0:b0 + chunk], ws, torch.float32)]
        rows = kernel_pre[b0 * per_scene:(b0 + chunk) * per_scene]
        k4 = (rows[:, :2 * D] > 0, rows[:, 2 * D:] > 0)
        for run, got in (("plain", plain), ("k4", k4)):
            for name, a, b in zip(("a0", "a1"), got, exact):
                flips[run][name] += int((a != b).sum().item())
        del exact, plain, rows, k4
        torch.cuda.empty_cache()
    return flips


def check(card: str, H: int, batch: int, model_ws, Th: int, prerelu) -> dict:
    """One draw at ``batch``: both weight cases; returns the JSON line's
    fields."""
    D = K3.KERNEL_DIM
    Aq = NUM_ACTORS + 1 if H == 8 else NUM_ACTORS  # the flagship's twin row
    shape = (batch, Th, Aq, NUM_ACTORS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    weights = {"model": model_ws, "random": _random_aa_weights(gen, model_ws)}
    cases = {}
    for wname, ws in weights.items():
        q, u, mask, keep = _k3_inputs(shape, True, gen, H)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, K3_DROPOUT)
        k4 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, K3_DROPOUT, out=out,
                                         stats=stats)
        del stats
        plain = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, K3_DROPOUT)
        torch.cuda.empty_cache()
        oracle = f64_oracle(q, u, mask, keep, ws, g, H, K3_DROPOUT, CHUNK)
        pre = k4_prerelu(prerelu, q, u, mask, keep, ws, H, K3_DROPOUT, out)
        flips = relu_flips(u, ws, CHUNK, pre)
        per_scene = u.shape[1] * u.shape[2] * u.shape[3]

        def k4_pattern(b0, b1):
            rows = pre[b0 * per_scene:b1 * per_scene]
            return (rows[:, :2 * D] > 0).double(), (rows[:, 2 * D:] > 0).double()

        def plain_pattern(b0, b1):
            return tuple((x > 0).double() for x in plain_prerelu(u[b0:b1], ws, torch.float32))

        # the f64 gradient on each f32 run's own ReLU signs: only rounding is left
        own = {"k4": f64_oracle(q, u, mask, keep, ws, g, H, K3_DROPOUT, CHUNK, k4_pattern),
               "plain": f64_oracle(q, u, mask, keep, ws, g, H, K3_DROPOUT, CHUNK, plain_pattern)}
        leaves = {}
        for i, name in enumerate(("dq", *K3.W_ORDER)):
            a, b = (k4[0], *k4[1])[i], (plain[0], *plain[1])[i]
            o, ok4, oplain = ((x[0], *x[1])[i] for x in (oracle, own["k4"], own["plain"]))
            leaves[name] = dict(k4=rel(a, o), plain=rel(b, o), k4_vs_plain=rel(a, b.double()),
                                k4_own=rel(a, ok4), plain_own=rel(b, oplain))
        floor = statistics.median(v["plain"] for v in leaves.values())
        floor_own = statistics.median(v["plain_own"] for v in leaves.values())
        for name, v in leaves.items():
            v["k4_over_plain"] = v["k4"] / v["plain"]
            v["k4_over_floored_plain"] = v["k4"] / max(v["plain"], floor)
            v["k4_over_plain_own"] = v["k4_own"] / v["plain_own"]
            v["k4_over_floored_plain_own"] = v["k4_own"] / max(v["plain_own"], floor_own)
            print(f"[f64] {H} heads, batch {batch}, {wname} weights {name:6s}: max|K4 - f64| / "
                  f"max|f64| {v['k4']:.3e}, f32 plain {v['plain']:.3e}, K4 vs plain "
                  f"{v['k4_vs_plain']:.3e}; K4 / plain {v['k4_over_plain']:.2f}, floored at the "
                  f"median {floor:.3e}: {v['k4_over_floored_plain']:.2f}; on each run's own ReLU "
                  f"signs K4 {v['k4_own']:.3e}, plain {v['plain_own']:.3e}, K4 / plain "
                  f"{v['k4_over_plain_own']:.2f}, floored at {floor_own:.3e}: "
                  f"{v['k4_over_floored_plain_own']:.2f}", flush=True)
        print(f"[f64] {H} heads, batch {batch}, {wname} weights: pre-ReLU elements with another "
              f"sign than in f64: f32 plain a0 {flips['plain']['a0']}, a1 {flips['plain']['a1']}; "
              f"K4 a0 {flips['k4']['a0']}, a1 {flips['k4']['a1']}", flush=True)
        del k4, plain, oracle, own
        cases[wname] = dict(leaves=leaves, plain_median=floor, plain_own_median=floor_own,
                            relu_flips=flips)
        del q, u, mask, keep, g, out, pre
        torch.cuda.empty_cache()

    def everywhere(key):
        return all(v[key] <= 2.0 for case in cases.values() for v in case["leaves"].values())

    within, floored = everywhere("k4_over_plain"), everywhere("k4_over_floored_plain")
    behind_relu = K3.W_ORDER[:K3.W_ORDER.index("wagg")]
    criterion = all(v["k4"] < 2e-3 if name in behind_relu else v["k4"] <= 2.0 * v["plain"] + 1e-7
                    for case in cases.values() for name, v in case["leaves"].items())
    return {"card": card, "heads": H, "shape": list(shape), "keep_p": K3_DROPOUT,
            "oracle_chunk": CHUNK, "cases": cases, "k4_within_2x_of_f32_plain": within,
            "k4_within_2x_of_f32_plain_floored_at_its_median": floored,
            "k4_within_2x_on_own_relu_signs": everywhere("k4_over_plain_own"),
            "k4_within_2x_on_own_relu_signs_floored": everywhere("k4_over_floored_plain_own"),
            "k4_within_the_gpu_test_criterion": criterion}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[TRAIN_BATCH])
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
    prerelu = prerelu_copy()
    for batch in args.batch:
        print(json.dumps(check(card, H, batch, model_ws, Th, prerelu)), flush=True)


if __name__ == "__main__":
    main()
