#!/usr/bin/env python3
"""K2's gradients against an f64 oracle on the card.

    python scripts/check_rollout_bwd_f64_torch.py [--base NAME=PATH ...]

At the training shape (61,440 rows x 60 steps x 64: batch 128 x 10 modes x
48 actors), with a random cotangent, it runs the rollout's reverse sweep
three ways on the same inputs: kernel K2 (``sde_rollout_bwd``), the f32
plain version (``sde_rollout_bwd_reference``) and the same plain version in
f64, the oracle (its inputs are the f32 ones, widened; its increments the
same f32 draws).  Three cases: the flagship decoder's rollout weights with
regenerated gaussian increments and with explicit ones, and random weights
(the flagship's, each matrix redrawn N(0, 0.3^2) as the CPU tests draw
them) with gaussian increments.  Per gradient leaf (dy0 and the 14 packed
weights) it prints ``max|K2 - f64| / max|f64|`` and the same for the f32
plain version, then one JSON line with every number and whether K2 is
within 2x of the f32 plain version's distance on every leaf, within 2x
of it floored at the median of the plain distances over the 15 leaves (the
criterion of ``tests/test_torch_sde_rollout_tf32.py``), and within 4x of
it so floored (the bar of ``tests/test_torch_cuda.py::
test_rollout_bwd_kernel_within_the_f64_gradient``), with K2's worst ratio
to the plain distance, as it is and floored.  Each ``--base``
(another version of ``csrc/sde_rollout_bwd.cu``, built as
``scripts/compare_rollout_bwd_builds_torch.py`` builds it) is held to f64
beside K2 on the same inputs, with its worst ratio to 2x the plain
distance, as it is and floored.  The verdicts are printed; the exit code
is 0 once the check has run.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import SEED, train_rows  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402
from trajsde_tpu_torch.config import FLAGSHIP_TRAIN, build_model  # noqa: E402
from trajsde_tpu_torch.ops import sde_rollout as K1  # noqa: E402


def rel(a: torch.Tensor, oracle: torch.Tensor) -> float:
    return ((a.double() - oracle).abs().max() / oracle.abs().max().clamp_min(1e-300)).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", default=[], metavar="NAME=PATH",
                    help="another version of csrc/sde_rollout_bwd.cu and its name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the check runs K2 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sources = dict(b.split("=", 1) for b in args.base)
    bases = {name: K1.configure_bwd(lib) for name, (lib, _) in build.build_copies(
        sources, os.path.join(build.BUILD_DIR, "f64_bases")).items()}

    model = build_model(FLAGSHIP_TRAIN, device="cuda", seed=SEED)
    dec = model.decoder
    T, D, rows = dec.future_steps, dec.local_channels, train_rows(model)
    model_p = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    t0s, dts = dec.time_grid(device="cuda")
    del model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    random_p = {k: (0.3 * torch.randn(v.shape, generator=gen, device="cuda")
                    if v.shape == (D, D) else v) for k, v in model_p.items()}
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    ct = torch.randn((T, rows, D), generator=gen, device="cuda")
    noise = torch.randn((T, rows, D), generator=gen, device="cuda")
    cases, ok, ok_floored, ok4 = {}, True, True, True
    for cname, p, nz, inc in (("model gaussian", model_p, None, "gaussian"),
                              ("model explicit", model_p, noise, "gaussian"),
                              ("random gaussian", random_p, None, "gaussian")):
        w = K1.pack_params(p)
        ys = K1.sde_rollout_packed(y0, w, t0s, dts, 13, T, nz, inc)
        k2_dy0, k2_dw = K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 13, T, nz, inc)
        k2 = {"dy0": k2_dy0, **K1.unpack_params(k2_dw, D)}
        p_dy0, p_g = K1.sde_rollout_bwd_reference(y0, ys, ct, p, t0s, dts, 13, T, nz, inc)
        plain = {"dy0": p_dy0, **p_g}
        o_dy0, o_g = K1.sde_rollout_bwd_reference(
            y0.double(), ys.double(), ct.double(), {k: v.double() for k, v in p.items()}, t0s,
            dts, 13, T, None if nz is None else nz.double(), inc)
        oracle = {"dy0": o_dy0, **o_g}
        others = {}
        for bname, lib in bases.items():
            b_dy0, b_dw = K1.launch_bwd(lib, y0, ys, ct, w, t0s, dts, 13, T, nz, inc)
            others[bname] = {"dy0": b_dy0, **K1.unpack_params(b_dw, D)}
        leaves = {}
        for name in ("dy0", *K1.PARAM_ORDER):
            leaves[name] = dict(k2=rel(k2[name], oracle[name]),
                                plain=rel(plain[name], oracle[name]),
                                k2_vs_plain=rel(k2[name], plain[name].double()),
                                **{b: rel(o[name], oracle[name]) for b, o in others.items()})
            print(f"[f64] {cname} {name:5s}: max|K2 - f64| / max|f64| "
                  f"{leaves[name]['k2']:.3e}, f32 plain {leaves[name]['plain']:.3e}, "
                  f"K2 vs plain {leaves[name]['k2_vs_plain']:.3e}"
                  + "".join(f", {b} {leaves[name][b]:.3e}" for b in others), flush=True)
        median = statistics.median(v["plain"] for v in leaves.values())
        within = all(v["k2"] <= 2.0 * v["plain"] for v in leaves.values())
        floored = all(v["k2"] <= 2.0 * max(v["plain"], median) for v in leaves.values())
        floored4 = all(v["k2"] <= 4.0 * max(v["plain"], median) for v in leaves.values())
        worst = {b: max(v[b] / max(v["plain"], median) for v in leaves.values())
                 for b in ("k2", *others)}
        print(f"[f64] {cname}: within 2x of plain on every leaf {within}; floored at the "
              f"median plain distance {median:.3e}: 2x {floored}, 4x {floored4}; K2 at most "
              f"{max(v['k2'] / v['plain'] for v in leaves.values()):.2f}x plain, "
              f"{worst['k2']:.2f}x floored", flush=True)
        for b in others:
            print(f"[f64] {cname}: {b} worst ratio to 2x plain "
                  f"{max(v[b] / (2.0 * v['plain']) for v in leaves.values()):.2f}, floored "
                  f"{max(v[b] / (2.0 * max(v['plain'], median)) for v in leaves.values()):.2f}",
                  flush=True)
        cases[cname] = dict(leaves=leaves, median_plain=median, within_2x=within,
                            within_2x_floored=floored, within_4x_floored=floored4,
                            worst_ratio_floored=worst)
        ok, ok_floored = ok and within, ok_floored and floored
        ok4 = ok4 and floored4
        del ys, k2, k2_dy0, k2_dw, plain, others, p_dy0, p_g, oracle, o_dy0, o_g
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows, "steps": T, "cases": cases,
                      "k2_within_2x_of_f32_plain": ok,
                      "k2_within_2x_of_f32_plain_floored": ok_floored,
                      "k2_within_4x_of_f32_plain_floored": ok4}), flush=True)


if __name__ == "__main__":
    main()
