#!/usr/bin/env python3
"""How K2's distance from an f64 oracle depends on the forward states it is
given (needs a card and nvcc).

    python scripts/check_rollout_bwd_f64_inputs_torch.py [--k1-base NAME=PATH ...] \
        [--k2-base NAME=PATH ...] [--seeds 21 22 23]

``tests/test_torch_cuda.py::test_rollout_bwd_kernel_within_the_f64_gradient``
holds K2 (``sde_rollout_bwd``) to the f64 plain backward at 2,048 rows x 60
steps with gaussian increments, with weights, y0 and the cotangent drawn
from seed 21, and the forward states ``ys`` that K2 reads made by K1.  K2,
the f32 plain backward and the f64 oracle all read the same ``ys``, so
``ys`` is only their input.  This script repeats that test's inputs and
check for each seed and each source of ``ys``: this tree's K1, each
``--k1-base`` (another version of ``csrc/sde_rollout.cu``, built as
``scripts/compare_rollout_fwd_builds_torch.py`` builds it) and the f32
plain forward (``sde_rollout_reference``), and for each source this tree's
K2 (``k2``) and each ``--k2-base`` (another version of
``csrc/sde_rollout_bwd.cu``, built where it lies, so headers beside it come
first, then this tree's).  Per case it prints every leaf's ratio of the K2
build's distance to the plain version's, floored at the median of the
plain distances over the 15 leaves (the test's measure; its bar is 4), the
worst leaf, and one JSON line with every number.  The exit code is 0 once
the check has run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.compare_rollout_fwd_builds_torch import configure, launch  # noqa: E402
from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402
from trajsde_tpu_torch.ops import sde_rollout as K  # noqa: E402

ROWS, STEPS, BAR = 2048, 60, 4.0


def rel(a: torch.Tensor, oracle: torch.Tensor) -> float:
    return ((a.double() - oracle).abs().max() / oracle.abs().max()).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-base", action="append", default=[], metavar="NAME=PATH",
                    help="another version of csrc/sde_rollout.cu and its name")
    ap.add_argument("--k2-base", action="append", default=[], metavar="NAME=PATH",
                    help="another version of csrc/sde_rollout_bwd.cu and its name")
    ap.add_argument("--seeds", type=int, nargs="+", default=[21, 22, 23])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the check runs K1 and K2 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    bases = dict(b.split("=", 1) for b in args.k1_base)
    libs = {name: configure(lib) for name, (lib, _) in build.build_copies(
        bases, os.path.join(build.BUILD_DIR, "check_rollout_inputs")).items()}
    k2_libs = {"k2": None}
    k2_libs.update({name: K.configure_bwd(lib) for name, (lib, _) in build.build_copies(
        dict(b.split("=", 1) for b in args.k2_base),
        os.path.join(build.BUILD_DIR, "check_rollout_inputs_k2")).items()})
    cuda = torch.device("cuda")
    report = []
    for seed in args.seeds:
        # the inputs of test_rollout_bwd_kernel_within_the_f64_gradient
        gen = torch.Generator().manual_seed(seed)
        step = SDEStep(64)
        for p in step.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.2
        kp = {k: v.contiguous().to(cuda) for k, v in K.rollout_params_from_module(step).items()}
        w = K.pack_params(kp)
        t0s, dts = decoder_time_grid(STEPS, 6.0, device=cuda)
        y0 = torch.randn((ROWS, 64), generator=gen).to(cuda)
        ct = torch.randn((STEPS, ROWS, 64), generator=gen).to(cuda)
        sources = {"k1": K.sde_rollout_packed(y0, w, t0s, dts, 42, STEPS, None, "gaussian")}
        for name, lib in libs.items():
            sources[name] = launch(lib, y0, w, K.time_table(t0s, dts), 42, STEPS, None,
                                   K.INCREMENTS["gaussian"])
        sources["plain"] = K.sde_rollout_reference(y0, kp, t0s, dts, 42, STEPS)
        for source, ys in sources.items():
            p_dy0, p_g = K.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 42, STEPS)
            o_dy0, o_g = K.sde_rollout_bwd_reference(
                y0.double(), ys.double(), ct.double(), {k: v.double() for k, v in kp.items()},
                t0s, dts, 42, STEPS)
            plain, oracle = {"dy0": p_dy0, **p_g}, {"dy0": o_dy0, **o_g}
            for k2, lib in k2_libs.items():
                if lib is None:
                    dy0, dw = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 42, STEPS)
                else:
                    dy0, dw = K.launch_bwd(lib, y0, ys, ct, w, t0s, dts, 42, STEPS, None,
                                           "gaussian")
                got = {"dy0": dy0, **K.unpack_params(dw, 64)}
                errs = {k: (rel(got[k], oracle[k]), rel(plain[k], oracle[k])) for k in oracle}
                median = sorted(p for _, p in errs.values())[len(errs) // 2]
                ratios = {k: v / max(p, median) for k, (v, p) in errs.items()}
                worst = max(ratios, key=ratios.get)
                report.append(dict(seed=seed, ys=source, k2=k2, worst=worst,
                                   worst_ratio=ratios[worst], within_bar=ratios[worst] <= BAR,
                                   ratios=ratios, errs=errs))
                print(f"[check] {card}: seed {seed}, ys from {source}, {k2}: worst {worst} "
                      f"{ratios[worst]:.2f}x (bar {BAR:g}); "
                      + " ".join(f"{k} {v:.2f}" for k, v in ratios.items()), flush=True)
    print(json.dumps({"card": card, "rows": ROWS, "steps": STEPS, "bar": BAR,
                      "cases": report}), flush=True)


if __name__ == "__main__":
    main()
