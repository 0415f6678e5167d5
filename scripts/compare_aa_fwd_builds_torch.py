#!/usr/bin/env python3
"""K3 (the fused AA forward) as it is against other builds, timed in turns
on one card (needs a card and nvcc).

    git show HEAD~1:trajsde_tpu_torch/csrc/aa_fused.cu > _checkouts/aa_fused.base.cu
    python scripts/compare_aa_fwd_builds_torch.py --base parent=_checkouts/aa_fused.base.cu \\
        [--base NAME=PATH ...]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/aa_fused.cu``, compiled where it lies, so headers
beside it come first, then this tree's), a ``NAME-no-products`` copy of
each base, and two copies of the current source: ``one-term``, whose
tensor-core products take one TF32 product per term (``mma_tf32.cuh``
without the two small terms), and ``no-products``, whose three chain
products are skipped (a wrong output: it times the rest of the kernel),
beside the current build (``change``).  A product is skipped where the
source calls ``mm<`` (the f32 FMA tiles of ``aa_common.cuh``) or
``tc::mma_xwt_split<`` (the tensor cores).  At the serving bucket-128
shape (B 128, T 21, Aq 49, Ak 48, D 64, H 8) it holds the output of each
build against the plain version, as max|build - plain| / max|plain|, for
the flagship's packed AA weights without a keep mask and for random
weights (the w1 blocks off the diagonal filled in) with one: the bases
and change must be within ``chip_smoke.TOL_K3_TIGHT``; one-term must
not, where the source runs its products on the tensor cores.  Then it
times the builds in the order of the bases, their no-products copies,
change, one-term, no-products, then back (CUDA-event medians of
``chip_smoke.TIMED_RUNS``), at bucket 128 and at ``forward_ood``'s shape
(Aq = Ak = 48), with the model's weights and no keep mask.  It prints
ptxas's register and spill lines of each build, one line per timing and
one JSON line with every number.  Exits non-zero if a check fails.
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

from chip_smoke import (K3_DROPOUT, NUM_ACTORS, SEED, TOL_K3_TIGHT, _k3_inputs,  # noqa: E402
                        _random_aa_weights, aa_fused_bound, cuda_ms)
from scripts.compare_aa_bwd_builds_torch import (one_term_header, ptxas_lines,  # noqa: E402
                                                 skip_products)
from trajsde_tpu_torch.config import FLAGSHIP_FUSED, build_model  # noqa: E402
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "aa_fused.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare_fwd"


def uses_tensor_cores(text: str) -> bool:
    return '#include "mma_tf32.cuh"' in text


def build_variants(bases: dict) -> dict:
    """name -> (configured library, ptxas lines, uses the tensor cores),
    built in parallel."""
    current = SOURCE.read_text()
    (OUT_DIR / "one-term").mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "one-term" / HEADER.name).write_text(one_term_header(HEADER.read_text()))
    sources, tensor = {}, {}
    for name, path in bases.items():
        sources[name] = os.fspath(path)
        tensor[name] = uses_tensor_cores(path.read_text())
        # the copy lies beside its base, so the base's own headers come first
        skipped = path.with_name(f"{path.stem}.no-products{path.suffix}")
        skipped.write_text(skip_products(path.read_text(), path))
        sources[f"{name}-no-products"] = os.fspath(skipped)
    for name, text in (("one-term", current), ("no-products", skip_products(current, SOURCE))):
        cu = OUT_DIR / name / SOURCE.name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        sources[name] = os.fspath(cu)
    tensor["change"] = tensor["one-term"] = uses_tensor_cores(current)
    libs = {"change": (K3._library(),
                       ptxas_lines(build.build_log.get("aa_fused", "")), tensor["change"])}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (K3.configure_fwd(lib), ptxas_lines(out), tensor.get(name))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of csrc/aa_fused.cu and its name")
    args = ap.parse_args()
    bases = dict((name, Path(path)) for name, path in (b.split("=", 1) for b in args.base))
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the builds run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants(bases)
    for name, (_, lines, _) in libs.items():
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)

    model = build_model(FLAGSHIP_FUSED, device="cuda", seed=SEED)
    Th, D, H = model.encoder.historical_steps, K3.KERNEL_DIM, K3.KERNEL_HEADS
    model_ws = tuple(w.contiguous()
                     for w in K3.weights_of(K3.pack_aa_params(model.encoder.aa_encoder)))
    del model
    shapes = {"bucket 128": (128, Th, NUM_ACTORS + 1, NUM_ACTORS),
              "ood": (128, Th, NUM_ACTORS, NUM_ACTORS)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = {"model weights, no keep": (model_ws, False),
             "random weights, keep": (_random_aa_weights(gen, model_ws), True)}
    checked = [n for n in libs if not n.endswith("no-products")]
    errs, failures = {n: {} for n in checked}, []
    for case, (ws, with_keep) in cases.items():
        q, u, mask, keep = _k3_inputs(shapes["bucket 128"], with_keep, gen)
        p = K3_DROPOUT if with_keep else 0.0
        want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p)
        for name in checked:
            got = K3.launch_fwd(libs[name][0], q, u, mask, keep, ws, H, p)[0]
            errs[name][case] = ((got - want).abs().max() / want.abs().max()).item()
        del q, u, mask, keep, want
    for name, rels in errs.items():
        worst = max(rels.values())
        if name == "one-term":
            if libs[name][2] and worst <= TOL_K3_TIGHT:
                failures.append(f"one-term passes TOL_K3_TIGHT ({worst:.3e})")
        elif not worst <= TOL_K3_TIGHT:
            failures.append(f"{name} {worst:.3e} > TOL_K3_TIGHT {TOL_K3_TIGHT:g}")
        print(f"[check] {name}: max|build - plain| / max|plain|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (TOL_K3_TIGHT {TOL_K3_TIGHT:g})", flush=True)
    torch.cuda.empty_cache()

    order = (*bases, *(f"{b}-no-products" for b in bases), "change", "one-term", "no-products")
    order += order[::-1]
    times = {}
    for shape_name, shape in shapes.items():
        q, u, mask, _ = _k3_inputs(shape, False, gen)
        times[shape_name] = []
        for name in order:
            ms = cuda_ms(lambda: K3.launch_fwd(libs[name][0], q, u, mask, None, model_ws, H, 0.0))
            times[shape_name].append((name, ms))
            print(f"[time] {shape_name} {list(shape)}: {name}: {ms:.3f} ms", flush=True)
        del q, u, mask
    bounds = {n: aa_fused_bound(*s, D, H, False) for n, s in shapes.items()}
    print(json.dumps({"card": card, "shapes": {k: list(v) for k, v in shapes.items()},
                      "times_ms": times,
                      "bound_ms": {k: b[0] for k, b in bounds.items()},
                      "route_ms": {k: b[4] for k, b in bounds.items()},
                      "ptxas": {k: v[1] for k, v in libs.items()},
                      "max_rel_err_vs_plain": errs}), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
