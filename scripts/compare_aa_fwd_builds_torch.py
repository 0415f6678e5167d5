#!/usr/bin/env python3
"""K3 (the fused AA forward) as it is against other builds, timed in turns
on one card (needs a card and nvcc).

    mkdir -p _checkouts/parent
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_fused.cu > _checkouts/parent/aa_fused.cu
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_common.cuh > _checkouts/parent/aa_common.cuh
    python scripts/compare_aa_fwd_builds_torch.py --base parent=_checkouts/parent/aa_fused.cu \\
        [--base NAME=PATH ...] [--heads 8|4] [--same-bits]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/aa_fused.cu``, compiled where it lies, so headers
beside it come first, then this tree's: a base whose headers differ from
this tree's needs them beside it), a ``NAME-no-products`` copy of
each base, and two copies of the current source: ``one-term``, whose
tensor-core products take one TF32 product per term (``mma_tf32.cuh``
without the two small terms), and ``no-products``, whose three chain
products are skipped (a wrong output: it times the rest of the kernel),
beside the current build (``change``).  A product is skipped where the
source calls ``mm<`` (the f32 FMA tiles of ``aa_common.cuh``) or
``tc::mma_xwt_split<`` (the tensor cores).  First, at 8 heads and the
serving bucket-128 shape (B 128, T 21, Aq 49, Ak 48, D 64), it says
whether the change gives each base's output bit for bit in both cases
below (with ``--heads 4`` also at 4 heads, for the bases that have
them), and with ``--same-bits`` fails if not.  Then, with ``--heads 8``
(the default) at that shape, with ``--heads 4`` at the HiVT baseline's
(B 128, T 21, Aq = Ak = 48), it holds the output of each build that has
entry points for those heads against the plain version, as max|build -
plain| / max|plain|, for the model's packed AA weights without a keep
mask and for random weights (the w1 blocks off the diagonal filled in)
with one: the bases and change must be within
``chip_smoke.TOL_K3_TIGHT``; one-term must not, where the source runs
its products on the tensor cores.  Then it times those builds in the
order of the bases, their no-products copies, change, one-term,
no-products, then back (CUDA-event medians of ``chip_smoke.TIMED_RUNS``),
at 8 heads at bucket 128 and at ``forward_ood``'s shape (Aq = Ak = 48),
at 4 at the baseline's shape, with the model's weights and no keep mask.
It prints ptxas's register and spill lines of each build (one set per
head count the build has), one line per timing and one JSON line with
every number.  Exits non-zero if a check fails.
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
                        _random_aa_weights, aa_fused_bound, cuda_ms, one_term_header)
from scripts.compare_aa_bwd_builds_torch import aa_weights, ptxas_lines, skip_products  # noqa: E402
from trajsde_tpu_torch.config import BASELINE_TRAIN, FLAGSHIP_FUSED  # noqa: E402
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
    ap.add_argument("--heads", type=int, choices=K3.KERNEL_HEAD_COUNTS, default=K3.KERNEL_HEADS,
                    help="check and time at the flagship's 8 heads or the baseline's 4")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless the change's 8-head outputs are each base's bits")
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

    D, H = K3.KERNEL_DIM, args.heads
    Th, flagship_ws = aa_weights(FLAGSHIP_FUSED)
    A = NUM_ACTORS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    flagship = {"model weights, no keep": (flagship_ws, False),
                "random weights, keep": (_random_aa_weights(gen, flagship_ws), True)}
    failures = []

    # the change against each base at 8 heads, bucket 128, bit for bit
    same_bits = {name: True for name in bases}
    for case, (ws, with_keep) in flagship.items():
        q, u, mask, keep = _k3_inputs((128, Th, A + 1, A), with_keep, gen)
        p = K3_DROPOUT if with_keep else 0.0
        ref = K3.launch_fwd(libs["change"][0], q, u, mask, keep, ws, 8, p)[0]
        for name in bases:
            got = K3.launch_fwd(libs[name][0], q, u, mask, keep, ws, 8, p)[0]
            same_bits[name] = same_bits[name] and torch.equal(got, ref)
        del q, u, mask, keep, ref, got
    print(f"[check] at 8 heads, bucket 128: the change's output is each base's bits: "
          f"{same_bits}", flush=True)
    if args.same_bits and not all(same_bits.values()):
        failures.append(f"the change's 8-head output differs from a base's: {same_bits}")

    if H == 8:
        cases = flagship
        shapes = {"bucket 128": (128, Th, A + 1, A), "ood": (128, Th, A, A)}
    else:
        Th, ws = aa_weights(BASELINE_TRAIN)
        cases = {"model weights, no keep": (ws, False),
                 "random weights, keep": (_random_aa_weights(gen, ws), True)}
        shapes = {"baseline 128": (128, Th, A, A)}
    model_ws = cases["model weights, no keep"][0]
    at_heads = [n for n in libs if K3.has_heads(libs[n][0], "aa_fused", H)]
    print(f"[check] builds with {H}-head entry points: {', '.join(at_heads)}", flush=True)
    checked = [n for n in at_heads if not n.endswith("no-products")]
    errs = {n: {} for n in checked}
    first = next(iter(shapes.values()))
    for case, (ws, with_keep) in cases.items():
        q, u, mask, keep = _k3_inputs(first, with_keep, gen, H)
        p = K3_DROPOUT if with_keep else 0.0
        want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p)
        got = {name: K3.launch_fwd(libs[name][0], q, u, mask, keep, ws, H, p)[0]
               for name in checked}
        for name in checked:
            errs[name][case] = ((got[name] - want).abs().max() / want.abs().max()).item()
        if H != 8:  # the change against each base that has these heads, bit for bit
            for name in bases:
                if name in got:
                    key = f"{name} at {H} heads"
                    same_bits[key] = same_bits.get(key, True) and torch.equal(got[name],
                                                                             got["change"])
        del q, u, mask, keep, want, got
    if H != 8:
        print(f"[check] at {H} heads, {list(first)}: the change's output is each base's bits: "
              f"{same_bits}", flush=True)
        if args.same_bits and not all(same_bits.values()):
            failures.append(f"the change's {H}-head output differs from a base's: {same_bits}")
    for name, rels in errs.items():
        worst = max(rels.values())
        if name == "one-term":
            if libs[name][2] and worst <= TOL_K3_TIGHT:
                failures.append(f"one-term passes TOL_K3_TIGHT ({worst:.3e})")
        elif not worst <= TOL_K3_TIGHT:
            failures.append(f"{name} {worst:.3e} > TOL_K3_TIGHT {TOL_K3_TIGHT:g}")
        print(f"[check] {name} at {H} heads: max|build - plain| / max|plain|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (TOL_K3_TIGHT {TOL_K3_TIGHT:g})", flush=True)
    torch.cuda.empty_cache()

    order = tuple(n for n in (*bases, *(f"{b}-no-products" for b in bases), "change", "one-term",
                              "no-products") if n in at_heads)
    order += order[::-1]
    times = {}
    for shape_name, shape in shapes.items():
        q, u, mask, _ = _k3_inputs(shape, False, gen, H)
        times[shape_name] = []
        for name in order:
            ms = cuda_ms(lambda: K3.launch_fwd(libs[name][0], q, u, mask, None, model_ws, H, 0.0))
            times[shape_name].append((name, ms))
            print(f"[time] {H} heads, {shape_name} {list(shape)}: {name}: {ms:.3f} ms", flush=True)
        del q, u, mask
    bounds = {n: aa_fused_bound(*s, D, H, False) for n, s in shapes.items()}
    print(json.dumps({"card": card, "heads": H, "shapes": {k: list(v) for k, v in shapes.items()},
                      "times_ms": times,
                      "bound_ms": {k: b[0] for k, b in bounds.items()},
                      "route_ms": {k: b[4] for k, b in bounds.items()},
                      "ptxas": {k: v[1] for k, v in libs.items()},
                      "max_rel_err_vs_plain": errs, "same_bits_at_8_heads": same_bits}),
          flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
