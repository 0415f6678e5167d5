#!/usr/bin/env python3
"""K5 (``aa_attention``, the AA chain from positions) as it is against other
builds, timed in turns on one card (needs a card and nvcc).

    mkdir -p _checkouts/parent
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_attention.cu > _checkouts/parent/aa_attention.cu
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_common.cuh > _checkouts/parent/aa_common.cuh
    python scripts/compare_aa_attention_builds_torch.py \\
        --base parent=_checkouts/parent/aa_attention.cu [--base NAME=PATH ...] [--heads 8 4] \\
        [--same-bits]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/aa_attention.cu``, compiled where it lies, so
headers beside it come first, then this tree's: a base whose headers
differ from this tree's needs them beside it), a ``NAME-no-products``
copy of each base, and two copies of the current source: ``one-term``,
whose tensor-core products take one TF32 product per term
(``mma_tf32.cuh`` without the two small terms), and ``no-products``, whose
three chain products are skipped (a wrong output: it times the rest of
the kernel), beside the current build (``change``).  A product is skipped
where the source calls ``mm<`` (the f32 FMA tiles of an older K5, whose
q projection goes with them) or ``tc::mma_xwt_split<`` (the tensor
cores; the bf16 form's ``tc::mma_xwt_bf16<`` products stay).  For each head count of ``--heads`` (8 at the twin shape, B 128,
T 21, Aq 49, Ak 48, with the flagship's packed AA weights; 4 at the HiVT
baseline's, Aq = Ak = 48, with the baseline's) it holds the output of
each build that has entry points for those heads against the plain
version, as max|build - plain| / max|plain|, for the model's weights and
for random ones (the w1 blocks off the diagonal filled in): the bases and
change must be within ``chip_smoke.TOL_K3_TIGHT``, and one-term must not;
it says whether the change's output is each base's bit for bit, and with
``--same-bits`` fails if not (K5's f32 entry points: a source that adds
another form, as K5b's ``BF``, must not move them).  Then it times those builds in the order of the bases, their no-products
copies, change, one-term, no-products, then back (CUDA-event medians of
``chip_smoke.TIMED_RUNS``) with the model's weights.  It prints ptxas's
register and spill lines of each build (one set per head count the build
has), one line per timing and one JSON line with every number.  Exits
non-zero if a check fails.
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

from chip_smoke import (K5_BASELINE_SHAPE, K5_SHAPES, SEED, TOL_K3_TIGHT,  # noqa: E402
                        _k5_inputs, _k5_packed, aa_attention_bound, cuda_ms, one_term_header)
from scripts.compare_aa_bwd_builds_torch import ptxas_lines, skip_products  # noqa: E402
from trajsde_tpu_torch.config import BASELINE_TRAIN, FLAGSHIP, build_model  # noqa: E402
from trajsde_tpu_torch.ops import aa_attention as K5  # noqa: E402
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "aa_attention.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare_k5"
SHAPES = {8: K5_SHAPES["twin"], 4: K5_BASELINE_SHAPE}
MODELS = {8: FLAGSHIP, 4: BASELINE_TRAIN}


def build_variants(bases: dict) -> dict:
    """name -> (configured library, ptxas lines), built in parallel."""
    current = SOURCE.read_text()
    (OUT_DIR / "one-term").mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "one-term" / HEADER.name).write_text(one_term_header(HEADER.read_text()))
    sources = {}
    for name, path in bases.items():
        sources[name] = os.fspath(path)
        # the copy lies beside its base, so the base's own headers come first
        skipped = path.with_name(f"{path.stem}.no-products{path.suffix}")
        skipped.write_text(skip_products(path.read_text(), path))
        sources[f"{name}-no-products"] = os.fspath(skipped)
    for name, text in (("one-term", current), ("no-products", skip_products(current, SOURCE))):
        cu = OUT_DIR / name / SOURCE.name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        sources[name] = os.fspath(cu)
    libs = {"change": (K5._library(), ptxas_lines(build.build_log.get("aa_attention", "")))}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (K5.configure(lib), ptxas_lines(out))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of csrc/aa_attention.cu and its name")
    ap.add_argument("--heads", type=int, nargs="+", choices=K3.KERNEL_HEAD_COUNTS,
                    default=list(K3.KERNEL_HEAD_COUNTS),
                    help="check and time at the flagship's 8 heads, the baseline's 4, or both")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless the change's output is each base's bit for bit")
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
    for name, (_, lines) in libs.items():
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)

    D = K3.KERNEL_DIM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    failures, report = [], {}
    for H in args.heads:
        weights = _k5_packed(build_model(MODELS[H], device="cuda", seed=SEED), gen)
        shape = SHAPES[H]
        at_heads = [n for n in libs if K3.has_heads(libs[n][0], "aa_attention", H)]
        print(f"[check] builds with {H}-head entry points: {', '.join(at_heads)}", flush=True)
        checked = [n for n in at_heads if not n.endswith("no-products")]
        errs = {n: {} for n in checked}
        bits = {b: {} for b in bases if b in checked}
        args_ = _k5_inputs(shape, gen)
        for wname, ws in weights.items():
            want = K5.aa_attention_reference(*args_, ws, H)
            outs = {}
            for name in checked:
                got = K5.launch(libs[name][0], *args_, ws, H)
                errs[name][wname] = ((got - want).abs().max() / want.abs().max()).item()
                if name == "change" or name in bits:
                    outs[name] = got
            for b in bits:
                bits[b][wname] = torch.equal(outs["change"], outs[b])
            del want, got, outs
        print(f"[bits] {H} heads, {list(shape)}: the change's output is each base's bits: "
              f"{bits}", flush=True)
        if args.same_bits and not all(all(v.values()) for v in bits.values()):
            failures.append(f"the change's output is not each base's bits at {H} heads")
        for name, rels in errs.items():
            worst = max(rels.values())
            if name == "one-term":
                if worst <= TOL_K3_TIGHT:
                    failures.append(f"one-term passes TOL_K3_TIGHT at {H} heads ({worst:.3e})")
            elif not worst <= TOL_K3_TIGHT:
                failures.append(f"{name} {worst:.3e} > TOL_K3_TIGHT {TOL_K3_TIGHT:g} at {H} heads")
            print(f"[check] {name} at {H} heads, {list(shape)}: max|build - plain| / max|plain|: "
                  + ", ".join(f"{k} weights {v:.3e}" for k, v in rels.items())
                  + f" (TOL_K3_TIGHT {TOL_K3_TIGHT:g})", flush=True)
        torch.cuda.empty_cache()

        order = tuple(n for n in (*bases, *(f"{b}-no-products" for b in bases), "change",
                                  "one-term", "no-products") if n in at_heads)
        order += order[::-1]
        times = []
        for name in order:
            ms = cuda_ms(lambda: K5.launch(libs[name][0], *args_, weights["model"], H))
            times.append((name, ms))
            print(f"[time] {H} heads, {list(shape)}: {name}: {ms:.3f} ms", flush=True)
        bound = aa_attention_bound(*shape, D, H)
        report[H] = dict(shape=list(shape), times_ms=times, route_ms=bound[4],
                         cuda_core_bound_ms=bound[0], max_rel_err_vs_plain=errs, same_bits=bits)
        del args_, weights
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "heads": report,
                      "ptxas": {k: v[1] for k, v in libs.items()}}), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
