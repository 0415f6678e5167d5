#!/usr/bin/env python3
"""K3 or K3b (the fused AA forward in f32 or bf16) against other builds.

K3, or with ``--bf16`` K3b, as it is against other builds, timed in turns
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

With ``--bf16`` the change is ``csrc/aa_fused_bf16.cu`` (K3b) and each
``--base`` a K3b source: before K3b had a file of its own it was the ``BF``
form of ``aa_fused.cu``, so the parent's ``aa_fused.cu`` (with its headers
beside it) is a base::

    git show HEAD~1:trajsde_tpu_torch/csrc/aa_fused.cu > _checkouts/parent/aa_fused.cu
    python scripts/compare_aa_fwd_builds_torch.py --bf16 \\
        --base parent=_checkouts/parent/aa_fused.cu [--same-bits]

Each source (the bases and the change) builds whole, as a
``NAME-no-products`` copy (its chain products skipped: ``skip_products``
knows ``tc::mma_xwt_bf16<`` and K3b's ``mma_rows<``) and as a
``NAME-logits`` copy with ``AA_WRITE_LOGITS`` defined, which writes every
pair's masked head logits.  At 8 heads (the twin shape, B 16) and at 4 (the
baseline's, B 16), with and without a keep mask, with ``ln_mm`` on and off,
for the model's packed weights (``FLAGSHIP_BF16_FUSED``'s at 8,
``BASELINE_TRAIN``'s at 4) and random ones (every other case): it says
whether the change's logits and its statistics' max are each base's bits
(``--same-bits`` fails if not), and holds each whole build's output to the
plain bf16 chain within ``chip_smoke.TOL_K3B`` (max and mean).  Then it
times the whole and no-products builds in turns, the bases first, then
back (CUDA-event medians of ``chip_smoke.TIMED_RUNS``), at chip_smoke's T1
shapes: bucket 128 at 8 heads, the baseline's 4 heads and shape (both the
model's weights, no keep) and ``FLAGSHIP_BF16_FUSED``'s train shape at
``BF16_FUSED_BATCH`` with keep and the statistics.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BF16_FUSED_BATCH, K3_DROPOUT, NUM_ACTORS, SEED,  # noqa: E402
                        TOL_K3_TIGHT, TOL_K3B, TRAIN_BATCH, _bf16_dist, _k3_inputs,
                        _random_aa_weights, _within, aa_fused_bound, cuda_ms, one_term_header)
from scripts.compare_aa_bwd_builds_torch import (aa_weights, card_name,  # noqa: E402
                                                 ptxas_lines, skip_products)
from trajsde_tpu_torch.config import (BASELINE_TRAIN, FLAGSHIP_BF16_FUSED,  # noqa: E402
                                      FLAGSHIP_FUSED)
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "aa_fused.cu"
BF16_SOURCE = Path(build.CSRC_DIR) / "aa_fused_bf16.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare_fwd"
LOGITS = "#define AA_WRITE_LOGITS\n"
BF = dict(compute_dtype="bfloat16")


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
    libs = {"change": (K3._library("float32"),
                       ptxas_lines(build.build_log.get("aa_fused", "")), tensor["change"])}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (K3.configure_fwd(lib), ptxas_lines(out), tensor.get(name))
    return libs


def build_bf16(bases: dict) -> dict:
    """K3b's builds, in parallel: name -> (configured library, ptxas lines)
    for each source (the bases and ``change``), its ``-no-products`` and its
    ``-logits`` copy.  A base's copies lie beside it, so its own headers
    come first."""
    sources = {**bases, "change": BF16_SOURCE}
    builds = {}
    for name, path in sources.items():
        builds[name] = os.fspath(path)
        text = path.read_text()
        if name == "change":
            where = OUT_DIR / "bf16"
            where.mkdir(parents=True, exist_ok=True)
            skipped, logits = where / "no-products.cu", where / "logits.cu"
        else:
            skipped = path.with_name(f"{path.stem}.no-products{path.suffix}")
            logits = path.with_name(f"{path.stem}.logits{path.suffix}")
        skipped.write_text(skip_products(text, path))
        logits.write_text(LOGITS + text)
        builds[f"{name}-no-products"] = os.fspath(skipped)
        builds[f"{name}-logits"] = os.fspath(logits)
    libs = {name: (K3.configure_fwd(lib), ptxas_lines(out))
            for name, (lib, out) in build.build_copies(builds, os.fspath(OUT_DIR / "bf16")).items()}
    for name in sources:
        lib = libs[f"{name}-logits"][0]
        fn = getattr(lib, "aa_fused_bf16_set_logits", None) or lib.aa_fused_set_logits
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        libs[f"{name}-logits"] = (lib, libs[f"{name}-logits"][1], fn)
    return {name: libs[name] for name in builds}


def logits_of(lib, set_logits, q, u, mask, keep, ws, H, p, ln_mm):
    """``lib``'s (a logits copy) masked logits [pairs, H], output and
    statistics on these inputs."""
    rows = q.shape[0] * q.shape[1] * q.shape[2] * u.shape[3]
    lg = torch.full((rows, H), float("nan"), device="cuda")
    if set_logits(lg.data_ptr()) != 0:
        raise RuntimeError("set_logits failed")
    out, stats = K3.launch_fwd(lib, q, u, mask, keep, ws, H, p, True, ln_mm=ln_mm, **BF)
    torch.cuda.synchronize()
    if torch.isnan(lg).any():
        raise RuntimeError("a pair's logits were not written")
    return lg, out, stats


def main_bf16(args, bases: dict, card: str) -> None:
    """K3b's checks and turns (see the module's docstring)."""
    libs = build_bf16(bases)
    for name, (_, lines, *_) in libs.items():
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)
    sources = [*bases, "change"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    A, D, p = NUM_ACTORS, K3.KERNEL_DIM, K3_DROPOUT
    Th, ws8 = aa_weights(FLAGSHIP_BF16_FUSED)
    _, ws4 = aa_weights(BASELINE_TRAIN)
    failures, report = [], {"card": card, "bf16": True, "checks": [], "times_ms": {}}
    same = {name: True for name in bases}
    for H, shape, model_ws in ((8, (16, Th, A + 1, A), ws8), (4, (16, Th, A, A), ws4)):
        for with_keep in (False, True):
            for ln_mm in (True, False):
                ws = model_ws if with_keep is False and ln_mm else _random_aa_weights(gen, model_ws)
                q, u, mask, keep = _k3_inputs(shape, with_keep, gen, H)
                pk = p if with_keep else 0.0
                case = (f"{H} heads {list(shape)}, keep {'p=%g' % pk if with_keep else 'None'}, "
                        f"ln_mm {ln_mm}, {'model' if ws is model_ws else 'random'} weights")
                got = {n: logits_of(libs[f"{n}-logits"][0], libs[f"{n}-logits"][2], q, u, mask,
                                    keep, ws, H, pk, ln_mm) for n in sources}
                want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, pk,
                                                         ln_mm=ln_mm, **BF)
                entry = {"case": case, "same_logits": {}, "same_max": {}, "dist": {}}
                for n in sources:
                    whole = K3.launch_fwd(libs[n][0], q, u, mask, keep, ws, H, pk, True,
                                          ln_mm=ln_mm, **BF)
                    if not (torch.equal(whole[0], got[n][1]) and torch.equal(whole[1], got[n][2])):
                        failures.append(f"{n}'s logits copy gave other outputs ({case})")
                    dist = _bf16_dist(whole[0], want)
                    entry["dist"][n] = dist
                    if not _within(dist, TOL_K3B):
                        failures.append(f"{n} {dist[0]:.3e} / {dist[1]:.3e} past TOL_K3B ({case})")
                for n in bases:
                    entry["same_logits"][n] = torch.equal(got[n][0], got["change"][0])
                    entry["same_max"][n] = torch.equal(got[n][2][0], got["change"][2][0])
                    same[n] = same[n] and entry["same_logits"][n] and entry["same_max"][n]
                print(f"[check] {case}: the change's logits / statistics' max are each base's "
                      f"bits: {entry['same_logits']} / {entry['same_max']}; max / mean |build - "
                      "plain| over max / mean |plain|: " + ", ".join(
                          f"{n} {d[0]:.3e} / {d[1]:.3e}" for n, d in entry["dist"].items())
                      + f" (TOL_K3B {TOL_K3B[0]:g} / {TOL_K3B[1]:g})", flush=True)
                report["checks"].append(entry)
                del q, u, mask, keep, got, want
                torch.cuda.empty_cache()
    if args.same_bits and not all(same.values()):
        failures.append(f"the change's logits differ from a base's: {same}")

    order = [n for s in sources for n in (s, f"{s}-no-products")]
    order += order[::-1]
    for tag, shape, H, ws, with_keep in (
            ("bucket 128", (TRAIN_BATCH, Th, A + 1, A), 8, ws8, False),
            ("baseline 128", (TRAIN_BATCH, Th, A, A), 4, ws4, False),
            (f"train {BF16_FUSED_BATCH}, keep", (BF16_FUSED_BATCH, Th, A + 1, A), 8, ws8, True)):
        q, u, mask, keep = _k3_inputs(shape, with_keep, gen, H)
        pk = p if with_keep else 0.0
        times = []
        for name in order:
            ms = cuda_ms(lambda: K3.launch_fwd(libs[name][0], q, u, mask, keep, ws, H, pk,
                                               with_keep, **BF))
            times.append((name, ms))
            print(f"[time] {H} heads, {tag} {list(shape)}: {name}: {ms:.3f} ms", flush=True)
        route = aa_fused_bound(*shape, D, H, with_keep, True)[4]
        report["times_ms"][tag] = {"shape": list(shape), "heads": H, "times": times,
                                   "bound_ms": route}
        del q, u, mask, keep
        torch.cuda.empty_cache()
    report["ptxas"] = {k: v[1] for k, v in libs.items()}
    report["same_bits"] = same
    print(json.dumps(report), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of the change's source and its name")
    ap.add_argument("--bf16", action="store_true", help="K3b instead of K3")
    ap.add_argument("--heads", type=int, choices=K3.KERNEL_HEAD_COUNTS, default=K3.KERNEL_HEADS,
                    help="check and time at the flagship's 8 heads or the baseline's 4")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless the change's 8-head outputs are each base's bits")
    args = ap.parse_args()
    bases = dict((name, Path(path)) for name, path in (b.split("=", 1) for b in args.base))
    card = card_name()
    print(card, flush=True)
    if args.bf16:
        main_bf16(args, bases, card)
        return
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
