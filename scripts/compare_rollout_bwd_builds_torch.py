#!/usr/bin/env python3
"""K2 (the decoder-rollout backward) as it is against other builds, timed in
turns on one card (needs a card and nvcc).

    git show HEAD~1:trajsde_tpu_torch/csrc/sde_rollout_bwd.cu > _checkouts/sde_rollout_bwd.base.cu
    python scripts/compare_rollout_bwd_builds_torch.py \\
        --base parent=_checkouts/sde_rollout_bwd.base.cu [--base NAME=PATH ...] [--same-bits]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/sde_rollout_bwd.cu``, compiled where it lies, so
headers beside it come first, then this tree's) and two copies of the
current source: ``one-term``, whose products round each operand to TF32
before the f64 tensor cores multiply it (``mma_f64.cuh`` with one TF32
product per term), and ``no-products``, whose fourteen tensor-core
products are skipped (wrong gradients: it times the rest of the kernel),
beside the current build (``change``).  A base whose name ends in
``no-products`` is timed but not checked.  At the training shape (61,440
rows x 60 steps x 64) with the flagship decoder's rollout weights, a
random cotangent, and gaussian (regenerated) and explicit increments, it
holds dy0 and the 14 weight gradients of each build against the plain
backward by ``chip_smoke.k2_tol``: the bases and change must pass and
one-term must fail; it also says whether each base's dy0 and dw are the
change's bits (``--same-bits``: fail if not).  Then it times the builds
in the order of the bases,
change, no-products, then back (CUDA-event medians of
``chip_smoke.TIMED_RUNS``), for each kind of increments.  It prints
ptxas's register and spill lines of each build, one line per timing and
one JSON line with every number.
Exits non-zero if a check fails.
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

from chip_smoke import SEED, _increments, bwd_bound, cuda_ms, k2_tol, train_rows  # noqa: E402
from scripts.compare_aa_bwd_builds_torch import ptxas_lines  # noqa: E402
from trajsde_tpu_torch.config import FLAGSHIP_TRAIN, build_model  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402
from trajsde_tpu_torch.ops import sde_rollout as K1  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "sde_rollout_bwd.cu"
HEADER = Path(build.CSRC_DIR) / "mma_f64.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare_rollout"
INCLUDE = '#include "mma_f64.cuh"\n'
# stand-ins for the four product helpers that do nothing
SKIP = """
namespace dtc {
template <int MT, int NT, int K, int U, class A, class B, class V>
__device__ __forceinline__ void skip_xwt(const A&, const B&, int, int, int, V (*)[NT][4]) {}
template <int MT, int NT, int K, int U, class A, class B, class C, class E, class V>
__device__ __forceinline__ void skip_xwt2(const A&, const B&, V (*)[NT][4], const C&,
                                          const E&, V (*)[NT][4], int, int, int) {}
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void skip_xty(const A&, const B&, int, int, float (*)[NT][4]) {}
template <int MT, int NT, int K, int U, class A, class B, class C, class E>
__device__ __forceinline__ void skip_xty2(const A&, const B&, float (*)[NT][4], const C&,
                                          const E&, float (*)[NT][4], int, int) {}
}  // namespace dtc
"""
# one-term: each operand rounded to TF32 where the f64 product reads it
OPERANDS = '      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));\n'
ONE_TERM = """
__device__ __forceinline__ double tf32r(double x) {
  unsigned int r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(static_cast<float>(x)));
  return __uint_as_float(r);
}
"""


def one_term_header(header: str) -> str:
    """``mma_f64.cuh`` whose f64 product takes each operand rounded to TF32."""
    anchor = "namespace dtc {\n"
    if header.count(OPERANDS) != 1 or header.count(anchor) != 1:
        raise RuntimeError(f"{HEADER}'s f64 mma operands are not where one-term expects them")
    rounded = OPERANDS
    for v in ("a[0]", "a[1]", "a[2]", "a[3]", "b[0]", "b[1]"):
        rounded = rounded.replace(f'"d"({v})', f'"d"(tf32r({v}))')
    return header.replace(OPERANDS, rounded).replace(anchor, anchor + ONE_TERM)


MODES = ("gaussian", "explicit")


def build_variants(bases: dict) -> dict:
    """name -> (configured library, ptxas lines), built in parallel."""
    current = SOURCE.read_text()
    if current.count(INCLUDE) != 1:
        raise RuntimeError(f"{INCLUDE!r} is not in {SOURCE} exactly once")
    skipped = current.replace(INCLUDE, INCLUDE + SKIP)
    for helper in ("mma_xwt", "mma_xwt2", "mma_xty", "mma_xty2"):
        skipped = skipped.replace(f"dtc::{helper}<", f"dtc::skip_{helper[4:]}<")
    # one-term's header lies beside its source, so its include finds it first
    (OUT_DIR / "one-term").mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "one-term" / HEADER.name).write_text(one_term_header(HEADER.read_text()))
    sources = {name: os.fspath(path) for name, path in bases.items()}
    for name, text in (("one-term", current), ("no-products", skipped)):
        cu = OUT_DIR / name / SOURCE.name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        sources[name] = os.fspath(cu)
    libs = {"change": (K1._bwd_library(),
                       ptxas_lines(build.build_log.get("sde_rollout_bwd", "")))}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (K1.configure_bwd(lib), ptxas_lines(out))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of csrc/sde_rollout_bwd.cu and its name")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless every base's dy0 and dw are the change's bits")
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

    model = build_model(FLAGSHIP_TRAIN, device="cuda", seed=SEED)
    dec = model.decoder
    T, D, rows = dec.future_steps, dec.local_channels, train_rows(model)
    kp = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    t0s, dts = dec.time_grid(device="cuda")
    del model
    w = K1.pack_params(kp)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    noise = torch.randn((T, rows, D), generator=gen, device="cuda")
    ct = torch.randn((T, rows, D), generator=gen, device="cuda")
    errs, failures, times, same = {}, [], {}, {}
    for mode in MODES:
        kw = _increments(mode, noise)
        nz, inc = kw.get("noise"), kw["increments"]
        ys = K1.sde_rollout_packed(y0, w, t0s, dts, 13, T, nz, inc)

        def run(name):
            return K1.launch_bwd(libs[name][0], y0, ys, ct, w, t0s, dts, 13, T, nz, inc)

        want_dy0, want = K1.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 13, T, nz, inc)
        for name in libs:
            if name.endswith("no-products"):
                continue
            dy0, dw = run(name)
            if name == "change":
                ref = (dy0, dw)
            elif name in bases:
                same[f"{name} {mode}"] = bool(torch.equal(dy0, ref[0]) and torch.equal(dw, ref[1]))
                if args.same_bits and not same[f"{name} {mode}"]:
                    failures.append(f"{name} {mode}: not the change's bits")
            rels, over = {}, []
            for leaf, a, b in [("dy0", dy0, want_dy0)] + [
                    (k, v, want[k]) for k, v in K1.unpack_params(dw, D).items()]:
                rels[leaf] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                if not rels[leaf] <= k2_tol(leaf):
                    over.append(f"{leaf} {rels[leaf]:.3e} > {k2_tol(leaf):g}")
            errs[f"{name} {mode}"] = rels
            if name == "one-term" and not over:
                failures.append(f"one-term passes K2's limits ({mode})")
            elif name != "one-term":
                failures.extend(f"{name} {mode} {o}" for o in over)
            print(f"[check] {name} {mode}: max|build - plain| / max|plain|: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
                  + f"; over the limit: {', '.join(over) or 'none'}"
                  + (f"; the change's bits: {same[f'{name} {mode}']}" if name in bases else ""),
                  flush=True)
            del dy0, dw
        del want_dy0, want, ref
        torch.cuda.empty_cache()
        order = (*bases, "change", "no-products")
        order += order[::-1]
        times[mode] = []
        for name in order:
            ms = cuda_ms(lambda: run(name))
            times[mode].append((name, ms))
            print(f"[time] {mode} {name}: {ms:.3f} ms", flush=True)
        del ys
    bound, by, _, _, route, route_by = bwd_bound(rows, T, D, False)
    print(json.dumps({"card": card, "rows": rows, "steps": T, "times_ms": times,
                      "bound_ms": bound, "bound_by": by, "route_bound_ms": route,
                      "route_bound_by": route_by,
                      "ptxas": {k: v[1] for k, v in libs.items()},
                      "max_rel_err_vs_plain": errs, "same_bits_as_change": same}), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
