#!/usr/bin/env python3
"""K1 (the decoder-rollout forward) as it is against other builds, timed in
turns on one card (needs a card and nvcc).

    git show HEAD~1:trajsde_tpu_torch/csrc/sde_rollout.cu > _checkouts/sde_rollout.base.cu
    python scripts/compare_rollout_fwd_builds_torch.py \\
        --base parent=_checkouts/sde_rollout.base.cu [--base NAME=PATH ...] [--same-bits]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/sde_rollout.cu``, compiled where it lies, so
headers beside it come first, then this tree's) and two copies of the
current source: ``one-term``, whose tensor-core products take one TF32
product per term (``mma_tf32.cuh`` without the two small terms), and
``no-products``, whose five tensor-core products are skipped (wrong
states: it times the rest of the kernel), beside the current build
(``change``).  A base whose name ends in ``no-products`` is timed but not
checked.  With the flagship decoder's rollout weights and a ReLU'd random
y0, at the row counts of serving buckets 1, 8 and 128 (480, 3,840 and
61,440 rows x 60 steps x 64) and with Rademacher, gaussian and explicit
increments, it holds each build's ``ys`` against the plain version as
max|build - plain| / max|plain|: the bases and change must be within
``chip_smoke.TOL_K1_TIGHT`` and one-term must not; it also says whether
each base's ``ys`` are the change's bits (``--same-bits``: fail if not).
Then it times the
builds in the order of the bases, change, one-term, no-products, then
back (CUDA-event medians of ``chip_smoke.TIMED_RUNS``), for each row count
and kind of increments.  It prints the card's name and power limit,
ptxas's register and spill lines of each build (K1's 199,696 B of shared
memory are dynamic, set at launch, so ptxas does not list them), one line
per check and per timing (each with the card) and one JSON line with every
number.  Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (NUM_ACTORS, SEED, TOL_K1_TIGHT, _increments, cuda_ms,  # noqa: E402
                        one_term_header, rollout_bound)
from scripts.compare_aa_bwd_builds_torch import ptxas_lines  # noqa: E402
from trajsde_tpu_torch.config import FLAGSHIP, build_model  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402
from trajsde_tpu_torch.ops import sde_rollout as K1  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "sde_rollout.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare_rollout_fwd"
INCLUDE = '#include "mma_tf32.cuh"\n'
# stand-ins for the two product helpers that do nothing
SKIP = """
namespace tc {
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void skip_split(const A&, const B&, int, int, int, float (*)[NT][4]) {}
template <int MT, int NT, int K, int U, class A, class B, class C, class E>
__device__ __forceinline__ void skip_split2(const A&, const B&, float (*)[NT][4], const C&,
                                            const E&, float (*)[NT][4], int, int, int) {}
}  // namespace tc
"""
BUCKETS = (1, 8, 128)
MODES = ("rademacher", "gaussian", "explicit")


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The ctypes signatures of a library built from a K1 source (as
    ``ops/sde_rollout.py`` sets them for the package's build; a source
    older than the trailing keys pointer ignores the null passed for it)."""
    lib.sde_rollout_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sde_rollout_launch.restype = ctypes.c_int
    return lib


def launch(lib, y0, w, tsc, seed, steps, noise, mode) -> torch.Tensor:
    """``ys`` of one K1 launch from ``lib`` on the current stream; counts nothing."""
    ys = torch.empty((steps, *y0.shape), device=y0.device, dtype=torch.float32)
    k1, k2 = K1.seed_keys(seed)
    err = lib.sde_rollout_launch(y0.data_ptr(), w.data_ptr(), tsc.data_ptr(),
                                 None if noise is None else noise.data_ptr(), ys.data_ptr(),
                                 y0.shape[0], steps, k1, k2, mode,
                                 torch.cuda.current_stream().cuda_stream, None)
    if err != 0:
        raise RuntimeError(f"sde_rollout launch failed: cudaError {err}")
    return ys


def build_variants(bases: dict) -> dict:
    """name -> (configured library, ptxas lines), built in parallel."""
    current = SOURCE.read_text()
    if current.count(INCLUDE) != 1:
        raise RuntimeError(f"{INCLUDE!r} is not in {SOURCE} exactly once")
    skipped = current.replace(INCLUDE, INCLUDE + SKIP)
    for helper, stand_in in (("mma_xwt_split", "skip_split"), ("mma_xwt_split2", "skip_split2")):
        if f"tc::{helper}<" not in skipped:
            raise RuntimeError(f"tc::{helper} is not called in {SOURCE}")
        skipped = skipped.replace(f"tc::{helper}<", f"tc::{stand_in}<")
    # one-term's header lies beside its source, so its include finds it first
    (OUT_DIR / "one-term").mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "one-term" / HEADER.name).write_text(one_term_header(HEADER.read_text()))
    sources = {name: os.fspath(path) for name, path in bases.items()}
    for name, text in (("one-term", current), ("no-products", skipped)):
        cu = OUT_DIR / name / SOURCE.name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        sources[name] = os.fspath(cu)
    libs = {"change": (configure(build.load("sde_rollout")),
                       ptxas_lines(build.build_log.get("sde_rollout", "")))}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (configure(lib), ptxas_lines(out))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of csrc/sde_rollout.cu and its name")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless every base's ys are the change's bits")
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

    model = build_model(FLAGSHIP, device="cuda", seed=SEED)
    dec = model.decoder
    T, D = dec.future_steps, dec.local_channels
    kp = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    t0s, dts = dec.time_grid(device="cuda")
    shapes = [b * dec.num_modes * NUM_ACTORS for b in BUCKETS]
    del model
    w = K1.pack_params(kp)
    tsc = K1.time_table(t0s, dts)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    y0 = torch.relu(torch.randn((shapes[-1], D), generator=gen, device="cuda"))
    noise = torch.randn((T, shapes[-1], D), generator=gen, device="cuda")
    order = (*bases, "change", "one-term", "no-products")
    order += order[::-1]
    errs, failures, times, same = {}, [], {}, {}
    for n in shapes:
        y0_n, noise_n = y0[:n].contiguous(), noise[:, :n].contiguous()
        for mode in MODES:
            kw = _increments(mode, noise_n)
            nz = kw.get("noise")
            code = 0 if nz is not None else K1.INCREMENTS[kw["increments"]]
            want = K1.sde_rollout_reference(y0_n, kp, t0s, dts, 11, T, **kw)
            for name in libs:
                if name.endswith("no-products"):
                    continue
                got = launch(libs[name][0], y0_n, w, tsc, 11, T, nz, code)
                if name == "change":
                    ref = got
                elif name in bases:
                    same[f"{name} {n} {mode}"] = bool(torch.equal(got, ref))
                    if args.same_bits and not same[f"{name} {n} {mode}"]:
                        failures.append(f"{name} {n} rows {mode}: not the change's bits")
                rel = ((got - want).abs().max() / want.abs().max()).item()
                errs[f"{name} {n} {mode}"] = rel
                if name == "one-term" and rel <= TOL_K1_TIGHT:
                    failures.append(f"one-term passes TOL_K1_TIGHT ({n} rows, {mode}, {rel:.3e})")
                elif name != "one-term" and not rel <= TOL_K1_TIGHT:
                    failures.append(f"{name} {n} rows {mode}: {rel:.3e} > TOL_K1_TIGHT")
                print(f"[check] {card}: {name} {n} rows {mode}: max|build - plain| / max|plain| "
                      f"{rel:.3e} (TOL_K1_TIGHT {TOL_K1_TIGHT:g})"
                      + (f"; the change's bits: {same[f'{name} {n} {mode}']}"
                         if name in bases else ""), flush=True)
                del got
            del want, ref
            key = f"{n} {mode}"
            times[key] = []
            for name in order:
                ms = cuda_ms(lambda: launch(libs[name][0], y0_n, w, tsc, 11, T, nz, code))
                times[key].append((name, ms))
                print(f"[time] {card}: {n} rows {mode} {name}: {ms:.3f} ms", flush=True)
        del y0_n, noise_n
        torch.cuda.empty_cache()
    bounds = {}
    for n in shapes:
        bound, by, _, _, route, route_by = rollout_bound(n, T, D, False)
        bounds[n] = dict(bound_ms=bound, bound_by=by, route_bound_ms=route,
                         route_bound_by=route_by)
    print(json.dumps({"card": card, "rows": shapes, "steps": T, "times_ms": times,
                      "bounds": bounds, "ptxas": {k: v[1] for k, v in libs.items()},
                      "max_rel_err_vs_plain": errs, "same_bits_as_change": same}), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
