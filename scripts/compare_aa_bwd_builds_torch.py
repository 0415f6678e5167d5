#!/usr/bin/env python3
"""K4 (the fused AA backward) as it is against other builds, timed in turns
on one card (needs a card and nvcc).

    mkdir -p _checkouts/parent
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_fused_bwd.cu > _checkouts/parent/aa_fused_bwd.cu
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_common.cuh > _checkouts/parent/aa_common.cuh
    python scripts/compare_aa_bwd_builds_torch.py --base parent=_checkouts/parent/aa_fused_bwd.cu \
        [--base NAME=PATH ...] [--heads 8|4] [--same-bits]

Builds, in parallel, each ``--base`` (another version of
``trajsde_tpu_torch/csrc/aa_fused_bwd.cu``, compiled where it lies, so
headers beside it come first, then this tree's: a base whose headers
differ from this tree's needs them beside it) and four copies of the
current source: ``no-swizzle``, whose tile swizzle (``aa_common.cuh``'s
``swz``) is the identity (the swizzled chunk tiles read by plain rows);
``one-term``, whose tensor-core products take one TF32 product per term
(``mma_tf32.cuh`` without the two small terms); ``no-products``, whose six backward products are skipped, and
``no-recompute``, whose recompute's three chain products are (calls to
``mm<`` or ``tc::mma_xwt_split<``, as ``skip_products`` finds them; both
give wrong gradients and time the rest of the kernel), beside the current
build (``change``).  With ``--heads 8`` (the default) at the flagship's
training twin shape (B 128, T 21, Aq 49, Ak 48, D 64, H 8), with
``--heads 4`` at the HiVT baseline's (B 128, T 21, Aq = Ak = 48, H 4),
with a dropout keep mask, the model's packed AA weights and a random
cotangent, it holds the dq and weight gradients of each build that has
entry points for those heads against the plain backward by
``chip_smoke.k4_tol``: the bases, change and no-swizzle must pass and
one-term must fail; no-swizzle must give the change's bits.  At 8 heads
and the flagship's shape it also says whether the change gives each
base's outputs bit for bit (with ``--heads 4`` also at 4 heads, for the
bases that have them), and with ``--same-bits`` fails if not.  Then
it times the builds in the order of the bases, change, no-swizzle,
no-products, no-recompute, then back (CUDA-event medians of
``chip_smoke.TIMED_RUNS``).  It prints ptxas's register and spill lines
of each build (one set per head count the build has), one line per
timing and one JSON line with every number.  Exits non-zero if a check
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (K3_DROPOUT, NUM_ACTORS, SEED, TRAIN_BATCH, _k3_inputs,  # noqa: E402
                        aa_fused_bwd_bound, cuda_ms, k4_tol, one_term_header)
from trajsde_tpu_torch.config import (BASELINE_TRAIN, FLAGSHIP_TRAIN_FUSED,  # noqa: E402
                                      build_model)
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "aa_fused_bwd.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
COMMON_HEADER = Path(build.CSRC_DIR) / "aa_common.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare"
SWIZZLE_KEY = "  const int key = ((row & 3) << 1) | ((row >> 2) & 1);\n"
# a stand-in for the two product helpers that does nothing
SKIP = """
namespace tc {
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void skip(const A&, const B&, int, int, float (*)[NT][4]) {}
}  // namespace tc
"""

COMMON = '#include "aa_common.cuh"\n'
# stand-ins for the chain's product helpers (K3's, and K4's recompute) that
# do nothing
SKIP_CHAIN = """
namespace skipped {
template <int NR, int K, int LDA, int LDW, bool TWO>
__device__ __forceinline__ void mm(const float*, const float*, int, int, float (*)[8]) {}
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void xwt_split(const A&, const B&, int, int, int, float (*)[NT][4]) {}
}  // namespace skipped
"""


def skip_products(text: str, where) -> str:
    """``text`` (a K3 or K4 source) with its chain products' calls to
    ``mm<`` and ``tc::mma_xwt_split<`` replaced by calls that do nothing."""
    if text.count(COMMON) != 1:
        raise RuntimeError(f"{COMMON!r} is not in {where} exactly once")
    out, n = re.subn(r"\bmm<", "skipped::mm<", text.replace(COMMON, COMMON + SKIP_CHAIN))
    out, n2 = re.subn(r"\btc::mma_xwt_split<", "skipped::xwt_split<", out)
    if n + n2 == 0:
        raise RuntimeError(f"{where} calls no chain product to skip")
    return out


def ptxas_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_variants(bases: dict) -> dict:
    """name -> (configured library, ptxas lines), built in parallel."""
    current, header, common = SOURCE.read_text(), HEADER.read_text(), COMMON_HEADER.read_text()
    include = '#include "mma_tf32.cuh"\n'
    for text, key, where in ((common, SWIZZLE_KEY, COMMON_HEADER), (current, include, SOURCE)):
        if text.count(key) != 1:
            raise RuntimeError(f"{key!r} is not in {where} exactly once")
    skipped = current.replace(include, include + SKIP)
    skipped = skipped.replace("tc::mma_xty<", "tc::skip<").replace("tc::mma_xwt<", "tc::skip<")
    # a copy's own header lies beside its source, so its include finds it first
    for name, path, text in (("one-term", HEADER, one_term_header(header)),
                             ("no-swizzle", COMMON_HEADER,
                              common.replace(SWIZZLE_KEY, "  const int key = 0;\n"))):
        (OUT_DIR / name).mkdir(parents=True, exist_ok=True)
        (OUT_DIR / name / path.name).write_text(text)
    sources = {name: os.fspath(path) for name, path in bases.items()}
    for name, text in (("no-swizzle", current), ("one-term", current), ("no-products", skipped),
                       ("no-recompute", skip_products(current, SOURCE))):
        cu = OUT_DIR / name / SOURCE.name
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        sources[name] = os.fspath(cu)
    libs = {"change": (K3._bwd_library(), ptxas_lines(build.build_log.get("aa_fused_bwd", "")))}
    for name, (lib, out) in build.build_copies(sources, os.fspath(OUT_DIR)).items():
        libs[name] = (K3.configure_bwd(lib), ptxas_lines(out))
    return libs


def aa_weights(cfg) -> tuple:
    """(historical steps, the packed AA weights) of ``cfg``'s seeded model."""
    model = build_model(cfg, device="cuda", seed=SEED)
    enc = model.encoder
    return enc.historical_steps, tuple(
        w.contiguous() for w in K3.weights_of(K3.pack_aa_params(enc.aa_encoder)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", required=True, metavar="NAME=PATH",
                    help="another version of csrc/aa_fused_bwd.cu and its name")
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
    for name, (_, lines) in libs.items():
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)
    D, H = K3.KERNEL_DIM, args.heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    failures = []

    # the change against each base at 8 heads, the flagship's shape, bit for bit
    Th, ws = aa_weights(FLAGSHIP_TRAIN_FUSED)
    shape = (TRAIN_BATCH, Th, NUM_ACTORS + 1, NUM_ACTORS)
    q, u, mask, keep = _k3_inputs(shape, True, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, 8, K3_DROPOUT)
    ref = K3.launch_bwd(libs["change"][0], q, u, mask, keep, ws, g, out, stats, 8, K3_DROPOUT)
    same_bits = {}
    for name in bases:
        dq, dws = K3.launch_bwd(libs[name][0], q, u, mask, keep, ws, g, out, stats, 8, K3_DROPOUT)
        same_bits[name] = (torch.equal(dq, ref[0])
                           and all(torch.equal(a, b) for a, b in zip(dws, ref[1])))
    print(f"[check] at 8 heads, {list(shape)}: the change's dq and weight gradients are each "
          f"base's bits: {same_bits}", flush=True)
    if args.same_bits and not all(same_bits.values()):
        failures.append(f"the change's 8-head outputs differ from a base's: {same_bits}")
    del q, u, mask, keep, g, out, stats, ref
    torch.cuda.empty_cache()

    if H != 8:
        Th, ws = aa_weights(BASELINE_TRAIN)
        shape = (TRAIN_BATCH, Th, NUM_ACTORS, NUM_ACTORS)
    q, u, mask, keep = _k3_inputs(shape, True, gen, H)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, K3_DROPOUT)
    at_heads = [n for n in libs if K3.has_heads(libs[n][0], "aa_fused_bwd", H)]
    print(f"[check] builds with {H}-head entry points: {', '.join(at_heads)}", flush=True)

    def run(name):
        return K3.launch_bwd(libs[name][0], q, u, mask, keep, ws, g, out, stats, H, K3_DROPOUT)

    got = {name: run(name) for name in at_heads if name not in ("no-products", "no-recompute")}
    if H != 8:  # the change against each base that has these heads, bit for bit
        for name in bases:
            if name in got:
                same_bits[f"{name} at {H} heads"] = (
                    torch.equal(got[name][0], got["change"][0])
                    and all(torch.equal(a, b) for a, b in zip(got[name][1], got["change"][1])))
        print(f"[check] at {H} heads, {list(shape)}: the change's dq and weight gradients are "
              f"each base's bits: {same_bits}", flush=True)
        if args.same_bits and not all(same_bits.values()):
            failures.append(f"the change's {H}-head outputs differ from a base's: {same_bits}")
    want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, K3_DROPOUT)
    errs = {}
    for name, (dq, dws) in got.items():
        rels = {}
        over = []
        for leaf, a, b in zip(("dq", *K3.W_ORDER), (dq, *dws), (want_dq, *want)):
            rels[leaf] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            if not rels[leaf] <= k4_tol(leaf):
                over.append(f"{leaf} {rels[leaf]:.3e} > {k4_tol(leaf):g}")
        errs[name] = rels
        if name == "one-term" and not over:
            failures.append("one-term passes K4's limits")
        elif name != "one-term":
            failures.extend(f"{name} {o}" for o in over)
        print(f"[check] {name}: max|build - plain| / max|plain|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f"; over the limit: {', '.join(over) or 'none'}", flush=True)
    same = (torch.equal(got["no-swizzle"][0], got["change"][0])
            and all(torch.equal(a, b) for a, b in zip(got["no-swizzle"][1], got["change"][1])))
    print(f"[check] no-swizzle gives the change's bits: {same}", flush=True)
    if not same:
        failures.append("no-swizzle differs from change")
    del got, want_dq, want
    torch.cuda.empty_cache()

    order = tuple(n for n in (*bases, "change", "no-swizzle", "no-products", "no-recompute")
                  if n in at_heads)
    order += order[::-1]
    times = []
    for name in order:
        ms = cuda_ms(lambda: run(name))
        times.append((name, ms))
        print(f"[time] {H} heads {list(shape)}: {name}: {ms:.3f} ms", flush=True)
    bound = aa_fused_bwd_bound(*shape, D, H, True)
    print(json.dumps({"card": card, "heads": H, "shape": list(shape), "keep_p": K3_DROPOUT,
                      "times_ms": times, "bound_ms": bound[0], "tensor_route_bound_ms": bound[4],
                      "tensor_route_bound_by": bound[5],
                      "ptxas": {k: v[1] for k, v in libs.items()}, "max_rel_err_vs_plain": errs,
                      "same_bits_at_8_heads": same_bits}),
          flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
