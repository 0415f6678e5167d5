#!/usr/bin/env python3
"""K4 or K4b (the fused AA backward in f32 or bf16) against other builds.

K4, or with ``--bf16`` K4b, as it is against other builds of its source,
timed in turns on one card (needs a card and nvcc).

    mkdir -p _checkouts/parent
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_fused_bwd.cu > _checkouts/parent/aa_fused_bwd.cu
    git show HEAD~1:trajsde_tpu_torch/csrc/aa_common.cuh > _checkouts/parent/aa_common.cuh
    python scripts/compare_aa_bwd_builds_torch.py [--bf16] \
        [--base parent=_checkouts/parent/aa_fused_bwd.cu ...] [--heads 8 4] [--same-bits] \
        [--parts no-products no-recompute no-colsum ...]

The change is this tree's source: ``csrc/aa_fused_bwd.cu`` (K4), or
``csrc/aa_fused_bwd_bf16.cu`` with ``--bf16`` (K4b).  Each ``--base`` is
another version of it, compiled where it lies, so headers beside it come
first, then this tree's: a base whose headers differ from this tree's
needs them beside it.  Before K4b had a file of its own it was the ``BF``
form of ``aa_fused_bwd.cu``, so such a file is a K4b base too.  All build
in parallel, each with a part-skipped copy per ``--parts`` (each gives
wrong gradients and times the rest of the kernel):

- ``no-products``: the six backward products (``tc::mma_xty<`` and
  ``tc::mma_xwt<`` in K4, ``tc::mma_xty_exact_x<`` and
  ``tc::mma_xwt_exact_w<`` in K4b);
- ``no-recompute``: the recompute's three chain products
  (``tc::mma_xwt_split<``, ``tc::mma_xwt_bf16<``);
- ``no-colsum``: the vector-gradient and dq sums (``colsum`` and dq's pair
  loop; ``reduce_cols``, ``dq_partials`` and ``dq_sums`` in K4b's file);
- finer parts of K4b's file: ``no-weight-products`` and
  ``no-input-products`` (the three of each kind), ``no-ln-vjp`` (the
  LayerNorm VJPs pass the cotangent through), ``no-ln-fwd`` (the
  recompute's LayerNorms left out).

K4 also gets two check copies of the change: ``one-term``, whose
tensor-core products take one TF32 product per term (``mma_tf32.cuh``
without the two small terms), must fail ``chip_smoke.k4_tol``, and
``no-swizzle``, whose tile swizzle (``aa_common.cuh``'s ``swz``) is the
identity, must give the change's bits.

At each ``--heads`` (the flagship's training twin shape at 8, B 128, T 21,
Aq 49, Ak 48, D 64; the HiVT baseline's at 4, Aq = Ak = 48), with a
dropout keep mask, the model's packed AA weights and a random cotangent,
it holds each whole build that has entry points for those heads against
the plain backward, K4 by ``chip_smoke.k4_tol``, K4b within
``chip_smoke.TOL_K4B`` (max and mean); says whether the change gives each
base's bits (``--same-bits`` fails if not); then times every build in
turns, each source before its copies, the bases before the change, then
back (CUDA-event medians of ``chip_smoke.TIMED_RUNS``): K4 at batch 128,
K4b at 64 (``BF16_FUSED_BATCH``, where the check runs) and 128.  It prints
ptxas's register and spill lines of each build, one line per check and
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

from chip_smoke import (BF16_FUSED_BATCH, K3_DROPOUT, NUM_ACTORS, SEED,  # noqa: E402
                        TOL_K4B, TRAIN_BATCH, _bf16_dist, _k3_inputs, _within,
                        aa_fused_bwd_bound, cuda_ms, k4_tol, one_term_header)
from trajsde_tpu_torch.config import (BASELINE_TRAIN, FLAGSHIP_TRAIN_FUSED,  # noqa: E402
                                      build_model)
from trajsde_tpu_torch.ops import aa_fused as K3  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "aa_fused_bwd.cu"
BF16_SOURCE = Path(build.CSRC_DIR) / "aa_fused_bwd_bf16.cu"
HEADER = Path(build.CSRC_DIR) / "mma_tf32.cuh"
COMMON_HEADER = Path(build.CSRC_DIR) / "aa_common.cuh"
OUT_DIR = Path(build.BUILD_DIR) / "compare"
SWIZZLE_KEY = "  const int key = ((row & 3) << 1) | ((row >> 2) & 1);\n"
# the batches each kernel is timed at; the first is where it is checked
BATCHES = {False: (TRAIN_BATCH,), True: (BF16_FUSED_BATCH, TRAIN_BATCH)}

COMMON = '#include "aa_common.cuh"\n'
# stand-ins for the chain's product helpers (K3's, K3b's, K5's, and K4's
# recompute) that do nothing; K3b's register-fed product (aa_fused_bf16.cu's
# mma_rows) gives each accumulator the bits of an A register instead, so
# that the chain before it stays live
SKIP_CHAIN = """
namespace skipped {
template <int NR, int K, int LDA, int LDW, bool TWO>
__device__ __forceinline__ void mm(const float*, const float*, int, int, float (*)[8]) {}
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void xwt_split(const A&, const B&, int, int, int, float (*)[NT][4]) {}
template <int MT, int NT, int K, int U, class A, class B>
__device__ __forceinline__ void xwt_bf16(const A&, const B&, int, int, int, float (*)[NT][4]) {}
template <int NT, int KS, int KMASK>
__device__ __forceinline__ void rows(const uint32_t (*a)[4], const __nv_bfloat16*, int, int,
                                     float (*acc)[4]) {
  for (int j = 0; j < NT; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = __uint_as_float(a[j & KMASK][e]);
}
}  // namespace skipped
"""
# (pattern, stand-in) of each product helper
CHAIN_PRODUCTS = ((r"\bmm<", "skipped::mm<"),
                  (r"\btc::mma_xwt_split<", "skipped::xwt_split<"),
                  (r"\btc::mma_xwt_bf16<", "skipped::xwt_bf16<"),
                  (r"(?<![\w:])mma_rows<(?=\d)", "skipped::rows<"))


def skip_products(text: str, where) -> str:
    """``text`` (a K3, K3b or K5 source) with its chain products' calls to
    ``mm<``, ``tc::mma_xwt_split<``, ``tc::mma_xwt_bf16<`` and ``mma_rows<``
    replaced by stand-ins that multiply nothing."""
    if text.count(COMMON) != 1:
        raise RuntimeError(f"{COMMON!r} is not in {where} exactly once")
    out, hits = text.replace(COMMON, COMMON + SKIP_CHAIN), 0
    for pattern, repl in CHAIN_PRODUCTS:
        out, n = re.subn(pattern, repl, out)
        hits += n
    if hits == 0:
        raise RuntimeError(f"{where} calls no chain product to skip")
    return out


def ptxas_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


# the backward's part-skipped copies: stand-ins that take any arguments
# and do nothing (or return 0), and per part the (pattern, replacement)
# pairs that route its calls to them, K4's and K4b's names alike
STUBS = """
namespace skipped {
template <int MT, int NT, int K, int U, class... A>
__device__ __forceinline__ void skip(A&&...) {}
template <class... A>
__device__ __forceinline__ float colsum(A&&...) { return 0.0f; }
template <int NV, int N, class V, class C>
__device__ __forceinline__ void reduce_cols(float*, const int (&)[NV], const V&, C) {}
template <int H, class... A>
__device__ __forceinline__ void dq_partials(A&&...) {}
template <int H, class... A>
__device__ __forceinline__ void dq_sums(A&&...) {}
template <int NV>
__device__ __forceinline__ void ln_vjp(const float* dy, const float*, const float*, float,
                                       float* dx) {
  for (int m = 0; m < NV; ++m) dx[m] = dy[m];
}
template <class... A>
__device__ __forceinline__ void ln_fwd(A&&...) {}
}  // namespace skipped
"""
WEIGHT_PRODUCTS = ((r"\btc::mma_xty<", "skipped::skip<"),
                   (r"\btc::mma_xty_exact_x<", "skipped::skip<"))
INPUT_PRODUCTS = ((r"\btc::mma_xwt<", "skipped::skip<"),
                  (r"\btc::mma_xwt_exact_w<", "skipped::skip<"))
SKIPS = {
    "no-products": WEIGHT_PRODUCTS + INPUT_PRODUCTS,
    "no-recompute": ((r"\btc::mma_xwt_split<", "skipped::skip<"),
                     (r"\btc::mma_xwt_bf16<", "skipped::skip<")),
    "no-colsum": ((r"\+= colsum\(", "+= skipped::colsum("),
                  (r"for \(int p = pa; p < pb; \+\+p\)", "for (int p = pa; p < pa; ++p)"),
                  (r"(?<![\w:])reduce_cols<", "skipped::reduce_cols<"),
                  (r"(?<![\w:])dq_partials<", "skipped::dq_partials<"),
                  (r"(?<![\w:])dq_sums<", "skipped::dq_sums<")),
    "no-weight-products": WEIGHT_PRODUCTS,
    "no-input-products": INPUT_PRODUCTS,
    "no-ln-vjp": ((r"\bln_vjp<4, true>\(", "skipped::ln_vjp<4>("),),
    "no-ln-fwd": ((r"\b(ln_row_t|epi_a1|epi_nbr)<true>\(", "skipped::ln_fwd("),),
}
PARTS = ("no-products", "no-recompute", "no-colsum")


def skip_part(text: str, what: str, where) -> str:
    """``text`` (a K4 or K4b source) with the part ``what`` skipped."""
    include = '#include "mma_tf32.cuh"\n'
    if text.count(include) != 1:
        raise RuntimeError(f"{include!r} is not in {where} exactly once")
    out, hits = text.replace(include, include + STUBS), 0
    for pattern, repl in SKIPS[what]:
        out, n = re.subn(pattern, repl, out)
        hits += n
    if hits == 0:
        raise RuntimeError(f"{where} has nothing to skip for {what}")
    return out


def k4_check_copies(out: Path) -> dict:
    """K4's one-term and no-swizzle copies of the change: name -> source.
    A copy's own header lies beside its source, so its include finds it
    first."""
    header, common = HEADER.read_text(), COMMON_HEADER.read_text()
    if common.count(SWIZZLE_KEY) != 1:
        raise RuntimeError(f"{SWIZZLE_KEY!r} is not in {COMMON_HEADER} exactly once")
    copies = {}
    for name, path, text in (("one-term", HEADER, one_term_header(header)),
                             ("no-swizzle", COMMON_HEADER,
                              common.replace(SWIZZLE_KEY, "  const int key = 0;\n"))):
        (out / name).mkdir(parents=True, exist_ok=True)
        (out / name / path.name).write_text(text)
        (out / name / SOURCE.name).write_text(SOURCE.read_text())
        copies[name] = os.fspath(out / name / SOURCE.name)
    return copies


def aa_weights(cfg) -> tuple:
    """(historical steps, the packed AA weights) of ``cfg``'s seeded model."""
    model = build_model(cfg, device="cuda", seed=SEED)
    enc = model.encoder
    return enc.historical_steps, tuple(
        w.contiguous() for w in K3.weights_of(K3.pack_aa_params(enc.aa_encoder)))


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them (f32
    matmuls in full precision from here on)."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the builds run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def same_bits(a: tuple, b: tuple) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", action="append", default=[], metavar="NAME=PATH",
                    help="another version of the change's source and its name")
    ap.add_argument("--heads", type=int, nargs="+", choices=K3.KERNEL_HEAD_COUNTS,
                    default=[K3.KERNEL_HEADS],
                    help="check and time at each: the flagship's 8 heads, the baseline's 4")
    ap.add_argument("--same-bits", action="store_true",
                    help="fail unless the change's outputs are each base's bits")
    ap.add_argument("--bf16", action="store_true", help="K4b instead of K4")
    ap.add_argument("--parts", nargs="*", choices=list(SKIPS), default=list(PARTS),
                    help="the part-skipped copies of each source (the finer ones apply to "
                         "K4b's file)")
    args = ap.parse_args()
    card = card_name()
    print(card, flush=True)
    sources = {name: Path(path) for name, path in (b.split("=", 1) for b in args.base)}
    sources["change"] = BF16_SOURCE if args.bf16 else SOURCE
    out = OUT_DIR / ("bf16" if args.bf16 else "f32")
    builds = {name: os.fspath(path) for name, path in sources.items()}
    for name, path in sources.items():
        text = path.read_text()
        for what in args.parts:
            cu = out / f"{name}-{what}" / path.name
            cu.parent.mkdir(parents=True, exist_ok=True)
            cu.write_text(skip_part(text, what, path))
            builds[f"{name}-{what}"] = os.fspath(cu)
    checks = {} if args.bf16 else k4_check_copies(out)
    builds.update(checks)
    libs = {name: (K3.configure_bwd(lib), ptxas_lines(log))
            for name, (lib, log) in build.build_copies(builds, os.fspath(out)).items()}
    for name in builds:
        for line in libs[name][1]:
            print(f"[build] {name}: {line}", flush=True)

    dt = dict(compute_dtype="bfloat16") if args.bf16 else {}
    whole = [*sources, *checks]
    timed = [n for s in sources for n in (s, *(f"{s}-{w}" for w in args.parts))]
    timed += [n for n in checks if n != "one-term"]
    D, A, p = K3.KERNEL_DIM, NUM_ACTORS, K3_DROPOUT
    gen = torch.Generator(device="cuda").manual_seed(SEED + (52 if args.bf16 else 12))
    failures, report = [], {"card": card, "bf16": args.bf16, "keep_p": p, "cases": []}
    for H in args.heads:
        Th, ws = aa_weights(FLAGSHIP_TRAIN_FUSED if H == 8 else BASELINE_TRAIN)
        at = [n for n in libs if K3.has_heads(libs[n][0], "aa_fused_bwd", H, **dt)]
        print(f"[check] builds with {H}-head entry points: {', '.join(at)}", flush=True)
        for i, batch in enumerate(BATCHES[args.bf16]):
            shape = (batch, Th, A + 1 if H == 8 else A, A)
            q, u, mask, keep = _k3_inputs(shape, True, gen, H)
            g = torch.randn(q.shape, generator=gen, device="cuda")
            fwd, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, p, **dt)

            def run(name):
                return K3.launch_bwd(libs[name][0], q, u, mask, keep, ws, g, fwd, stats, H, p,
                                     **dt)

            case = {"heads": H, "shape": list(shape)}
            if i == 0:  # each whole build against the plain version, the change against each
                got = {name: run(name) for name in whole if name in at}
                want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g,
                                                                      H, p, **dt)
                dists = {}
                for name, (dq, dws) in got.items():
                    dists[name] = {k: _bf16_dist(a, b) for k, a, b in
                                   zip(("dq", *K3.W_ORDER), (dq, *dws), (want_dq, *want))}
                    over = [k for k, v in dists[name].items()
                            if not (_within(v, TOL_K4B) if args.bf16 else v[0] <= k4_tol(k))]
                    if name == "one-term":
                        if not over:
                            failures.append("one-term passes K4's limits")
                    else:
                        failures.extend(f"{name} at {H} heads: {k} past its limit" for k in over)
                    print(f"[check] {H} heads {list(shape)}: {name}: max / mean |build - plain| "
                          "over max / mean |plain|: " + ", ".join(
                              f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in dists[name].items())
                          + f"; past the limit: {', '.join(over) or 'none'}", flush=True)
                same = {name: same_bits(got[name], got["change"])
                        for name in got if name not in ("change", "one-term")}
                print(f"[check] {H} heads: the change gives each build's bits: {same}",
                      flush=True)
                failures.extend(f"{name}'s {H}-head outputs differ from the change's"
                                for name, ok in same.items()
                                if not ok and (name == "no-swizzle" or args.same_bits))
                case.update(dist_vs_plain=dists, same_bits=same)
                del got, want_dq, want
            order = [n for n in timed if n in at]
            order += order[::-1]
            times = []
            for name in order:
                ms = cuda_ms(lambda: run(name))
                times.append((name, ms))
                print(f"[time] {H} heads {list(shape)}: {name}: {ms:.3f} ms", flush=True)
            cores, _, _, _, route, route_by = aa_fused_bwd_bound(*shape, D, H, True, args.bf16)
            case.update(times_ms=times, bound_ms=route, bound_by=route_by,
                        cuda_core_bound_ms=cores)
            report["cases"].append(case)
            del q, u, mask, keep, g, fwd, stats
            torch.cuda.empty_cache()
    report["ptxas"] = {k: v[1] for k, v in libs.items()}
    print(json.dumps(report), flush=True)
    if failures:
        raise SystemExit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
