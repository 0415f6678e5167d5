#!/usr/bin/env python3
"""How the tensor cores round the sums of one TF32 ``mma.sync`` (needs a
card and nvcc).

K4's products (``trajsde_tpu_torch/csrc/mma_tf32.cuh``) sum two k-steps in
a fresh fragment and add it to their f32 accumulators on the CUDA cores,
on the grounds that the tensor cores do not round their sums to nearest.
This script measures that: it builds ``scripts/mma_rounding_probe.cu``
(one m16n8k8 product, D = A B + C, through the same helper) and runs it
on TF32 terms whose exact sum lies between two f32 values.  Row m of A
holds one set of terms, B is all ones, so every D[m, n] is the sum of row
m's terms plus C[m, n]; each column of C adds another f32 value.  For
each of the 128 results it computes the exact value and its f32 neighbours
rounded to nearest (ties to even) and toward zero, and counts the cases
where the two differ ("deciding" cases) that the card matched.

    python scripts/probe_mma_rounding_torch.py

Prints the card, each deciding case, and one JSON line with the counts
and the verdict: ``nearest`` or ``toward zero`` if every deciding case
matched that mode, else ``neither`` (then the cases say what the card
does).  It also counts the results that :func:`tensor_core_sum` gives, the
model of the sum that ``tests/test_torch_aa_fused_tf32.py`` and
``tests/test_torch_sde_rollout_tf32.py`` emulate K4's and K2's products with
(:func:`mma_step`), and exits non-zero if any result differs from it (or the
probe does not build or run).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trajsde_tpu_torch.ops import build  # noqa: E402

SOURCE = Path(__file__).resolve().with_name("mma_rounding_probe.cu")
OUT_DIR = Path(build.BUILD_DIR) / "probe"
ULP1 = 2.0 ** -23  # f32's spacing in [1, 2)
# each row: TF32 terms (at most 8) whose sum, alone or plus C, needs
# rounding; the comment gives the sum in ulps of its binade
TERMS = [
    [1.0, 0.75 * ULP1],                    # 1 + 0.75 ulp
    [-1.0, -0.75 * ULP1],                  # -(1 + 0.75 ulp)
    [1.0, 0.5 * ULP1],                     # 1 + 0.5 ulp: a tie, the even side below
    [1.0, ULP1, 0.5 * ULP1],               # 1 + 1.5 ulp: a tie, the even side above
    [1.0, -2.0 ** -30],                    # just below 1
    [-1.0, 2.0 ** -30],                    # just above -1
    [1.0, 0.25 * ULP1, 0.25 * ULP1, 0.25 * ULP1],  # 1 + 0.75 ulp in three terms
    [1.0] + [ULP1 / 8] * 7,                # 1 + 0.875 ulp in seven terms
    [0.75 * ULP1, 1.0],                    # the first row, the big term second
    [1.0, 1.0, 0.75 * 2 * ULP1],           # 2 + 0.75 ulp of [2, 4)
    [3.0, 0.25 * 2 * ULP1, 0.5 * 2 * ULP1],  # 3 + 0.75 ulp of [2, 4)
    [1.0, 2.0 ** -40],                     # 1 + 2^-17 ulp
    [1.5, -0.25 * ULP1],                   # 1.5 - 0.25 ulp
    [0.0],                                 # C alone
    [1.0, 0.125 * ULP1],                   # 1 + 0.125 ulp
    [-0.5, -0.375 * ULP1],                 # -(0.5 + 0.75 ulp of [0.5, 1))
]
# each column of C: an f32 value added to every row's sum
C_COLS = [0.0, 1.0, -1.0, 0.75 * ULP1, -2.0 ** -30, 0.5, -0.5, ULP1]


def is_tf32(x: float) -> bool:
    bits = int(np.float32(x).view(np.uint32))
    return bits & 0x1FFF == 0 and float(np.float32(x)) == x


def binade(a: Fraction) -> int:
    """e with 2^e <= a < 2^(e + 1), for a > 0."""
    e = a.numerator.bit_length() - a.denominator.bit_length()
    return e - 1 if Fraction(2) ** e > a else e


def round_f32(x: Fraction, mode: str) -> float:
    """x rounded to a normal f32 ``nearest`` (ties to even) or ``toward zero``."""
    if x == 0:
        return 0.0
    a = abs(x)
    ulp = Fraction(2) ** (binade(a) - 23)
    q = a // ulp
    r = a - q * ulp
    if mode == "nearest" and (2 * r > ulp or (2 * r == ulp and q % 2 == 1)):
        q += 1
    return float(q * ulp) * (1 if x > 0 else -1)


def tensor_core_sum(addends) -> float:
    """The model of one mma's sum that this probe holds the card to: every
    addend (the exact products and C) cut toward zero to a multiple of
    2^(e - 25), e the binade of the largest, so 2 bits below that one's f32
    ulp; the sum of what is left rounded toward zero to f32."""
    top = max(abs(x) for x in addends)
    if top == 0:
        return 0.0
    q = Fraction(2) ** (binade(top) - 25)
    return round_f32(sum(int(x / q) * q for x in addends), "toward zero")


def model(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """:func:`tensor_core_sum` of every (row, col) of A B + C."""
    return np.array([[tensor_core_sum([Fraction(float(a[m, k])) * Fraction(float(b[k, n]))
                                       for k in range(a.shape[1])] + [Fraction(float(c[m, n]))])
                      for n in range(b.shape[1])] for m in range(a.shape[0])])


def cases():
    """A [16, 8], B [8, 8], C [16, 8] and each (row, col)'s exact result."""
    a = np.zeros((16, 8), np.float32)
    for m, terms in enumerate(TERMS):
        assert len(terms) <= 8 and all(is_tf32(v) for v in terms), m
        a[m, :len(terms)] = terms
    b = np.ones((8, 8), np.float32)
    c = np.tile(np.asarray(C_COLS, np.float32), (16, 1))
    exact = [[sum(Fraction(float(v)) for v in a[m]) + Fraction(float(c[m, n]))
              for n in range(8)] for m in range(16)]
    return a, b, c, exact


# ---------------------------------------------------------------------------
# the tensor cores' arithmetic on CPU tensors, for the tests that emulate the
# kernels' 3xTF32 products (tests/test_torch_aa_fused_tf32.py for K4,
# tests/test_torch_sde_rollout_tf32.py for K2)
# ---------------------------------------------------------------------------
def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite f32 values: round the 23-bit mantissa
    to 10 bits, to nearest, ties away from zero (on the sign-magnitude bit
    pattern), the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """x -> (big, small) = (rna_tf32(x), rna_tf32(x - big))."""
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def rz_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma_step(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tensor-core step: c + a b (a [M, 8], b [8, N] TF32 values), by
    :func:`tensor_core_sum`: the 8 exact products and c cut toward zero to
    multiples of 2^(e - 25), e the binade of the largest of them, then
    summed (exactly, in f64) and rounded toward zero."""
    terms = torch.cat([a.double()[:, None, :] * b.double().t()[None], c.double()[..., None]], 2)
    _, e = torch.frexp(terms.abs().amax(2, keepdim=True))   # the largest in [2^(e-1), 2^e)
    q = torch.ldexp(torch.ones_like(terms[..., :1]), e - 26)
    return rz_f32((torch.trunc(terms / q) * q).sum(2))


STEPS_PER_FRAGMENT = 2               # k-steps summed in one fresh fragment (mma_tf32.cuh)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, chained: bool,
              acc: torch.Tensor | None = None, apart: bool = False) -> torch.Tensor:
    """acc + a [M, K] @ b [K, N], K a multiple of 8, as the kernels' tensor
    cores do it (``mma_tf32.cuh``): ``STEPS_PER_FRAGMENT`` k-steps per fresh
    fragment, each added to the f32 ``acc`` (zeros if None) on the CUDA
    cores (``mma3x2``); with ``apart``, the small terms and big * big go
    into two fresh fragments, added in that order (``mma3x2_apart``); when
    ``chained``, ``acc`` is carried through the tensor cores over all of K."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros((a.shape[0], b.shape[1])) if acc is None else acc
    zero = torch.zeros_like(acc)
    c, m = (acc if chained else zero), zero
    steps = a.shape[1] // 8
    for step in range(steps):
        s = slice(8 * step, 8 * step + 8)
        c = mma_step(mma_step(c, as_[:, s], bb[s]), ab[:, s], bs[s])
        if apart:
            m = mma_step(m, ab[:, s], bb[s])
        else:
            c = mma_step(c, ab[:, s], bb[s])
        if not chained and ((step + 1) % STEPS_PER_FRAGMENT == 0 or step + 1 == steps):
            acc, c, m = (acc + c) + m, zero, zero
    return c if chained else acc


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe runs on the card's tensor cores")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib, _ = build.build_copies({"mma_rounding_probe": os.fspath(SOURCE)},
                                os.fspath(OUT_DIR))["mma_rounding_probe"]
    lib.mma_rounding_probe_launch.argtypes = [ctypes.c_void_p] * 5
    lib.mma_rounding_probe_launch.restype = ctypes.c_int
    a, b, c, exact = cases()
    at, bt, ct = (torch.from_numpy(x).cuda() for x in (a, b, c))
    dt = torch.empty_like(ct)
    err = lib.mma_rounding_probe_launch(at.data_ptr(), bt.data_ptr(), ct.data_ptr(),
                                        dt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_rounding_probe launch failed: cudaError {err}")
    d = dt.cpu().numpy()
    want = model(a, b, c)
    counts = {"cases": 0, "deciding": 0, "nearest": 0, "toward zero": 0, "neither": 0,
              "as the model": int((d.astype(np.float64) == want).sum())}
    for m in range(16):
        for n in range(8):
            got = float(d[m, n])
            rn, rz = round_f32(exact[m][n], "nearest"), round_f32(exact[m][n], "toward zero")
            counts["cases"] += 1
            if rn == rz:
                if got != rn:
                    counts["neither"] += 1
                    print(f"[case] row {m} col {n}: exact {float(exact[m][n])!r} is an f32 "
                          f"value, the card gave {got!r}", flush=True)
                continue
            counts["deciding"] += 1
            mode = "nearest" if got == rn else "toward zero" if got == rz else "neither"
            counts[mode] += 1
            print(f"[case] row {m} {TERMS[m]} + C {C_COLS[n]!r}: exact "
                  f"{float(exact[m][n])!r}, nearest {rn!r}, toward zero {rz!r}, card {got!r}: "
                  f"{mode}", flush=True)
    deciding = counts["deciding"]
    verdict = ("nearest" if counts["nearest"] == deciding and not counts["neither"] else
               "toward zero" if counts["toward zero"] == deciding and not counts["neither"]
               else "neither")
    print(json.dumps({"card": card, "verdict": verdict, **counts}), flush=True)
    if counts["as the model"] != counts["cases"]:
        raise SystemExit(f"{counts['cases'] - counts['as the model']} results differ from the "
                         "model of the tensor cores' sums")


if __name__ == "__main__":
    main()
