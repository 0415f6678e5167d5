#!/usr/bin/env python3
"""Holds K6's check against planted faults (needs a card and nvcc).

K6 (``trajsde_tpu_torch/csrc/vpu_probe.cu``) is checked against its plain
version element by element, by ``vpu_probe.agreement``: every element
within ``TOL_ULPS`` ulps, and at least ``MIN_BIT_EQUAL`` of them
bit-equal.  This script builds the kernel as it is and
three copies with a fault planted in the source, runs each variant of each
on the probe's full tile (65,536 x 128, ``normal(0, 0.1)`` from seed 0),
and prints the per-element readings: the largest error in ulps, its
quantiles, its mean and the share of bit-equal elements.  The faults:

* ``zero-negatives``: every negative input set to 0 (its output is then 0
  where the plain one is about -0.01), all variants;
* ``fused-bf16``: ``__hfma2`` in place of ``__hmul2_rn`` then ``__hadd2``,
  one rounding per round fewer than the plain version, bf16;
* ``approx-tanh-f32``: ``tanh.approx.f32`` in the accurate f32 variant.

    python scripts/check_vpu_probe_faults_torch.py

Exits non-zero if the kernel as it is fails the check or a faulty copy
passes it.  The copies are built under ``trajsde_tpu_torch/_build/faults``.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts import bench_vpu_dtype_torch as probe  # noqa: E402
from trajsde_tpu_torch.ops import build, vpu_probe  # noqa: E402

SOURCE = Path(build.CSRC_DIR) / "vpu_probe.cu"
OUT_DIR = Path(build.BUILD_DIR) / "faults"
# fault -> (variants it applies to, [(text in the source, its replacement)])
FAULTS = {
    "zero-negatives": (tuple(vpu_probe.VARIANTS), [
        ("  float4 v = x[i];\n",
         "  float4 v = x[i];\n  v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);"
         " v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);\n"),
        ("  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);\n",
         "  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);\n"
         "  for (int k = 0; k < 4; ++k) v[k] = __hmax2(v[k], __float2bfloat162_rn(0.f));\n")]),
    "fused-bf16": (("bfloat16",), [
        ("__hadd2(__hmul2_rn(tanh_bf16x2(v[k]), v[k]), v[k])",
         "__hfma2(tanh_bf16x2(v[k]), v[k], v[k])")]),
    "approx-tanh-f32": (("float32",), [
        ("    return tanhf(v);\n",
         "    float out;\n    asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(out) : \"f\"(v));\n"
         "    return out;\n")]),
}


def build_faults() -> dict:
    """Each fault's library, built in parallel from a patched copy of the
    source."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name, (_, patches) in FAULTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} is not in {SOURCE} exactly once")
            src = src.replace(old, new)
        sources[name] = os.fspath(OUT_DIR / f"{name}.cu")
        Path(sources[name]).write_text(src)
    return {name: vpu_probe.configure(lib)
            for name, (lib, _) in build.build_copies(sources, os.fspath(OUT_DIR)).items()}


def readings(err: torch.Tensor) -> dict:
    """Per-element error (ulps) of one output, summarised."""
    err = err.flatten().float()
    q = torch.quantile(err, torch.tensor([0.5, 0.99, 0.999], device=err.device)).tolist()
    return dict(max=err.max().item(), p50=q[0], p99=q[1], p999=q[2], mean=err.mean().item(),
                equal=(err == 0).float().mean().item())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the faults are planted in the card's kernel")
    libs = {"kernel": vpu_probe._library(), **build_faults()}
    failures = []
    for variant, (dtype, approx) in vpu_probe.VARIANTS.items():
        x = probe.probe_input(dtype, probe.FULL_ROWS)
        want = vpu_probe.chained_tanh_reference(x)
        tol, least = vpu_probe.TOL_ULPS[variant], vpu_probe.MIN_BIT_EQUAL[variant]
        for name, lib in libs.items():
            if name != "kernel" and variant not in FAULTS[name][0]:
                continue
            got = vpu_probe.launch(lib, x, approx)
            r = readings(vpu_probe.ulps(got, want))
            ok = vpu_probe.agreement(got, want, variant)["ok"]
            print(f"{variant:14s} {name:16s} ulps: max {r['max']:.6g}, p50 {r['p50']:.6g}, "
                  f"p99 {r['p99']:.6g}, p99.9 {r['p999']:.6g}, mean {r['mean']:.6g}; bit-equal "
                  f"{r['equal']:.6f}; limits {tol} ulps, bit-equal {least} -> "
                  f"{'pass' if ok else 'FAIL'}", flush=True)
            if ok != (name == "kernel"):
                failures.append(f"{variant} {name}")
    if failures:
        raise SystemExit("the check did not tell the kernel from its faults: "
                         + ", ".join(failures))
    print("the kernel passes the check and every planted fault fails it", flush=True)


if __name__ == "__main__":
    main()
