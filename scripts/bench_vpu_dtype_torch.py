#!/usr/bin/env python3
"""Micro-probe: the H100's elementwise rate, f32 vs packed bf16 (kernel K6).

The port of ``scripts/bench_vpu_dtype.py``: 64 chained ``x = tanh(x) * x
+ x`` rounds on a [rows, 128] tile in one kernel
(``trajsde_tpu_torch/csrc/vpu_probe.cu``), f32 against bf16, to decide
whether a bf16 spine can pay on the elementwise side of the AA kernels.

    python scripts/bench_vpu_dtype_torch.py

Prints the card's name and power limit, then per run the kernel's
microseconds per call and T(tanh.mul.add)/s.  The JAX probe's tile (2,048
rows) runs f32 and bf16; it gives fewer blocks than the card has SMs, so
it reads latency.  A tile of 65,536 rows fills the card and reads the
rate, also with f32 on ``tanh.approx.f32``, the counterpart of the packed
approximate bf16 tanh.  Timing: CUDA events around ``REPS`` back-to-back
launches, queued behind a spin kernel so that the device runs them
without waiting for the host.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trajsde_tpu_torch.ops import vpu_probe  # noqa: E402

TILE_ROWS, FULL_ROWS = 2048, 65536
REPS, WARMUP = 200, 3
# (variant of vpu_probe.VARIANTS, rows), in the order they run
RUNS = (("float32", TILE_ROWS), ("bfloat16", TILE_ROWS),
        ("float32", FULL_ROWS), ("float32-approx", FULL_ROWS), ("bfloat16", FULL_ROWS))
# cycles of the spin kernel that holds the device while the host queues the
# timed calls (about 50 ms at the H100's clocks: far above the host's time
# to queue 200 launches)
SPIN_CYCLES = 100_000_000


def probe_input(dtype: torch.dtype, rows: int) -> torch.Tensor:
    """The JAX probe's input: normal(0, 0.1) from numpy's seed 0, on the card."""
    x = np.random.default_rng(0).normal(0, 0.1, (rows, 128))
    return torch.from_numpy(x).to(device="cuda", dtype=dtype)


def device_us(fn, reps: int) -> float:
    """Microseconds per call of ``fn()`` on the device: CUDA events around
    ``reps`` calls queued behind a spin kernel, after a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def run(variant: str, rows: int) -> dict:
    """Times K6's ``variant`` on the probe's input of ``rows`` rows and
    prints one line; returns the input, the output, the time and the rate."""
    dtype, approx = vpu_probe.VARIANTS[variant]
    x = probe_input(dtype, rows)
    us = device_us(lambda: vpu_probe.chained_tanh(x, approx), REPS)
    y = vpu_probe.chained_tanh(x, approx)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y.float()).all()):
        raise RuntimeError(f"the probe produced non-finite values in {variant}")
    rate = x.numel() * vpu_probe.ROUNDS / (us * 1e-6)
    print(f"{variant:14s} [{rows}, 128]: {us:9.2f} us/call  {rate / 1e12:.3f} T(tanh.mul.add)/s",
          flush=True)
    return dict(variant=variant, rows=rows, x=x, y=y, us=us, rate=rate)


def rate_ratios(runs) -> dict:
    """bf16's rate over f32's at each size, and over approximate f32's."""
    rate = {(r["variant"], r["rows"]): r["rate"] for r in runs}
    return {"bf16/f32 tile": rate["bfloat16", TILE_ROWS] / rate["float32", TILE_ROWS],
            "bf16/f32 full": rate["bfloat16", FULL_ROWS] / rate["float32", FULL_ROWS],
            "bf16/f32-approx full": (rate["bfloat16", FULL_ROWS]
                                     / rate["float32-approx", FULL_ROWS])}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = [run(variant, rows) for variant, rows in RUNS]
    print("rates: " + ", ".join(f"{k} {v:.3f}" for k, v in rate_ratios(runs).items()), flush=True)


if __name__ == "__main__":
    main()
