#!/usr/bin/env python3
"""Train steps of the HiVT baseline at the YAML's own batch (needs a card).

    python scripts/baseline_step_torch.py [--batch 512] [--fused] [--remat]

Builds ``BASELINE`` (``configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml``, the
dense AA pair chain), or with ``--fused`` ``BASELINE_TRAIN`` (the pair
chain through kernels K3 and K4), with ``--remat`` as ``encoder.remat: true``
(the AA and AL blocks rematerialized in the backward), at the published widths from
``chip_smoke.SEED``, packs ``--batch`` synthetic scenes of both sources
(48 actors, 192 lanes) and takes ``chip_smoke.BASELINE_STEPS`` train steps
on them through phase L's own ``chip_smoke.baseline_train_steps``.  Prints the card's name and power
limit, each step's CUDA-event time, the median of all but the first,
scenes/s and the peak device memory, then one JSON line with every number.
A batch that does not fit prints the out-of-memory error in the JSON line
instead (exit 0: the measurement is the answer).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BASELINE_STEPS, SEED, _remat, _train_batch,  # noqa: E402
                        baseline_train_steps)
from trajsde_tpu_torch.config import BASELINE, BASELINE_TRAIN, build_model  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--fused", action="store_true",
                    help="BASELINE_TRAIN: the AA pair chain through K3 and K4")
    ap.add_argument("--remat", action="store_true",
                    help="encoder.remat: true, the AA and AL blocks recomputed in the backward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the steps run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    scene = _train_batch(np.random.default_rng(SEED + 23), args.batch).to("cuda")
    cfg, path = (BASELINE_TRAIN, "fused") if args.fused else (BASELINE, "dense")
    if args.remat:
        cfg, path = _remat(cfg), path + " remat"
    model = build_model(cfg, device="cuda", seed=SEED)
    report = dict(card=card, batch=args.batch, path=path)
    try:
        times, losses, peak = baseline_train_steps(model, cfg, scene, BASELINE_STEPS)
    except torch.cuda.OutOfMemoryError as e:
        report.update(oom=str(e).splitlines()[0],
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"[baseline-step] {card}: batch {args.batch}, {path}: {report['oom']}", flush=True)
    else:
        ms = statistics.median(times[1:])
        report.update(steps_ms=times, losses=losses, peak_gib=peak, ms=ms,
                      scenes_per_s=args.batch / ms * 1e3)
        print(f"[baseline-step] {card}: batch {args.batch}, {path}: steps "
              + " ".join(f"{t:.1f}" for t in times) + f" ms (CUDA events), median after the "
              f"first {ms:.1f} ms, {report['scenes_per_s']:.1f} scenes/s, peak {peak:.2f} GiB, "
              "loss " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
