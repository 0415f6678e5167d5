#!/usr/bin/env python3
"""The two measured choices of the H100 config
(``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml``), each timed in
turns in one process on one GPU.

    python scripts/compare_h100_config_torch.py [--rounds 4] [--runs 7] [--batches 6]
                                                [--workers 2 4]

1. ``decoder.fused``: ``FLAGSHIP_H100`` (the fused AA encoder) with the
   decoder's rollout in kernels K1 + K2 against the unfused rollout loop,
   the same seeded weights, at batch 128 (48 actors / 192 lanes):
   host-clock ms of a train step (synchronized, copy to the card
   included) and of an eval forward, each the median of ``runs`` after one
   warm-up, ``rounds`` rounds with the order reversed every round; peak
   device memory of a train step.
2. ``num_workers``: ``batches`` batches of 128 synthetic scenes of both
   sources written as per-scene npz; one epoch of ``FLAGSHIP_H100`` through
   ``build_datamodule`` (flips on), ``Trainer.fit`` and the feed with each
   worker count, in turns: the trainer's ``perf/batch_wait_ms`` (the
   first step's wait for the workers' start included), the host-clock time
   to the first step's end, and the median host-clock gap between the
   later steps.

Prints one JSON line with the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trajsde_tpu_torch.config import (FLAGSHIP_H100, build_datamodule, build_losses,  # noqa: E402
                                      build_metrics, build_model)
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.server import align_scene  # noqa: E402
from trajsde_tpu_torch.train.loop import (Trainer, create_train_state,  # noqa: E402
                                          make_eval_step, make_train_step)

A, L, B = 48, 192, 128


def host_ms(fn, runs):
    """Median host-clock ms of ``runs`` synchronized calls after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def decoder_turns(rounds, runs):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cpu_scene = pack_scenes([align_scene(make_raw_scene(rng, i % 2, num_actors=A,
                                                        num_lanes=L))[0] for i in range(B)], A, L)
    variants = {}
    for fused in (True, False):
        cfg = copy.deepcopy(FLAGSHIP_H100)
        cfg["decoder"]["kwargs"]["fused"] = fused
        model = build_model(cfg, device=dev, seed=0)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100)
        step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), dev)
        evaluate = make_eval_step(model, build_metrics(cfg), True, dev)
        counter = iter(range(10 ** 6))
        torch.cuda.reset_peak_memory_stats()
        step(cpu_scene.to(dev), next(counter), 0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        variants["fused" if fused else "unfused"] = dict(
            train=lambda s=step, c=counter: s(cpu_scene.to(dev), next(c), 0),
            eval=lambda e=evaluate: e(cpu_scene.to(dev), 0), peak_gib=peak,
            train_ms=[], eval_ms=[])
    order = ["fused", "unfused"]
    for _ in range(rounds):
        for name in order:
            v = variants[name]
            v["train_ms"].append(host_ms(v["train"], runs))
            v["eval_ms"].append(host_ms(v["eval"], runs))
        order.reverse()
    return {name: {k: v[k] for k in ("train_ms", "eval_ms", "peak_gib")}
            | {"train_median_ms": statistics.median(v["train_ms"]),
               "eval_median_ms": statistics.median(v["eval_ms"])}
            for name, v in variants.items()}


class _StepClock:
    def __init__(self):
        self.times = []

    def log_scalars(self, step, values):
        if "train/total" in values:
            self.times.append(time.perf_counter())


def worker_turns(rounds, n_batches, counts):
    cfg = FLAGSHIP_H100
    out = {k: dict(wait_ms=[], first_step_ms=[], step_ms=[]) for k in counts}
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(1)
        for name, src in (("nuScenes", 0), ("Argoverse", 1)):
            os.makedirs(os.path.join(d, name, "train"))
            for i in range(n_batches * B // 2):
                np.savez(os.path.join(d, name, "train", f"scene_{i:06d}.npz"),
                         **make_raw_scene(rng, src, num_actors=A, num_lanes=L))
        model = build_model(cfg, device="cuda", seed=0)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=n_batches)
        order = list(counts)
        for _ in range(rounds):
            for k in order:
                dm = build_datamodule(cfg, nu_dir=os.path.join(d, "nuScenes"),
                                      Argo_dir=os.path.join(d, "Argoverse"), num_workers=k)
                clock = _StepClock()
                trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cuda",
                                  logger=clock)
                t0 = time.perf_counter()
                trainer.fit(state, dm.train_loader, lambda: [], max_epochs=1)
                gaps = np.diff([t0] + clock.times) * 1e3
                out[k]["wait_ms"].append(trainer.epoch_logs[-1]["perf/batch_wait_ms"])
                out[k]["first_step_ms"].append(float(gaps[0]))
                out[k]["step_ms"].append(float(np.median(gaps[1:])))
            order.reverse()
    return {k: v | {key + "_median": statistics.median(v[key]) for key in list(v)}
            for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--workers", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    report = {"card": card, "batch": B, "actors": A, "lanes": L, "rounds": args.rounds,
              "runs": args.runs}
    report["decoder"] = decoder_turns(args.rounds, args.runs)
    torch.cuda.empty_cache()
    report["workers"] = worker_turns(args.rounds, args.batches, args.workers)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
