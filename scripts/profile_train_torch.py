#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port, on one GPU.

    python scripts/profile_train_torch.py [--batch 128] [--runs 5] [--unfused | --fused-encoder]

``FLAGSHIP_TRAIN`` (fused decoder rollout: kernel K1 forward, K2 backward;
``--unfused`` trains through the plain rollout loop instead;
``--fused-encoder`` trains ``FLAGSHIP_TRAIN_FUSED``, whose AA pair chain
runs through kernel K3 forward and K4 backward) at full width
with seeded weights, 48 actors / 192 lanes, synthetic scenes of both
sources.  Prints one JSON line: the host's pack and host->device copy, the
device stages as CUDA-event medians (encoder, aggregator and decoder
forward with autograd recording, the losses, the whole backward, the AdamW
step, the whole ``train_step``), and, from ``torch.profiler`` over three
steps, the device's busy time, its idle share, the top kernels, K1's to
K4's device time, the LayerNorm kernels' time and the peak memory.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from trajsde_tpu_torch.config import (FLAGSHIP_TRAIN, FLAGSHIP_TRAIN_FUSED,  # noqa: E402
                                      build_losses, build_model)
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.server import align_scene  # noqa: E402
from trajsde_tpu_torch.train.loop import create_train_state, make_train_step  # noqa: E402

A, L = 48, 192


def median_ms(fn, runs):
    fn()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(fn, runs):
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--unfused", action="store_true")
    mode.add_argument("--fused-encoder", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    B, R = args.batch, args.runs
    cfg = copy.deepcopy(FLAGSHIP_TRAIN_FUSED if args.fused_encoder else FLAGSHIP_TRAIN)
    cfg["decoder"]["kwargs"]["fused"] = not args.unfused
    model = build_model(cfg, device="cuda", seed=0).train()
    losses = build_losses(cfg)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100)
    rng = np.random.default_rng(0)
    aligned = [align_scene(make_raw_scene(rng, i % 2, num_actors=A, num_lanes=L))[0]
               for i in range(B)]
    host = {"pack": host_ms(lambda: pack_scenes(aligned, A, L), R)}
    cpu_scene = pack_scenes(aligned, A, L)
    host["to_device"] = host_ms(lambda: cpu_scene.to("cuda"), R)
    scene = cpu_scene.to("cuda")
    enc, agg, dec = model.encoder, model.aggregator, model.decoder

    def gen():
        return torch.Generator(device="cuda").manual_seed(1)

    def forward():
        return model(scene, generator=gen(), rollout_seed=1)

    def loss_of(out):
        return sum(w * fn(out["y"], out) for _, w, fn in losses)

    with torch.no_grad():   # stage inputs only: no graph kept alive between timings
        local = enc(scene, generator=gen())[0]
        glob = agg(scene, local, gen())
        out = forward()
    device = {
        "encoder_fwd": median_ms(lambda: enc(scene, generator=gen()), R),
        "aggregator_fwd": median_ms(lambda: agg(scene, local, gen()), R),
        "decoder_fwd": median_ms(lambda: dec(scene, local, glob, generator=gen(),
                                             rollout_seed=1), R),
        "losses": median_ms(lambda: loss_of(out), R),
        "forward_and_losses": median_ms(lambda: loss_of(forward()), R),
        "forward_losses_backward": median_ms(lambda: loss_of(forward()).backward(), R),
    }
    device["backward"] = device["forward_losses_backward"] - device["forward_and_losses"]
    model.zero_grad(set_to_none=True)
    loss_of(forward()).backward()
    device["adamw_step"] = median_ms(lambda: state.optimizer.step(), R)
    del out, local, glob
    step = make_train_step(model, state.optimizer, state.scheduler, losses,
                           torch.device("cuda"))
    counter = iter(range(10 ** 6))
    device["train_step"] = median_ms(lambda: step(scene, next(counter), 0), R)
    step_ms = host_ms(lambda: step(cpu_scene.to("cuda"), next(counter), 0), R)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(cpu_scene.to("cuda"), next(counter), 0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]

    def named(word):
        return sum(e.self_device_time_total for e in kernels if word in e.key) / 1e3 / 3

    report = {
        "card": card, "batch": B, "actors": A, "lanes": L, "runs": R,
        "decoder": "unfused loop" if args.unfused else "fused (K1 + K2)",
        "aa_encoder": "fused (K3 + K4)" if args.fused_encoder else "dense",
        "host_ms": host, "device_ms": device,
        "train_step_host_ms": step_ms, "scenes_per_s": B / step_ms * 1e3,
        "profiled_step_wall_ms": wall,
        "device_busy_ms": busy if busy > 0 else None,
        "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
        "k1_rollout_ms": named("rollout_kernel"), "k2_rollout_bwd_ms": named("rollout_bwd_kernel"),
        "k3_aa_fused_ms": named("aa_fused_kernel"), "k4_aa_fused_bwd_ms": named("aa_fused_bwd"),
        "layer_norm_ms": named("layer_norm"),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 / 3 for e in top},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
