#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port, on one GPU.

    python scripts/profile_train_torch.py [--batch 128] [--runs 5] [--unfused | --fused-encoder]
                                          [--bf16] [--loader {npz,shards} ...] [--rounds 4]

``FLAGSHIP_TRAIN`` (fused decoder rollout: kernel K1 forward, K2 backward;
``--unfused`` trains through the plain rollout loop instead;
``--fused-encoder`` trains ``FLAGSHIP_TRAIN_FUSED``, whose AA pair chain
runs through kernel K3 forward and K4 backward; ``--bf16`` sets
``dtype: bfloat16`` on the encoder, the aggregator and the decoder, as
``FLAGSHIP_BF16`` does, on the dense AA path) at full width
with seeded weights, 48 actors / 192 lanes, synthetic scenes of both
sources.  Prints one JSON line: the host's pack and host->device copy, the
device stages as CUDA-event medians (encoder, aggregator and decoder
forward with autograd recording, the losses, the whole backward, the AdamW
step, the whole ``train_step``), and, from ``torch.profiler`` over three
steps, the device's busy time, its idle share, the top kernels, K1's to
K4's device time, the LayerNorm kernels' time, the device time of the
kernel groups (``kernel_groups``) and the kernel launches per step, and the
peak memory.

``--loader npz shards`` also writes ``runs + 1`` batches of synthetic
scenes of both sources as per-scene ``.npz``, converts them to shards, and
times the host-clock step trained from each format through the port's
data module (``build_datamodule``: the YAML's capacities, flips and 2
worker processes), with and without the feed to the card
(``device_prefetch``), beside the step on batches packed beforehand, with
and without the feed, and with each batch loaded and packed in line, in
turns in one process (``rounds`` rounds, forwards then backwards); the
consumer's wait per step; the load + align + flip and the pack of one
batch per format and the interval at which the workers can supply a
batch; and the device's idle share over three steps fed from the loader.
Every time is on the card named in ``card`` (``nvidia-smi``'s name and
power limit).
"""
from __future__ import annotations

import argparse
import contextlib
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

from trajsde_tpu_torch.config import (FLAGSHIP_TRAIN, FLAGSHIP_TRAIN_FUSED,  # noqa: E402
                                      build_datamodule, build_losses, build_model)
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.scene import strip_for_device  # noqa: E402
from trajsde_tpu_torch.data.shards import convert_npz_dir  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.server import align_scene  # noqa: E402
from trajsde_tpu_torch.train.loop import (create_train_state, device_prefetch,  # noqa: E402
                                          make_train_step)

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


def profiled(fn, steps=3):
    """(wall ms per step, device busy ms per step, CUDA kernel averages) of
    ``steps`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return wall, busy, kernels


# kernel groups by a word of the kernel's name, the first that matches
KERNEL_GROUPS = (("matmul", ("gemm", "cutlass", "xmma", "cublas")), ("layer_norm", ("layer_norm",)),
                 ("reduction", ("reduce_kernel",)), ("copy_or_cast", ("copy_kernel",)),
                 ("elementwise", ("elementwise_kernel",)))


def kernel_groups(kernels, calls: int) -> tuple:
    """(device ms per call of each of KERNEL_GROUPS and "other", kernel
    launches per call) of the profiler's CUDA kernel averages over ``calls``
    calls."""
    ms = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for e in kernels:
        key = e.key.lower()
        group = next((g for g, words in KERNEL_GROUPS if any(w in key for w in words)), "other")
        ms[group] += e.self_device_time_total / 1e3 / calls
    return ms, sum(e.count for e in kernels) / calls


def write_scene_files(root: str, n: int) -> None:
    """``n`` synthetic scenes of both sources as per-scene ``.npz`` under
    ``root/npz/<domain>/train``, converted to shards under ``root/shards``."""
    rng = np.random.default_rng(1)
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        npz_dir = os.path.join(root, "npz", name, "train")
        os.makedirs(npz_dir)
        for i in range(n // 2):
            np.savez(os.path.join(npz_dir, f"scene_{i:06d}.npz"),
                     **make_raw_scene(rng, src, num_actors=A, num_lanes=L))
        convert_npz_dir(npz_dir, os.path.join(root, "shards", name, "train"))


def loader_report(formats, cfg, B, R, rounds, step, counter):
    """The step fed from files beside the step on batches packed before the
    clock starts, in turns in this process (forwards, then backwards,
    ``rounds`` times; each turn the median of R steps after one that takes
    the first batch):

      prepacked       two batches packed beforehand, ``strip_for_device(b)
                      .to("cuda")`` in the step's thread;
      prepacked_fed   the same batches through ``device_prefetch``;
      loader_<fmt>    the data module's training loader (the YAML's
                      capacities and flips, 2 worker processes; a new epoch
                      each turn), copied in the step's thread;
      loader_<fmt>_fed  the same loader through ``device_prefetch``;
      in_line_<fmt>   each batch loaded and packed in the step's thread.
    """
    n = (R + 1) * B
    with tempfile.TemporaryDirectory() as d:
        write_scene_files(d, n)
        dms = {fmt: build_datamodule(cfg, seed=0, train_batch_size=B, num_actors=A,
                                     num_lanes=L, nu_dir=os.path.join(d, fmt, "nuScenes"),
                                     Argo_dir=os.path.join(d, fmt, "Argoverse"))
               for fmt in formats}
        host = {}
        for fmt, dm in dms.items():
            ds, load, pack = dm.train_dataset, [], []
            for k in range(R):
                t0 = time.perf_counter()
                scenes = [ds[i] for i in range(k * B, (k + 1) * B)]
                t1 = time.perf_counter()
                pack_scenes(scenes, A, L)
                load.append(1e3 * (t1 - t0))
                pack.append(1e3 * (time.perf_counter() - t1))
            per_batch = statistics.median(load) + statistics.median(pack)
            host[fmt] = {"load_align_flip_ms": statistics.median(load),
                         "pack_ms": statistics.median(pack), "workers": dm.num_workers,
                         # a worker loads and packs a whole batch; W of them
                         # deliver one every per_batch / W ms
                         "supply_interval_ms": per_batch / dm.num_workers}
        ds = next(iter(dms.values())).train_dataset
        prepacked = [pack_scenes([ds[i] for i in range(k * B, (k + 1) * B)], A, L)
                     for k in range(2)]

        def to_card(b):
            return strip_for_device(b).to("cuda")

        def timed(batches, move):
            """(median step ms, median wait ms) of R steps, after one that
            takes the first batch (the loader's start)."""
            with contextlib.closing(batches):
                step(move(next(batches)), next(counter), 0)
                torch.cuda.synchronize()
                steps, waits = [], []
                for _ in range(R):
                    t0 = time.perf_counter()
                    batch = next(batches)
                    t1 = time.perf_counter()
                    step(move(batch), next(counter), 0)
                    torch.cuda.synchronize()
                    steps.append(1e3 * (time.perf_counter() - t0))
                    waits.append(1e3 * (t1 - t0))
            return statistics.median(steps), statistics.median(waits)

        def listed():
            return (prepacked[k % 2] for k in range(R + 1))

        def in_line(ds):
            for k in range(R + 1):
                yield pack_scenes([ds[i] for i in range(k * B, (k + 1) * B)], A, L)

        variants = {"prepacked": lambda: timed(listed(), to_card),
                    "prepacked_fed": lambda: timed(device_prefetch(listed(), "cuda"),
                                                   lambda b: b)}
        for fmt, dm in dms.items():
            variants[f"loader_{fmt}"] = lambda dm=dm: timed(iter(dm.train_loader()), to_card)
            variants[f"loader_{fmt}_fed"] = lambda dm=dm: timed(
                device_prefetch(dm.train_loader(), "cuda"), lambda b: b)
            variants[f"in_line_{fmt}"] = lambda dm=dm: timed(in_line(dm.train_dataset),
                                                             to_card)
        step_ms = {k: [] for k in variants}
        wait_ms = {k: [] for k in variants}
        for r in range(rounds):
            for name in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
                s, w = variants[name]()
                step_ms[name].append(s)
                wait_ms[name].append(w)

        fmt, dm = next(iter(dms.items()))
        with contextlib.closing(device_prefetch(dm.train_loader(), "cuda")) as feed:
            step(next(feed), next(counter), 0)
            wall, busy, _ = profiled(lambda: step(next(feed), next(counter), 0))
    return {
        "formats": host, "rounds": rounds,
        "step_ms": step_ms, "wait_ms": wait_ms,
        "median_step_ms": {k: statistics.median(v) for k, v in step_ms.items()},
        "profiled": {"variant": f"loader_{fmt}_fed", "wall_ms": wall,
                     "device_busy_ms": busy if busy > 0 else None,
                     "device_idle_share": (1.0 - busy / wall) if busy > 0 else None},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--unfused", action="store_true")
    mode.add_argument("--fused-encoder", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="dtype: bfloat16 on the three components (FLAGSHIP_BF16's)")
    ap.add_argument("--loader", nargs="+", choices=("npz", "shards"), default=[],
                    help="also train from files of these formats, in turns with pre-packed batches")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if args.bf16 and args.fused_encoder:
        ap.error("--bf16 runs the dense AA path (bf16 in K3 / K4 is not ported)")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    B, R = args.batch, args.runs
    cfg = copy.deepcopy(FLAGSHIP_TRAIN_FUSED if args.fused_encoder else FLAGSHIP_TRAIN)
    cfg["decoder"]["kwargs"]["fused"] = not args.unfused
    if args.bf16:
        for sec in ("encoder", "aggregator", "decoder"):
            cfg[sec]["kwargs"]["dtype"] = "bfloat16"
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

    torch.cuda.reset_peak_memory_stats()
    wall, busy, kernels = profiled(lambda: step(cpu_scene.to("cuda"), next(counter), 0))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    groups, launches = kernel_groups(kernels, 3)

    def named(word):
        return sum(e.self_device_time_total for e in kernels if word in e.key) / 1e3 / 3

    report = {
        "card": card, "batch": B, "actors": A, "lanes": L, "runs": R,
        "decoder": "unfused loop" if args.unfused else "fused (K1 + K2)",
        "aa_encoder": "fused (K3 + K4)" if args.fused_encoder else "dense",
        "dtype": "bfloat16" if args.bf16 else "float32",
        "host_ms": host, "device_ms": device,
        "train_step_host_ms": step_ms, "scenes_per_s": B / step_ms * 1e3,
        "profiled_step_wall_ms": wall,
        "device_busy_ms": busy if busy > 0 else None,
        "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
        "k1_rollout_ms": named("rollout_kernel"), "k2_rollout_bwd_ms": named("rollout_bwd_kernel"),
        "k3_aa_fused_ms": named("aa_fused_kernel"), "k4_aa_fused_bwd_ms": named("aa_fused_bwd"),
        "layer_norm_ms": named("layer_norm"),
        "kernel_groups_ms": groups, "kernel_launches_per_step": launches,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 / 3 for e in top},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    if args.loader:
        report["loader"] = loader_report(args.loader, cfg, B, R, args.rounds, step, counter)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
