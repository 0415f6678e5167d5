#!/usr/bin/env python3
"""Where a served batch's time goes in the PyTorch/CUDA port, on one GPU.

    python scripts/profile_serving_torch.py [--batch 128] [--runs 10] [--fused-encoder | --bf16]
                                            [--adaptive]

Flagship model at full width (seeded weights), 48 actors / 192 lanes;
``--fused-encoder`` serves ``FLAGSHIP_FUSED`` instead (``encoder.fused:
true``: the AA pair chain in kernel K3, the same weights), ``--bf16``
``FLAGSHIP_BF16`` (``dtype: bfloat16``, the same weights); ``--adaptive``
sets ``encoder.adaptive: true`` on that config (the ODE-RNN's segments by
step doubling, each segment's Brownian-tree nodes drawn on the card).
Prints one JSON line: host stages (align, pack, host->device copy,
result fetch) on the host clock, device stages (encoder AA attention,
ODE-RNN, AL attention; aggregator; fuse; rollout kernel; heads;
postprocess) as CUDA-event medians, and, from ``torch.profiler`` over
whole ``predict`` calls, the device's busy time, idle share, the time of
its LayerNorm kernels and of each kernel group
(``profile_train_torch.kernel_groups``) and the launches per ``predict``.
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

from profile_train_torch import kernel_groups  # noqa: E402
from trajsde_tpu_torch.config import FLAGSHIP, FLAGSHIP_BF16, FLAGSHIP_FUSED, build_model  # noqa: E402
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.models import graph  # noqa: E402
from trajsde_tpu_torch.models.sde_encoder import gather_eos_outputs  # noqa: E402
from trajsde_tpu_torch.ops.sde_rollout import rollout_params_from_module, sde_rollout  # noqa: E402
from trajsde_tpu_torch.server import ServingEngine, align_scene, make_postprocess  # noqa: E402

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


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fused-encoder", action="store_true",
                      help="serve FLAGSHIP_FUSED (AA pair chain in kernel K3)")
    mode.add_argument("--bf16", action="store_true", help="serve FLAGSHIP_BF16")
    ap.add_argument("--adaptive", action="store_true",
                    help="with encoder.adaptive: true (step-doubling ODE-RNN)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    B, R = args.batch, args.runs
    cfg = copy.deepcopy(FLAGSHIP_FUSED if args.fused_encoder else FLAGSHIP_BF16 if args.bf16
                        else FLAGSHIP)
    cfg["encoder"]["kwargs"]["adaptive"] = args.adaptive
    model = build_model(cfg, device="cuda", seed=0)
    enc, agg, dec = model.encoder, model.aggregator, model.decoder
    rng = np.random.default_rng(0)
    raws = [make_raw_scene(rng, i % 2, num_actors=A, num_lanes=L) for i in range(B)]

    aligned = [align_scene(r)[0] for r in raws]
    host = {
        "align": host_ms(lambda: [align_scene(r) for r in raws], R),
        "pack": host_ms(lambda: pack_scenes(aligned, A, L), R),
    }
    cpu_scene = pack_scenes(aligned, A, L)
    host["to_device"] = host_ms(lambda: cpu_scene.to("cuda"), R)
    scene = cpu_scene.to("cuda")

    gen = torch.Generator(device="cuda").manual_seed(0)
    Th, D = enc.historical_steps, enc.embed_dim
    tw = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    # the fixed grid's pinned draws; the adaptive step draws its trees' nodes
    en = None if args.adaptive else torch.randn((Th, B, A + 1, D), generator=gen, device="cuda")
    aa = enc._aa_with_twin(scene, tw)
    h0 = enc.hidden.expand(B, A + 1, D).to(enc.compute_dtype or torch.float32)
    ys, gs = enc._run_rnn(h0, aa[0], aa[2], aa[3], en)
    out, _, _ = gather_eos_outputs(ys, gs, aa[1], enc.ref_time, scene.agent_index, A)
    al_mask, al_vec = graph.al_edges(scene, enc.ref_time, enc.local_radius)
    local = enc(scene, sde_noise=en, twin_noise=tw)[0]
    glob = agg(scene, local)
    y0 = dec.fuse(scene, local, glob)
    kp = rollout_params_from_module(dec.sde_rollout)
    t0s, dts = dec.time_grid(device="cuda")
    Tf, K = dec.future_steps, dec.num_modes
    y0r = y0.reshape(-1, D).float().contiguous()   # K1's f32 rows, as the engine casts them
    sol = sde_rollout(y0r, kp, t0s, dts, 1, Tf, increments="rademacher")
    sol5 = sol.reshape(Tf, B, K, A, D).permute(1, 2, 3, 0, 4)
    res = dec.decode(scene, sol5, local, glob)
    post = make_postprocess(True, 20)

    device = {
        "encoder_aa": median_ms(lambda: enc._aa_with_twin(scene, tw), R),
        "encoder_ode_rnn": median_ms(lambda: enc._run_rnn(h0, aa[0], aa[2], aa[3], en), R),
        "encoder_eos_al": median_ms(lambda: enc.al_encoder(
            gather_eos_outputs(ys, gs, aa[1], enc.ref_time, scene.agent_index, A)[0],
            graph.lane_features(scene), al_vec, al_mask, scene.rotate_mat()), R),
        "encoder_total": median_ms(lambda: enc(scene, sde_noise=en, twin_noise=tw), R),
        "aggregator": median_ms(lambda: agg(scene, local), R),
        "fuse": median_ms(lambda: dec.fuse(scene, local, glob), R),
        "rollout_kernel": median_ms(lambda: sde_rollout(y0r, kp, t0s, dts, 1, Tf,
                                                        increments="rademacher"), R),
        "heads": median_ms(lambda: dec.decode(scene, sol5, local, glob), R),
        "postprocess": median_ms(lambda: post(scene, res), R),
    }
    post_out = post(scene, res)
    host["fetch_results"] = host_ms(lambda: {k: v.cpu().numpy() for k, v in post_out.items()}, R)

    engine = ServingEngine(model, num_actors=A, num_lanes=L, device="cuda")
    predict_ms = host_ms(lambda: engine.predict(raws), R)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.predict(raws)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    layer_norm = sum(e.self_device_time_total for e in kernels
                     if "layer_norm" in e.key.lower()) / 1e3 / 3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    groups, launches = kernel_groups(kernels, 3)
    report = {
        "card": card, "batch": B, "actors": A, "lanes": L, "runs": R,
        "encoder_fused": args.fused_encoder, "dtype": "bfloat16" if args.bf16 else "float32",
        "encoder_adaptive": args.adaptive,
        "host_ms": host, "device_ms": device, "predict_ms": predict_ms,
        "profiled_predict_wall_ms": wall,
        "device_busy_ms": busy if busy > 0 else None,
        "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
        "layer_norm_ms": layer_norm if busy > 0 else None,
        "kernel_groups_ms": groups, "kernel_launches_per_predict": launches,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 / 3 for e in top},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
