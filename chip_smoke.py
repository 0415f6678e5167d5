#!/usr/bin/env python3
"""Serve the flagship neural-SDE model on one NVIDIA GPU through the
PyTorch/CUDA port (``trajsde_tpu_torch``) and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases (any failure raises and exits non-zero; nothing falls back):
  1. device: require CUDA, print the card's name and power limit, f32
     matmuls in full precision (TF32 off);
  2. build: compile every kernel of the path from ``trajsde_tpu_torch/csrc``;
  3. kernels: the rollout kernel vs its plain version at the row count of
     each served bucket (1, 8, 128: up to 61,440 rows x 60 steps x 64)
     with explicit, Rademacher and gaussian increments; CUDA-event
     medians of both at bucket 128;
  4. serve: a full-width ``ServingEngine`` (48 actors, 192 lanes, K=10,
     seeded weights) answers batches of 1, 5 and 128 scenes; outputs are
     checked and the kernel's launch count must equal the batch count;
  5. splice: one served bucket (kernel rollout) vs the model's own
     forward (plain rollout loop) with the same pinned noise.
The last two lines are a JSON object per kernel and the device line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from trajsde_tpu_torch.config import FLAGSHIP, build_model
from trajsde_tpu_torch.data.pack import pack_scenes, pick_bucket
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.ops import build as kernel_build
from trajsde_tpu_torch.ops import sde_rollout as K1
from trajsde_tpu_torch.server import ServingEngine, align_scene
from trajsde_tpu_torch.serving import make_serving_fn

NUM_ACTORS, NUM_LANES = 48, 192
BATCHES = (1, 5, 128)
SPLICE_BATCH = 8
SEED = 0
# kernel vs plain, 60 f32 steps: tanhf, FMA contraction and cuBLAS
# summation order differ from the plain version
TOL_KERNEL = 1e-4
# served path vs model forward (loc / pi), same pinned noise, full width
TOL_SPLICE = 1e-3
# H100 SXM published peaks (dense): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TIMED_RUNS, WARMUP = 20, 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = WARMUP) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    kernel_build.load("sde_rollout")
    print(f"[build] sde_rollout ready in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in kernel_build.build_log.get("sde_rollout", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("built"):
            print(f"[build]   {line.strip()}")


def rollout_bound(rows: int, steps: int, dim: int, explicit_noise: bool):
    """(bound_ms, bound_by, flops, bytes) of one rollout call: 5 matmuls of
    2*dim^2 plus the 2*dim diffusion output per row-step; y0, the
    weights, the time table (and explicit noise) read once, ys written once."""
    flops = rows * steps * (5 * 2 * dim * dim + 2 * dim)
    weights = 5 * dim * dim + 10 * dim + 4
    nbytes = 4 * (rows * dim + weights + 4 * steps + steps * rows * dim)
    if explicit_noise:
        nbytes += 4 * steps * rows * dim
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _increments(mode: str, noise: torch.Tensor) -> dict:
    return dict(noise=noise, increments="gaussian") if mode == "explicit" else dict(increments=mode)


def phase_kernels(model, buckets) -> dict:
    """The rollout kernel vs its plain version at the row count of every
    bucket the served batches land in; timed at the largest."""
    dec = model.decoder
    T, D = dec.future_steps, dec.local_channels
    shapes = sorted({pick_bucket(n, buckets) * dec.num_modes * NUM_ACTORS for n in BATCHES})
    rows = shapes[-1]
    kp = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    t0s, dts = dec.time_grid(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    noise = torch.randn((T, rows, D), generator=gen, device="cuda")

    errs = []
    for n in shapes:
        y0_n, noise_n = y0[:n].contiguous(), noise[:, :n].contiguous()
        for mode in ("explicit", "rademacher", "gaussian"):
            kw = _increments(mode, noise_n)
            got = K1.sde_rollout(y0_n, kp, t0s, dts, 11, T, **kw)
            torch.cuda.synchronize()
            want = K1.sde_rollout_reference(y0_n, kp, t0s, dts, 11, T, **kw)
            check(bool(torch.isfinite(got).all()), f"sde_rollout ({mode}) produced non-finite values")
            errs.append((got - want).abs().max().item())
            print(f"[kernels] sde_rollout {mode}: max |kernel - plain| = {errs[-1]:.3e} "
                  f"(tol {TOL_KERNEL:g}) over [{T}, {n}, {D}]", flush=True)
            check(errs[-1] < TOL_KERNEL, f"sde_rollout ({mode}) disagrees with its plain version")
            del got, want

    times = {}
    for mode in ("rademacher", "gaussian", "explicit"):
        kw = _increments(mode, noise)
        times[mode] = cuda_ms(lambda: K1.sde_rollout(y0, kp, t0s, dts, 11, T, **kw))
        bound, by, flops, nbytes = rollout_bound(rows, T, D, mode == "explicit")
        print(f"[kernels] sde_rollout {mode}: {times[mode]:.3f} ms (median of {TIMED_RUNS}), "
              f"bound {bound:.3f} ms by {by} ({flops:.3e} flop, {nbytes:.3e} B), "
              f"{flops / times[mode] / 1e9:.1f} TFLOP/s", flush=True)
    plain_ms = cuda_ms(lambda: K1.sde_rollout_reference(y0, kp, t0s, dts, 11, T,
                                                        increments="rademacher"), warmup=1)
    print(f"[kernels] sde_rollout plain version (rademacher): {plain_ms:.3f} ms", flush=True)
    bound, by, _, _ = rollout_bound(rows, T, D, False)
    # the main path draws Rademacher increments in the kernel: its numbers
    return dict(name="sde_rollout", route="cuda", source="trajsde_tpu_torch/csrc/sde_rollout.cu",
                replaces="trajsde_tpu/ops/pallas/sde_rollout.py:452", launches=None,
                max_abs_err=max(errs), ms=times["rademacher"], plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _requests(rng):
    return {n: [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
                for i in range(n)] for n in BATCHES}


def _check_results(results, n, model):
    K, Tf = model.decoder.num_modes, model.decoder.future_steps
    check(len(results) == n, f"{len(results)} results for {n} scenes")
    for r in results:
        check(r["agent_world"].shape == (K, Tf, 2), f"agent_world {r['agent_world'].shape}")
        check(r["agent_pi"].shape == (K,), f"agent_pi {r['agent_pi'].shape}")
        check(r["loc"].shape == (K, NUM_ACTORS, Tf, 2), f"loc {r['loc'].shape}")
        check(r["pi"].shape == (NUM_ACTORS, K), f"pi {r['pi'].shape}")
        for k in ("agent_world", "agent_pi", "loc", "pi"):
            check(bool(np.isfinite(r[k]).all()), f"non-finite {k}")
        check(abs(float(r["agent_pi"].sum()) - 1.0) < 1e-5, "agent_pi does not sum to 1")


def phase_serve(engine, model) -> int:
    rng = np.random.default_rng(SEED)
    requests = _requests(rng)
    engine.predict(requests[1])  # warm-up: CUDA context, cuBLAS handles, allocator

    K1.sde_rollout.launches = 0
    ms = {}
    for n in BATCHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.predict(requests[n])
        ms[n] = 1e3 * (time.perf_counter() - t0)
        _check_results(results, n, model)
    launches = K1.sde_rollout.launches
    print(f"[serve] sde_rollout launches on the main path: {launches} for {len(BATCHES)} batches",
          flush=True)
    check(launches == len(BATCHES), "the rollout kernel did not run once per served batch")

    for n in BATCHES:  # second pass: allocator and kernels warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(requests[n])
        warm = 1e3 * (time.perf_counter() - t0)
        print(f"[serve] batch {n:3d} (bucket {pick_bucket(n, engine.buckets)}): first {ms[n]:.1f} ms, "
              f"again {warm:.1f} ms, {n / warm * 1e3:.1f} scenes/s", flush=True)
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return launches


@torch.inference_mode()
def phase_splice(model) -> None:
    rng = np.random.default_rng(SEED + 1)
    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(SPLICE_BATCH)]
    scene = pack_scenes([align_scene(r)[0] for r in raws], NUM_ACTORS, NUM_LANES).to("cuda")
    enc, dec = model.encoder, model.decoder
    B, A, Th, D = SPLICE_BATCH, NUM_ACTORS, enc.historical_steps, enc.embed_dim
    Tf, Km = dec.future_steps, dec.num_modes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    enc_noise = torch.randn((Th, B, A + 1, D), generator=gen, device="cuda")
    twin_noise = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    dec_noise = torch.randn((Tf, B, Km, A, D), generator=gen, device="cuda")
    served = make_serving_fn(model, "cuda")(
        scene, 0, noise=dec_noise.reshape(Tf, B * Km * A, D), sde_noise=enc_noise,
        twin_noise=twin_noise)
    plain = model(scene, enc_noise=enc_noise, twin_noise=twin_noise, dec_noise=dec_noise)
    for k in ("loc", "pi"):
        err = (served[k] - plain[k]).abs().max().item()
        print(f"[splice] {k}: max |served - forward| = {err:.3e} (tol {TOL_SPLICE:g}) "
              f"over {tuple(plain[k].shape)}", flush=True)
        check(bool(torch.isfinite(served[k]).all()), f"served {k} is not finite")
        check(err < TOL_SPLICE, f"served {k} disagrees with the model forward")


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    model = build_model(FLAGSHIP, device="cuda", seed=SEED)
    engine = ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                           seed=SEED)
    entry = phase_kernels(model, engine.buckets)
    entry["launches"] = phase_serve(engine, model)
    phase_splice(model)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
