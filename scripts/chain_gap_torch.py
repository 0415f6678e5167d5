#!/usr/bin/env python3
"""How far a graphed chained train step (``train_torch.py --chain``) drifts
from the eager step on one GPU, leaf by leaf, and which kernels a profiled
graphed chain runs.

    python scripts/chain_gap_torch.py [--chains 3] [--chain 4] [--batch 128]

``FLAGSHIP_H100`` from one seed, trained twice on the same synthetic
batches: by ``ChainedStep`` (each update one CUDA-graph replay) and by
``make_train_step``.  After each chain: the leaves whose eager gradient is
rounding noise (``optim.noise_leaves``) and each leaf's max|gradient|, the
largest weight differences, those outside the noise leaves; after the
first chain also the distance of the unchanged state and of an update of
the wrong sign from the eager weights.  Then one more graphed chain under
``torch.profiler``: how many times each of K1-K4's kernels ran.  These
readings set ``optim.NOISE_GRAD`` and ``optim.chain_eager_bound``.  Prints
the card's ``nvidia-smi`` name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trajsde_tpu_torch.config import FLAGSHIP_H100, build_losses, build_model  # noqa: E402
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.server import align_scene  # noqa: E402
from trajsde_tpu_torch.train.loop import (ChainedStep, create_train_state,  # noqa: E402
                                          make_train_step)
from trajsde_tpu_torch.train.optim import largest_gap, noise_leaves  # noqa: E402

# the flagship's full width: 48 actors, 192 lanes a scene
NUM_ACTORS, NUM_LANES = 48, 192

KERNELS = ("rollout_kernel", "rollout_bwd_kernel", "aa_fused_kernel", "aa_fused_bwd_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chain_gap_torch.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg, cuda = FLAGSHIP_H100, torch.device("cuda")
    rng = np.random.default_rng(args.seed + 61)
    batches = [pack_scenes([align_scene(make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS,
                                                       num_lanes=NUM_LANES))[0]
                            for i in range(args.batch)], NUM_ACTORS, NUM_LANES).to(cuda)
               for _ in range(args.chain)]
    losses = build_losses(cfg)
    start = build_model(cfg, device=cuda, seed=args.seed).state_dict()
    runs = {}
    for mode in ("chained", "eager"):
        state = create_train_state(build_model(cfg, device=cuda, seed=args.seed),
                                   cfg["training_specific"], steps_per_epoch=64, seed=args.seed)
        make = ChainedStep if mode == "chained" else make_train_step
        runs[mode] = (state, make(state.model, state.optimizer, state.scheduler, losses, cuda))
    (sg, chained), (se, eager) = runs["chained"], runs["eager"]
    for c in range(args.chains):
        chained(batches, sg.step, sg.seed)
        sg.step += len(batches)
        for b in batches:
            eager(b, se.step, se.seed)
            se.step += 1
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in se.model.named_parameters()}
        noise = noise_leaves(grads)
        after = se.model.state_dict()
        gaps = sorted(((largest_gap({k: v}, {k: after[k]})[0], k)
                       for k, v in sg.model.state_dict().items() if after[k].is_floating_point()),
                      reverse=True)
        real = [(g, k) for g, k in gaps if k not in noise]
        print(f"after {sg.step} updates: noise leaves {noise}", flush=True)
        if c == 0:
            largest = sorted((g.abs().max().item(), n) for n, g in grads.items() if g is not None)
            print("  the smallest max|gradient|: " + ", ".join(f"{n} {g:.3e}"
                                                               for g, n in largest[:16]))
            print(f"  no gradient: {[n for n, g in grads.items() if g is None]}")
        print("  the largest weight differences: "
              + ", ".join(f"{k}{' (noise)' if k in noise else ''} {g:.3e}" for g, k in gaps[:12]))
        print(f"  outside the noise leaves: max {real[0][1]} {real[0][0]:.3e}, median "
              f"{real[len(real) // 2][0]:.3e}", flush=True)
        if c == 0:
            moved = sorted((largest_gap({k: start[k]}, {k: after[k]})[0], k)
                           for k in after if k not in noise and grads.get(k) is not None
                           and grads[k].abs().max() > 0)
            flipped = largest_gap({k: 2 * v - after[k] for k, v in start.items()}, after, noise)
            print(f"  the unchanged state: min over the trained leaves {moved[0][0]:.3e} "
                  f"({moved[0][1]}), "
                  f"max {moved[-1][0]:.3e}; an update of the wrong sign {flipped[0]:.3e}",
                  flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chained(batches, sg.step, sg.seed)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"a profiled graphed chain of {len(batches)}: {len(names)} device events; "
          + ", ".join(f"{k} {sum(bool(re.search(rf'\b{k}\b', n)) for n in names)}"
                      for k in KERNELS), flush=True)


if __name__ == "__main__":
    main()
