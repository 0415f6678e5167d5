#!/usr/bin/env python3
"""How far a graphed chained train step (``train_torch.py --chain``) drifts
from the eager step on one GPU, entry by entry, for any build, and which
kernels a profiled graphed chain runs.

    python scripts/chain_gap_torch.py [--config FLAGSHIP_H100] [--batch 128] \\
        [--updates 2 4 8] [--seed 0]

The build ``--config`` (a name in ``trajsde_tpu_torch.config``) from one
seed, trained twice on the same synthetic full-width batches (48 actors,
192 lanes): by ``ChainedStep`` (each update one CUDA-graph replay) and by
``make_train_step``, in chains that end after each count of ``--updates``.
After each: the largest weight differences outside the key-bias entries
(``optim.noise_entries``) and on them, the median leaf, the distance of
the unchanged state (the least over the trained leaves) and of an update
of the wrong sign from the eager weights, each leaf's L2 distance over
how far the eager steps moved it (``optim.leaf_rel_gaps``), and
``optim.chain_eager_gap`` in the build's dtype beside ``chain_eager_bound``
(up to 4 updates).  After the first,
the largest |gradient| on the key-bias entries and the least leaf's
outside them (``optim.grad_split``).  Then one more graphed chain under
``torch.profiler``: each hand-written kernel's instantiations by the
names the trace prints, and how often each ran.  These readings set
``optim.chain_eager_bound``.  Prints the card's ``nvidia-smi`` name and power
limit first, and ends with one JSON line of the readings.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trajsde_tpu_torch import config as tconfig  # noqa: E402
from trajsde_tpu_torch import ops  # noqa: E402
from trajsde_tpu_torch.config import build_dtype, build_losses, build_model  # noqa: E402
from trajsde_tpu_torch.data.pack import pack_scenes  # noqa: E402
from trajsde_tpu_torch.data.synthetic import make_raw_scene  # noqa: E402
from trajsde_tpu_torch.server import align_scene  # noqa: E402
from trajsde_tpu_torch.train.loop import (ChainedStep, create_train_state,  # noqa: E402
                                          make_train_step)
from trajsde_tpu_torch.train.optim import (chain_eager_bound, chain_eager_gap,  # noqa: E402
                                           grad_split, largest_gap, leaf_rel_gaps,
                                           noise_entries)

# the flagship's full width: 48 actors, 192 lanes a scene
NUM_ACTORS, NUM_LANES = 48, 192


def full_width_batches(n: int, batch: int, seed: int, device) -> list:
    """``n`` packed batches of ``batch`` synthetic scenes of both sources."""
    rng = np.random.default_rng(seed + 61)
    return [pack_scenes([align_scene(make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS,
                                                    num_lanes=NUM_LANES))[0]
                         for i in range(batch)], NUM_ACTORS, NUM_LANES).to(device)
            for _ in range(n)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="FLAGSHIP_H100")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--updates", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chain_gap_torch.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, cuda = getattr(tconfig, args.config), torch.device("cuda")
    dtype, lr = build_dtype(cfg), cfg["training_specific"]["lr"]
    ends = sorted(set(args.updates))
    batches = full_width_batches(ends[-1], args.batch, args.seed, cuda)
    losses = build_losses(cfg)
    start = build_model(cfg, device=cuda, seed=args.seed).state_dict()
    noise = noise_entries(start)
    runs = {}
    for mode in ("chained", "eager"):
        state = create_train_state(build_model(cfg, device=cuda, seed=args.seed),
                                   cfg["training_specific"], steps_per_epoch=64, seed=args.seed)
        make = ChainedStep if mode == "chained" else make_train_step
        runs[mode] = (state, make(state.model, state.optimizer, state.scheduler, losses, cuda))
    (sg, chained), (se, eager) = runs["chained"], runs["eager"]
    print(f"{args.config} ({dtype}, lr {lr}) at batch {args.batch}: key-bias entries "
          + ", ".join(f"{k}[{'' if sl == slice(None) else f'{sl.start}:{sl.stop}'}]"
                      for k, sl in noise.items()), flush=True)
    readings = []
    for end in ends:
        chain = batches[sg.step:end]
        chained(chain, sg.step, sg.seed)
        sg.step += len(chain)
        for b in chain:
            eager(b, se.step, se.seed)
            se.step += 1
        torch.cuda.synchronize()
        got, after = sg.model.state_dict(), se.model.state_dict()
        gaps = sorted(((largest_gap({k: got[k]}, {k: after[k]}, noise)[0], k)
                       for k in after if after[k].is_floating_point()
                       and noise.get(k) != slice(None)), reverse=True)
        grads = {n: p.grad for n, p in se.model.named_parameters()}
        trained = [k for k, g in grads.items() if g is not None and g.abs().max() > 0]
        unchanged = min((largest_gap({k: start[k]}, {k: after[k]}, noise)[0], k)
                        for k in trained if noise.get(k) != slice(None))
        flipped = largest_gap({k: 2 * v - after[k] for k, v in start.items()}, after, noise)[0]
        on_noise = largest_gap(got, after, noise, inside=True)
        rel = leaf_rel_gaps(got, after, start, noise)
        r = dict(updates=end, max=gaps[0][0], leaf=gaps[0][1], median=gaps[len(gaps) // 2][0],
                 noise=on_noise[0], unchanged=unchanged[0], unchanged_leaf=unchanged[1],
                 flipped=flipped, lr=lr, rel=rel[0][0], rel_leaf=rel[0][1],
                 rel_median=rel[len(rel) // 2][0])
        r["gap"] = chain_eager_gap(got, after, start, dtype)[0]
        if end <= 4:
            r["bound"] = chain_eager_bound(lr, end, dtype)
        if end == ends[0]:
            r["grad_noise"], r["grad_least"], r["grad_least_leaf"] = grad_split(grads, noise)
            print(f"  after {end}: the largest |gradient| on the key-bias entries "
                  f"{r['grad_noise']:.3e}, the least leaf outside them {r['grad_least_leaf']} "
                  f"{r['grad_least']:.3e}; no gradient: "
                  f"{[n for n, g in grads.items() if g is None]}", flush=True)
        print(f"after {end} updates: outside the key-bias entries max {r['leaf']} {r['max']:.3e} "
              f"({r['max'] / lr:.4f} lr), median leaf {r['median']:.3e}; on them "
              f"{r['noise']:.3e}; the unchanged state {r['unchanged']:.3e} ({r['unchanged_leaf']}), "
              f"the wrong sign {r['flipped']:.3e}; chain_eager_gap ({dtype}) {r['gap']:.3e}"
              + (f", bound {r['bound']:.3e}" if "bound" in r else ""), flush=True)
        print("  the largest: " + ", ".join(f"{k} {g:.3e}" for g, k in gaps[:10]), flush=True)
        print(f"  per leaf, ||chain - eager|| / ||eager - start|| (L2, outside the key-bias "
              f"entries; an unchanged leaf reads 1, the wrong sign 2): median {r['rel_median']:.3e}, "
              "the largest " + ", ".join(f"{k} {g:.3e}" for g, k in rel[:8]), flush=True)
        readings.append(r)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chained(batches[:ends[0]], sg.step, sg.seed)
        torch.cuda.synchronize()
    names = Counter(e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(re.search(rx, e.name) for rx in ops.TRACE_NAMES.values()))
    print(f"a profiled graphed chain of {ends[0]}: " + "; ".join(
        f"{n} x{c}" for n, c in sorted(names.items())) + f"; pool "
        f"{chained.pool_bytes / 2**30:.2f} GiB, capture {chained.capture_s[0]:.2f} s", flush=True)
    print(json.dumps(dict(card=card, config=args.config, batch=args.batch, dtype=dtype,
                          readings=readings, kernels=dict(names),
                          pool_gib=chained.pool_bytes / 2**30)), flush=True)


if __name__ == "__main__":
    main()
