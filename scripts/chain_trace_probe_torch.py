#!/usr/bin/env python3
"""Whether ``torch.profiler`` sees every kernel of a graphed chain (needs a card).

    python scripts/chain_trace_probe_torch.py [--runs 12] [--builds adaptive remat]

For each build (``FLAGSHIP_H100`` with ``encoder.adaptive: true``, a graph
of about 64,000 nodes an update, or with ``encoder.remat: true``, about
8,000) at batch 128 it captures ``ChainedStep``'s graph with one chain of
``chip_smoke.ADAPTIVE_CHAIN`` updates, then replays the chain ``--runs``
times, each under the profiler as ``chip_smoke.py``'s phase U traces it
(``chip_smoke._traced``), and prints whether the kernels counted by name
in the trace equal the launch counters, with the device's busy time and
the profiled wall time.  Exits non-zero if any trace disagrees.  Set
``KINETO_LOG_LEVEL=1`` to see the profiler's record counts per trace.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from trajsde_tpu_torch.config import FLAGSHIP_H100, build_losses, build_model  # noqa: E402
from trajsde_tpu_torch.ops import build  # noqa: E402
from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state  # noqa: E402

BUILDS = {"adaptive": lambda: cs._adaptive(FLAGSHIP_H100), "remat": lambda: cs._remat(FLAGSHIP_H100)}


def probe(name: str, cfg, batches, runs: int) -> int:
    """Traces ``runs`` replays of ``cfg``'s graphed chain; returns the
    number whose trace disagrees with the counters."""
    state = create_train_state(build_model(cfg, device="cuda", seed=cs.SEED),
                               cfg["training_specific"], steps_per_epoch=64, seed=cs.SEED)
    step = ChainedStep(state.model, state.optimizer, state.scheduler, build_losses(cfg),
                       torch.device("cuda"), accum_steps=1, graphs=True)
    counter = [0]

    def run():
        step(batches, counter[0], cs.SEED)
        counter[0] += len(batches)

    run()  # the capture
    torch.cuda.synchronize()
    print(f"{name}: the graph's nodes {step.graph_nodes}", flush=True)
    bad = 0
    for i in range(runs):
        t = cs._traced(run)
        same = t["traced"] == t["counted"]
        bad += not same
        print(f"{name} {i}: " + ("the trace equals the counters" if same else
                                 f"MISMATCH: traced {t['traced']}, counted {t['counted']}")
              + f"; busy {t['busy_ms']:.1f} ms of {t['profiled_wall_ms']:.1f}", flush=True)
    print(f"{name}: {bad} of {runs} traces disagree with the counters", flush=True)
    return bad


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=12)
    p.add_argument("--builds", nargs="+", choices=sorted(BUILDS), default=["adaptive", "remat"])
    args = p.parse_args()
    print(cs.phase_device())
    build.load_all(("sde_rollout", "sde_rollout_bwd", "aa_fused", "aa_fused_bwd"))
    rng = np.random.default_rng(cs.SEED)
    batches = [cs._train_batch(rng, cs.TRAIN_BATCH).to("cuda") for _ in range(cs.ADAPTIVE_CHAIN)]
    bad = 0
    for name in args.builds:
        bad += probe(name, BUILDS[name](), batches, args.runs)
        torch.cuda.empty_cache()
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
