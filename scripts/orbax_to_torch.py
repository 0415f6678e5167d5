#!/usr/bin/env python3
"""Convert a checkpoint that ``train.py`` (the JAX package) wrote into the
PyTorch port's layout, so that ``train_torch.py --ckpt`` resumes it and
``train_torch.py --wonly`` / ``test_torch.py --ckpt`` take its weights.

    python scripts/orbax_to_torch.py -c CONFIG --jax-ckpt RUN/checkpoints/step_XXXXXXXX \\
        --out OUT_DIR [--seed 0] [--accum 1]

It reads the orbax step directory of JAX's ``CheckpointManager`` (the
``TrainState``'s ``params``, ``opt_state``, ``step`` and ``key``), with the
config's model and AdamW as the restore target, and writes
``OUT_DIR/step_XXXXXXXX/state.pt`` (model, optimizer, scheduler, step,
seed) and ``OUT_DIR/leaderboard.json``.  The parameters go through
``trajsde_tpu_torch.bridge.params_from_flax``, the AdamW moments and
counts through ``adamw_state_from_optax``.  The schedule's learning rate
depends on the updates an epoch, ``ceil(batches / accum)`` of the
config's train loader, as ``train.py`` and ``train_torch.py`` size it, so
the data must be where the config says.

JAX's PRNG key has no counterpart in the port: the resumed run draws from
``--seed``.  The script imports JAX, flax, optax and orbax and runs on the
CPU; the port itself never imports them.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", required=True, help="the run's config (YAML or JSON)")
    p.add_argument("--jax-ckpt", required=True, help="a step directory written by train.py")
    p.add_argument("--out", required=True, help="the port's checkpoint directory to write")
    p.add_argument("--seed", type=int, default=0, help="the seed the resumed run draws from")
    p.add_argument("--accum", type=int, default=1, help="train.py's --accum of the run")
    return p.parse_args(argv)


def position_schedule(scheduler, position: int) -> None:
    """Put a ``LambdaLR`` (and its optimizer's learning rates) at update
    ``position``, as ``position`` calls of ``step()`` would."""
    with warnings.catch_warnings():
        # step() before any optimizer.step() warns; nothing is skipped here
        warnings.simplefilter("ignore")
        scheduler.last_epoch = position - 1
        scheduler.step()


def main(argv=None) -> dict:
    args = parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import orbax.checkpoint as ocp

    from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
    from trajsde_tpu.data.synthetic import make_scene_batch
    from trajsde_tpu.train.loop import create_train_state as jax_create_train_state
    from trajsde_tpu.train.optim import build_optimizer as jax_build_optimizer
    from trajsde_tpu_torch.bridge import adamw_state_from_optax, params_from_flax
    from trajsde_tpu_torch.config import build_datamodule, build_model, load_config
    from trajsde_tpu_torch.train.checkpoint import CheckpointManager
    from trajsde_tpu_torch.train.loop import create_train_state

    cfg = load_config(args.config)
    batches = max(1, len(build_datamodule(cfg, seed=args.seed).train_loader()))
    updates = -(-batches // max(1, args.accum))

    # the restore target: train.py's TrainState for this config (the
    # parameter and optimizer trees do not depend on the scene's size)
    jm = jax_build_model(ExperimentConfig(cfg))
    example = make_scene_batch(np.random.default_rng(0), batch_size=2, num_actors=4,
                               num_lanes=4)
    target = jax_create_train_state(jm, jax_build_optimizer(cfg["training_specific"], updates),
                                    example)
    path = os.path.abspath(args.jax_ckpt)
    restored = ocp.StandardCheckpointer().restore(path, target)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731

    model = build_model(cfg, device="cpu", seed=args.seed)
    state = create_train_state(model, cfg["training_specific"], updates, seed=args.seed)
    model.load_state_dict(params_from_flax(to_np(restored.params)))
    opt_sd, position = adamw_state_from_optax(to_np(restored.opt_state), model, state.optimizer)
    state.optimizer.load_state_dict(opt_sd)
    position_schedule(state.scheduler, position)
    state.step = int(np.asarray(restored.step))

    written = CheckpointManager(args.out).save(state, metric=None, step=state.step)
    report = {"jax_ckpt": path, "out": written, "step": state.step,
              "adam_count": int(opt_sd["state"][0]["step"]) if opt_sd["state"] else 0,
              "schedule_position": position, "updates_per_epoch": updates,
              "lr": state.optimizer.param_groups[0]["lr"], "seed": args.seed,
              "parameters": len(model.state_dict())}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
