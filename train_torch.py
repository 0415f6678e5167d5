#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port (``trajsde_tpu_torch``), with
``train.py``'s flags and meaning.

    python train_torch.py -c configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml -n my_run \\
        [--ckpt STEP_DIR | --wonly STEP_DIR] [--epochs N] [--logdir logs] [--seed 0] \\
        [--num-actors A] [--num-lanes L] [--monitor ADE_T] [--profile STEP] [--log-every N] \\
        [--accum K] [--chain C] [--async-ckpt] [--device cuda|cpu] [--multihost [--zero1]]

    torchrun --nproc-per-node N train_torch.py --multihost [--zero1] -c ... -n my_run

Config -> datamodule (``build_datamodule``), model, losses, metrics, AdamW
+ cosine sized by the train loader -> ``Trainer.fit`` under
``<logdir>/<name>/``: ``checkpoints/`` (best-k by ``--monitor`` and the
latest), ``metrics.jsonl``, ``source_snapshot/`` and, with ``--profile``,
``profile/``.  ``--ckpt`` resumes the model, AdamW, the schedule, the step,
the seed and the data stream; ``--wonly`` loads the weights alone.
``--accum K`` takes one optimizer update per K loader batches (the mean
gradient; the schedule counts updates, ``ceil(batches / K)`` an epoch);
``--chain C`` runs C optimizer updates per read of the device: on the card
each update is one replay of a CUDA graph of the train step (captured per
batch layout), on the CPU the same chained update runs uncaptured; logs
are the chain's means, written once per chain (``--log-every`` counts
updates), and a preemption stops after the chain.  Its checkpoints resume
with or without it.  It trains every config the eager step trains
(``encoder.remat`` and ``encoder.adaptive`` included) and refuses
``--multihost``, naming its ROADMAP.md Queue 1 item.  ``--async-ckpt`` writes each epoch's
checkpoint on a thread while the next epoch trains.  SIGTERM or SIGINT
saves an unscored checkpoint (synchronously) and exits cleanly.  The
run is on the card unless ``--device cpu``.  Configs are YAML, or JSON
(``*.json``, which needs no PyYAML).

``--multihost`` trains data-parallel, one process per GPU (``cuda:LOCAL_RANK``;
gloo over the CPU with ``--device cpu``): launch it through torchrun, or
start N processes with ``TRAJSDE_COORDINATOR`` (host:port or a ``file://``
URL), ``TRAJSDE_NUM_PROCESSES`` and ``TRAJSDE_PROCESS_ID`` set.  The
config's batch size is the global batch, which the process count must
divide; each rank trains on its slice, and every update applies the
global batch's gradient on every rank.  Rank 0 alone writes the run
directory.  ``--zero1`` partitions AdamW's moments over the ranks; its
checkpoints resume with or without it, on any number of ranks.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

# what --chain C > 1 does not run with yet, and the ROADMAP.md Queue 1 item
# that ports it
NOT_PORTED = {
    "--multihost": "item 5f (the update's collectives inside a CUDA graph)",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-n", "--name", required=True)
    p.add_argument("--ckpt", default=None, help="resume the full training state")
    p.add_argument("--wonly", default=None, help="weights-only warm start")
    p.add_argument("--epochs", type=int, default=None,
                   help="epochs to run (default: the config's max_epochs)")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--monitor", default="ADE_T")
    p.add_argument("--num-actors", type=int, default=None,
                   help="actor capacity per scene (overrides the config)")
    p.add_argument("--num-lanes", type=int, default=None,
                   help="lane capacity per scene (overrides the config)")
    p.add_argument("--seed", type=int, default=0,
                   help="weights, every step's draws, and the data order unless the "
                   "config sets its own")
    p.add_argument("--profile", type=int, default=None, metavar="STEP",
                   help="torch.profiler trace of 5 steps from STEP (<run_dir>/profile)")
    p.add_argument("--log-every", type=int, default=1, help="train-scalar log cadence")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation: K loader batches per optimizer update")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints on a thread while training goes on (preemption "
                   "saves stay synchronous)")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel over processes, one per GPU: join the process group "
                   "named by torchrun or TRAJSDE_COORDINATOR / TRAJSDE_NUM_PROCESSES / "
                   "TRAJSDE_PROCESS_ID")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: partition AdamW's moments over the --multihost ranks")
    p.add_argument("--chain", type=int, default=1,
                   help="C optimizer updates per read of the device (on the card, each one "
                   "replay of a CUDA graph of the step); logs and the stop flag once per chain")
    args = p.parse_args(argv)
    if args.chain > 1 and (args.multihost or args.zero1):
        _refuse_chain("--multihost")
    return args


def _refuse_chain(what: str) -> None:
    raise SystemExit(f"--chain with {what} is not ported to trajsde_tpu_torch yet: "
                     f"ROADMAP.md Queue 1 {NOT_PORTED[what]}")


def ts_drop_rate(cfg: dict) -> float:
    """The config's ``ts_drop`` as a rate in [0, 1) (absent or false: 0)."""
    value = cfg.get("model_specific", {}).get("kwargs", {}).get("ts_drop")
    if value in (None, False):
        return 0.0
    if value is True or not 0.0 <= float(value) < 1.0:
        # the reference's `rand > (1 - ts_drop)` has the same degeneracy:
        # rate 1 (or true) deletes the whole history
        raise SystemExit("config error: ts_drop must be a drop RATE in [0, 1) (e.g. 0.1), "
                         f"got {value!r}; rate 1.0 would zero every historical step")
    return float(value)


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns ``(state, trainer)``."""
    args = parse_args(argv)
    from trajsde_tpu_torch.parallel import mesh

    if args.zero1 and not args.multihost:
        raise SystemExit("--zero1 partitions AdamW over the ranks of --multihost; add "
                         "--multihost (one process per GPU)")
    if args.multihost:
        if mesh.coordinator_from_env() is None:
            raise SystemExit("--multihost needs a rendezvous: launch through torchrun "
                             "--nproc-per-node N, or set TRAJSDE_COORDINATOR (host:port or "
                             "file:///path), TRAJSDE_NUM_PROCESSES and TRAJSDE_PROCESS_ID")
        world = mesh.init_multihost(
            backend="gloo" if args.device.startswith("cpu") else None)
        print(f"multihost: rank {mesh.rank()} of {world}", flush=True)

    from trajsde_tpu_torch.config import (build_datamodule, build_losses, build_metrics,
                                          build_model, load_config)
    from trajsde_tpu_torch.device import resolve_device
    from trajsde_tpu_torch.train.checkpoint import CheckpointManager
    from trajsde_tpu_torch.train.logging import ExperimentLogger, ProfilerHook, snapshot_sources
    from trajsde_tpu_torch.train.loop import Trainer, create_train_state

    cfg = load_config(args.config)
    rate = ts_drop_rate(cfg)
    device = resolve_device(mesh.local_device(args.device))
    # only rank 0 owns the run directory's side effects (train.py's rule)
    primary = mesh.is_primary()
    run_dir = os.path.join(args.logdir, args.name)
    if primary:
        os.makedirs(run_dir, exist_ok=True)
        snapshot_sources(run_dir)

    datamodule = build_datamodule(cfg, seed=args.seed, num_actors=args.num_actors,
                                  num_lanes=args.num_lanes, rank=mesh.rank(),
                                  world=mesh.world())
    mesh.ranks_for_batch(datamodule.train_batch_size, mesh.world())
    accum = max(1, args.accum)
    # the schedule advances once per optimizer update: ceil(batches / K) an
    # epoch (train.py; a bucketing loader's partial groups may add a few)
    updates_per_epoch = -(-max(1, len(datamodule.train_loader())) // accum)
    model = build_model(cfg, device=device, seed=args.seed)
    state = create_train_state(model, cfg["training_specific"], updates_per_epoch,
                               seed=args.seed, zero1=args.zero1)
    checkpointer = CheckpointManager(os.path.join(run_dir, "checkpoints"),
                                     async_save=args.async_ckpt)
    if args.ckpt:
        checkpointer.restore(state, args.ckpt)
        # continue the data stream too: the next epoch's shuffle and flips
        datamodule.train_dataset.epoch = state.step // updates_per_epoch
    elif args.wonly:
        checkpointer.restore_params(state.model, args.wonly)

    val_args = cfg.get("datamodule_specific", {}).get("kwargs", {}).get("val_dataset_args") or {}
    logger = ExperimentLogger(run_dir) if primary else None
    trainer = Trainer(
        build_losses(cfg), build_metrics(cfg), device=device, logger=logger,
        checkpointer=checkpointer, monitor=args.monitor,
        is_gtabs=val_args.get("is_gtabs", True), log_every=max(1, args.log_every),
        ts_drop_rate=rate, accum_steps=accum, chain_steps=max(1, args.chain),
        profiler=(ProfilerHook(run_dir, args.profile)
                  if args.profile is not None and primary else None),
    )
    epochs = (args.epochs if args.epochs is not None
              else cfg["training_specific"].get("max_epochs", 1))
    try:
        trainer.fit(state, datamodule.train_loader, datamodule.val_loader, max_epochs=epochs)
    finally:
        if logger is not None:
            logger.close()
    return state, trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        from trajsde_tpu_torch.parallel.mesh import shutdown

        shutdown()
