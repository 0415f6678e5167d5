"""One rank of ``tests/test_torch_distributed.py``'s data-parallel cases, and
the single-process steps they are held to.

    python tests/_torch_dist_worker.py RANK WORLD WORK_DIR

joins a gloo group through ``file://WORK_DIR/rdzv``, reads
``WORK_DIR/inputs.pt`` (configs, weights, scenes, noise, written by the
test), runs every case on its slices and writes ``WORK_DIR/rank<RANK>.pt``.
Imports the port only (no JAX), on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from trajsde_tpu_torch.config import build_losses, build_metrics, build_model  # noqa: E402
from trajsde_tpu_torch.losses import l2_loss  # noqa: E402
from trajsde_tpu_torch.parallel import mesh  # noqa: E402
from trajsde_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from trajsde_tpu_torch.train.loop import (Trainer, TrainState, create_train_state,  # noqa: E402
                                          make_train_step)

L2 = [("L2", 1.0, l2_loss)]
# the pinned noise's scene axis: encoder [Th, B, A+1, D], twin [B, 1, Th, 2],
# decoder [Tf, B, K, A, D] (rows B-major, so a scene slice is a row slice)
NOISE_AXES = (1, 0, 1)


def model_of(cfg, state_dict):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model.train()


class Pinned(torch.nn.Module):
    """``model``'s training forward on pinned encoder, twin and decoder noise."""

    def __init__(self, model, noise):
        super().__init__()
        self.model, self.noise = model, noise

    def forward(self, scene, generator=None, rollout_seed=None):
        en, tw, de = self.noise
        return self.model(scene, enc_noise=en, twin_noise=tw, dec_noise=de, generator=generator)


def sgd_step(cfg, state_dict, scenes, losses, accum=1, noise=None):
    """One SGD (lr 0.1) update through ``make_train_step``: (model, logs)."""
    model = model_of(cfg, state_dict)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)
    step = make_train_step(model if noise is None else Pinned(model, noise), opt, sched,
                           losses, "cpu", accum_steps=accum)
    return model, step(scenes, 0, 0)


def adamw_steps(cfg, state_dict, scene, steps, zero1=False):
    """``steps`` AdamW updates of the config's optimizer on one batch."""
    model = model_of(cfg, state_dict)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=steps,
                               zero1=zero1)
    step = make_train_step(model, state.optimizer, state.scheduler, L2, "cpu")
    for k in range(steps):
        step(scene, k, 0)
        state.step += 1
    return state


def evaluate(cfg, state_dict, batches):
    """``Trainer.evaluate`` over ``batches``: each metric's (sum, count)."""
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu")
    trainer.evaluate(TrainState(model_of(cfg, state_dict), None, None), lambda: batches)
    return {m.name: (float(m._sum), float(m._count)) for m in trainer.metrics}


class _SignalAt:
    """A logger that sets the trainer's preemption flag once it logs
    ``step`` (a signal that reached this rank alone); ``at=None`` never."""

    def __init__(self, at=None):
        self.at, self.trainer = at, None

    def log_scalars(self, step, values):
        if step == self.at:
            self.trainer.preempted = True


def fit(cfg, state_dict, batches, ckpt_dir, signal_at=None):
    """``Trainer.fit`` of ZeRO-1 AdamW over ``batches`` (val: the same),
    one epoch: (state, trainer)."""
    model = model_of(cfg, state_dict)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=4, zero1=True)
    logger = _SignalAt(signal_at)
    trainer = Trainer(L2, build_metrics(cfg), device="cpu", logger=logger,
                      checkpointer=CheckpointManager(ckpt_dir))
    logger.trainer = trainer
    trainer.fit(state, lambda: batches, lambda: batches[:1], max_epochs=1)
    return state, trainer


def head(batch, n):
    """The first ``n`` scenes of a ``SceneBatch``."""
    return dataclasses.replace(batch, **{
        f.name: None if (v := getattr(batch, f.name)) is None else v[:n]
        for f in dataclasses.fields(batch)})


def params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def local_moments(optimizer):
    """{global parameter index: AdamW state} of the moments this rank holds."""
    inner = getattr(optimizer, "optim", optimizer)
    index = getattr(optimizer, "_param_to_index", None)
    if index is None:
        index = {p: i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    return {index[p]: {k: v.clone() for k, v in s.items()} for p, s in inner.state.items()}


def run(rank: int, world: int, work: str) -> dict:
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    local = lambda x, axis=0: mesh.shard_batch(x, rank, world, axis)  # noqa: E731
    base, base_sd = inp["baseline_cfg"], inp["baseline_sd"]
    out = {}

    for tag in ("even", "uneven"):
        model, logs = sgd_step(base, base_sd, local(inp[tag]), L2)
        out[f"sgd_{tag}"] = dict(params=params(model), total=float(logs["train/total"]))
    # the mean of per-rank means: local normalizers, gradients averaged
    naive = [("L2", 1.0, lambda y, o, counts=None: l2_loss(y, o) / world)]
    model, _ = sgd_step(base, base_sd, local(inp["uneven"]), naive)
    out["sgd_uneven_naive"] = dict(params=params(model))

    model, logs = sgd_step(base, base_sd, [local(inp["even"]), local(inp["uneven"])], L2,
                           accum=2)
    out["accum"] = dict(params=params(model), total=float(logs["train/total"]))
    # a slot of the group that holds scenes on rank 0 alone: rank 1 keeps
    # it empty (second) or has it first, as a batch of no scene
    alone = head(inp["uneven"], 4 if rank == 0 else 0)
    for tag, group in (("second", [local(inp["even"]), alone]),
                       ("first", [alone, local(inp["even"])])):
        model, logs = sgd_step(base, base_sd, group, L2, accum=2)
        out[f"accum_{tag}_empty"] = dict(params=params(model), total=float(logs["train/total"]))

    flag, flag_sd = inp["flagship_cfg"], inp["flagship_sd"]
    noise = [local(n, ax) for n, ax in zip(inp["noise"], NOISE_AXES)]
    model, logs = sgd_step(flag, flag_sd, local(inp["even"]), build_losses(flag), noise=noise)
    out["flagship"] = dict(grads={k: p.grad.clone() for k, p in model.named_parameters()
                                  if p.grad is not None},
                           total=float(logs["train/total"]))

    for zero1 in (False, True):
        state = adamw_steps(base, base_sd, local(inp["even"]), 2, zero1=zero1)
        moments = local_moments(state.optimizer)
        out[f"adamw_zero1={zero1}"] = dict(
            params=params(state.model), moments=moments,
            moment_elements=sum(v.numel() for s in moments.values() for k, v in s.items()
                                if k.startswith("exp_avg")))
        if zero1:
            CheckpointManager(os.path.join(work, "zero1_ckpt")).save(state, None, state.step)
            # a rank other than 0 writes nothing, even to a directory of its own
            CheckpointManager(os.path.join(work, f"probe_rank{rank}")).save(state, None, 0)

    # a signal on rank 1 alone after update 1: both ranks stop after update 2
    batches = [local(inp[k]) for k in ("even", "uneven", "even", "uneven")]
    state, trainer = fit(base, base_sd, batches, os.path.join(work, "preempt"),
                         signal_at=1 if rank == 1 else None)
    out["preempt"] = dict(step=state.step, epochs=len(trainer.epoch_logs),
                          params=params(state.model))
    # rank 1's feed ends after one batch: it joins rank 0's updates with nothing
    state, trainer = fit(base, base_sd, batches[:4 - 3 * rank], os.path.join(work, "ragged"))
    out["ragged"] = dict(step=state.step, params=params(state.model),
                         val=trainer.epoch_logs[-1]["val/ADE_T"])

    out["eval"] = evaluate(base, base_sd, [local(b) for b in inp["eval"]])
    out["cli"] = cli(inp["cli_cfg"], work)
    return out


def cli(cfg_path: str, work: str) -> dict:
    """``train_torch.main --multihost --zero1 --device cpu`` for one epoch,
    then ``--ckpt`` for one more."""
    import torch.distributed as dist

    import train_torch
    from trajsde_tpu_torch.train import logging as tlogging

    # JSONL only: importing tensorboard pulls in TensorFlow (~16 s)
    tlogging._tensorboard_writer = lambda log_dir: None

    common = ["-c", cfg_path, "-n", "cli", "--logdir", os.path.join(work, "logs"),
              "--epochs", "1", "--device", "cpu", "--multihost", "--zero1"]
    state, trainer = train_torch.main(common)
    first = dict(step=state.step, params=params(state.model), epoch=trainer.epoch_logs[-1])
    dist.barrier()   # rank 0's checkpoint is on disk
    ckpt = CheckpointManager(os.path.join(work, "logs", "cli", "checkpoints")).latest()
    state, trainer = train_torch.main(common + ["--ckpt", ckpt["path"]])
    return dict(first=first, resumed_step=state.step, resumed_from=ckpt["step"],
                params=params(state.model), epoch=trainer.epoch_logs[-1])


def main(argv) -> None:
    rank, world, work = int(argv[0]), int(argv[1]), argv[2]
    torch.set_num_threads(1)
    os.environ.update(TRAJSDE_COORDINATOR=f"file://{os.path.join(work, 'rdzv')}",
                      TRAJSDE_NUM_PROCESSES=str(world), TRAJSDE_PROCESS_ID=str(rank))
    mesh.init_multihost(backend="gloo", timeout_s=60)
    try:
        out = run(rank, world, work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
