"""Data parallelism over processes (``trajsde_tpu/parallel/mesh.py``).

The reference trains with Lightning DDP over NCCL; the JAX package builds a
``data`` mesh over every chip of one process and lets XLA insert the
gradient ``psum``.  The port is one process per GPU, the PyTorch idiom:
``torch.distributed`` joins the processes (NCCL on CUDA, gloo on the CPU),
each rank trains on a contiguous slice of every global batch, and the train
step sums the gradients, the loss normalizers and the logs over the ranks
(``train/loop.py``).

The JAX module's ``scene_sharding`` / ``replicated`` / ``mode_sharding``
have no counterpart here: with one process per GPU a replicated tensor is
simply every rank holding the module, and a scene-sharded batch is each
rank's own slice (:func:`shard_batch`).  ``constrain_modes`` (a ``model``
axis over the prediction modes) is not ported.

Outside an initialized process group every helper answers as a single
process (rank 0 of 1), so the same code runs everywhere.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from trajsde_tpu_torch.ops.sde_rollout import mix_seed

# the counter that folds a rank into a step's seed lies far above the ones
# the step folds in itself (1 for ts_drop, 2 + i for micro-batch i)
RANK_FOLD = 0x40000000


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def coordinator_from_env() -> Optional[str]:
    """The rendezvous the environment names: ``TRAJSDE_COORDINATOR``
    (``host:port`` or a URL such as ``file:///path``), else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``; None when neither is set."""
    addr = os.environ.get("TRAJSDE_COORDINATOR")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: Optional[float] = None) -> int:
    """Join the process group; returns the world size.

    The address, the process count and this process's rank come from the
    arguments, else from ``TRAJSDE_COORDINATOR`` / ``TRAJSDE_NUM_PROCESSES``
    / ``TRAJSDE_PROCESS_ID`` (the JAX package's variables), else from
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
    A single process with no coordinator is a no-op that returns 1.
    ``backend`` defaults to ``nccl`` when CUDA is available and ``gloo``
    otherwise; a backend that fails to start raises (no fallback).  On CUDA
    the process first takes ``cuda:LOCAL_RANK`` as its current device (the
    kernels launch on the current device), ``LOCAL_RANK`` defaulting to the
    rank modulo the card count.  A process already in a group stays in it.
    """
    if distributed():
        return world()
    num = num_processes if num_processes is not None else (
        _env_int("TRAJSDE_NUM_PROCESSES", "WORLD_SIZE") or 1)
    addr = coordinator_address or coordinator_from_env()
    if num <= 1 and not addr:
        return 1
    if not addr:
        raise ValueError(f"{num} processes but no coordinator: set TRAJSDE_COORDINATOR "
                         "(host:port) or launch through torchrun")
    rank_ = process_id if process_id is not None else (
        _env_int("TRAJSDE_PROCESS_ID", "RANK") or 0)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank(rank_))
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=num, rank=rank_, **kwargs)
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if distributed():
        dist.destroy_process_group()


def distributed() -> bool:
    """Whether this process is in a process group (of any size, 1 included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def is_primary() -> bool:
    """Rank 0 owns the run directory's side effects (logs, checkpoints)."""
    return rank() == 0


def local_rank(rank_: Optional[int] = None) -> int:
    """``LOCAL_RANK``, else the rank modulo the local card count."""
    env = _env_int("LOCAL_RANK")
    if env is not None:
        return env
    r = rank() if rank_ is None else rank_
    return r % max(1, torch.cuda.device_count())


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA run, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and distributed():
        return torch.device("cuda", local_rank())
    return dev


def ranks_for_batch(batch_size: int, world_size: int) -> int:
    """The ranks a global batch of ``batch_size`` scenes spreads over: all
    of them, since every rank takes part in every collective
    (``make_mesh_for_batch``'s multi-process rule).  A batch the world size
    does not divide raises, naming both numbers."""
    if world_size > 1 and batch_size % world_size:
        raise ValueError(
            f"batch size {batch_size} does not split over {world_size} ranks; pick a "
            f"batch size divisible by {world_size} (or run fewer processes)")
    return world_size


def shard_bounds(n: int, rank_: int, world_size: int) -> slice:
    """Rank ``rank_``'s contiguous share of ``n`` items, as ``torch.tensor_split``
    cuts them: the first ``n % world_size`` ranks take one more."""
    base, extra = divmod(n, world_size)
    start = rank_ * base + min(rank_, extra)
    return slice(start, start + base + (rank_ < extra))


def shard_batch(batch, rank_: int, world_size: int, batch_axis: int = 0):
    """This rank's contiguous slice of the scene axis of ``batch``: a
    tensor, a dataclass of tensors (a ``SceneBatch``; None fields stay
    None), or a list / tuple of them.  A short batch splits as evenly as
    it goes, so a rank may get no scene."""
    if batch is None:
        return None
    if isinstance(batch, torch.Tensor):
        idx = shard_bounds(batch.shape[batch_axis], rank_, world_size)
        return batch.narrow(batch_axis, idx.start, idx.stop - idx.start)
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(b, rank_, world_size, batch_axis) for b in batch)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: shard_batch(getattr(batch, f.name), rank_, world_size, batch_axis)
            for f in dataclasses.fields(batch)})
    raise TypeError(f"cannot shard a {type(batch).__name__}")


def rank_seed(seed: int) -> int:
    """``seed`` with this rank folded in, so ranks draw independent streams;
    ``seed`` itself in a world of one."""
    return seed if world() == 1 else mix_seed(seed, RANK_FOLD + rank())


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, through one coalesced
    buffer: a single collective for the lot.  Outside a process group
    (a world of one) it does nothing."""
    if not tensors or not distributed():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def zero1_adamw(param_groups: List[dict], **adamw_kwargs):
    """ZeRO-1 (``zero1_sharding`` / ``shard_opt_state``): AdamW whose
    moments are partitioned over the ranks, each rank updating the
    parameters it owns and broadcasting them to the others.  The param
    groups (and so the weight-decay mask) are kept; a consolidated
    ``state_dict`` has the plain AdamW layout, so checkpoints do not depend
    on the world size.  Needs a process group."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if not distributed():
        raise RuntimeError("ZeRO-1 partitions AdamW over the ranks of a process group; "
                           "call init_multihost first")
    return ZeroRedundancyOptimizer(param_groups, optimizer_class=torch.optim.AdamW,
                                   **adamw_kwargs)
