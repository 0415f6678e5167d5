"""Training and evaluation loops (``trajsde_tpu/train/loop.py``).

A train step is one eager forward in training mode, the weighted loss sum,
one backward and one AdamW + schedule step; with gradient accumulation it
is a forward and a backward per micro-batch, then one update on the mean
gradient.  Every step's randomness derives on the host from
``(seed, step)`` through ``mix_seed``: a ``torch.Generator`` on the device
seeded with it draws the encoder's noise and the dropout masks, and a
fused decoder's rollout kernel takes the same value as its seed.  So a
run resumed from a checkpoint draws what the uninterrupted run would have
drawn, and no step reads a device scalar to seed anything.

``Trainer.fit`` and ``Trainer.evaluate`` take their batches through
:func:`device_prefetch`, which strips, stages and copies each batch to the
card on a thread and a stream of its own, ahead of the step.  ``fit``
turns SIGTERM and SIGINT into a checkpoint and a clean return
(preemption), and runs an optional ``ProfilerHook`` over a window of
steps.

In a process group (:mod:`trajsde_tpu_torch.parallel.mesh`, one process
per GPU) each rank is fed its slice of every global batch, and the step
computes what the JAX package's sharded step computes: the gradient of the
global batch's loss, applied alike on every rank, and the global batch's
logs and metrics.  Every seed a step derives has the rank folded in
(``mesh.rank_seed``; nothing changes in a world of one).

``Trainer(chain_steps=C)`` (``train.py --chain``) runs C optimizer updates
per read of the device through :class:`ChainedStep`: each update
reads nothing on the host (the NaN guard, AdamW and the schedule run on
the device), and on a card each is one replay of a CUDA graph of the
update.  The logs, the skip count and the schedule's position are read
once, after the chain.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from trajsde_tpu_torch import ops
from trajsde_tpu_torch.data.scene import SceneBatch, strip_for_device
from trajsde_tpu_torch.data.staging import PinnedStager, wait_for_copy
from trajsde_tpu_torch.data.transforms import ts_drop
from trajsde_tpu_torch.device import resolve_device
from trajsde_tpu_torch.losses import batch_counts
from trajsde_tpu_torch.models.decoders import SDEDecoder
from trajsde_tpu_torch.models.sde_encoder import LocalEncoderSDESep, gather_agent
from trajsde_tpu_torch.ops.sde_rollout import key_words, mix_seed
from trajsde_tpu_torch.parallel import mesh
from trajsde_tpu_torch.train.metrics import all_reduce_metrics
from trajsde_tpu_torch.train.optim import DeviceAdamW, build_optimizer

# eval draws derive from (EVAL_SEED, batch index), as the JAX package folds
# its eval key key(12345) with the batch index
EVAL_SEED = 12345


@dataclasses.dataclass
class TrainState:
    """The model, its AdamW and schedule, the optimizer-step count, and the
    seed every step's draws derive from."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0
    seed: int = 0


def create_train_state(model: nn.Module, training_cfg: dict, steps_per_epoch: int,
                       seed: int = 0, zero1: bool = False) -> TrainState:
    """``zero1=True`` partitions AdamW's moments over the process group's
    ranks (:func:`trajsde_tpu_torch.parallel.mesh.zero1_adamw`)."""
    optimizer, scheduler = build_optimizer(model, training_cfg, steps_per_epoch, zero1=zero1)
    return TrainState(model, optimizer, scheduler, 0, int(seed))


def step_generator(device, seed: int, counter: int) -> Tuple[torch.Generator, int]:
    """(a generator on ``device``, the host seed it was seeded with) for
    draw number ``counter`` of a run seeded ``seed``."""
    s = mix_seed(seed, counter)
    return torch.Generator(device=device).manual_seed(s), s


def agent_slices(scene: SceneBatch, output: Dict[str, torch.Tensor], is_gtabs: bool = True):
    """(pred [B, K, Tf, 2], target [B, Tf, 2], reg_mask [B, Tf], source [B]):
    the focal-agent views the metrics read.  ``is_gtabs=False`` (delta
    targets) cumsums prediction and target into the agent frame, without
    undoing the nuScenes grid scaling, as the JAX package does."""
    pred = gather_agent(output["loc"][..., :2], scene.agent_index, axis=2)
    target = gather_agent(output["y"], scene.agent_index, axis=1)
    reg_mask = gather_agent(output["reg_mask"], scene.agent_index, axis=1)
    if not is_gtabs:
        pred = torch.cumsum(pred, dim=-2)
        target = torch.cumsum(target, dim=-2)
    return pred, target, reg_mask, scene.source


def micro_seeds(s: int, n: int) -> List[int]:
    """The seeds of the ``n`` micro-batches of an update whose seed is
    ``s``: ``s`` itself for one, else ``mix_seed(s, 2 + i)`` for micro-batch
    ``i`` (past the 1 that ``ts_drop`` folds in), as the JAX package folds
    the micro index into the step's keys."""
    return [s] if n == 1 else [mix_seed(s, 2 + i) for i in range(n)]


def micro_loss(model: nn.Module, losses: List[Tuple[str, float, Callable]],
               scene: SceneBatch, counts: torch.Tensor, generator: torch.Generator,
               drop_generator: Optional[torch.Generator], rollout_seed,
               ts_drop_rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A micro-batch's weighted loss and its logs' values (the losses, then
    the total), with the model's draws from ``generator``, ``ts_drop``'s
    from ``drop_generator`` and a fused decoder's from ``rollout_seed``;
    its outputs are freed on return, before the backward."""
    if ts_drop_rate:
        scene = ts_drop(scene, ts_drop_rate, drop_generator)
    out = model(scene, generator=generator, rollout_seed=rollout_seed)
    total, values = 0.0, []
    for _, weight, fn in losses:
        value = fn(out["y"], out, counts=counts)
        total = total + weight * value
        values.append(value.detach())
    return total, torch.stack(values + [total.detach()])


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                    losses: List[Tuple[str, float, Callable]], device,
                    ts_drop_rate: float = 0.0, accum_steps: Optional[int] = None) -> Callable:
    """``train_step(scenes, step, seed, stop=False) -> logs``: ``train/<loss>``
    values, ``train/total``, ``train/step_skipped``, ``stop`` and ``scenes``.

    ``scenes`` is a ``SceneBatch``, or a sequence of them: the micro-batches
    of one gradient-accumulation group (``trajsde_tpu/train/loop.py``'s
    ``accum_steps``, which defaults to the group's length).  Each
    micro-batch runs its own forward and backward into ``.grad``, so
    activation memory is one micro-batch's; then the gradients are scaled
    by one over the number of micro-batches that hold a scene, and the
    optimizer and the schedule step once.  The loss and the logs are the
    mean over those micro-batches.  Micro-batch ``i`` draws from its own
    seed (:func:`micro_seeds`).

    ``ts_drop_rate > 0`` drops historical steps (:func:`ts_drop`) with a
    mask drawn on the device from a generator of its own, seeded with
    ``mix_seed(s, 1)`` of the micro-batch's seed ``s`` (the JAX package
    folds the dropout key with 1), so the encoder's noise and the dropout
    masks draw what they draw without it.

    Data parallelism: in a process group (:mod:`~trajsde_tpu_torch.parallel.mesh`)
    every rank calls the step with its slices of the group's micro-batches.
    A slot may hold no scene on a rank (a batch of no scene, or a list
    shorter than ``accum_steps``); that rank runs no forward for it.  Two
    all-reduces an update, none outside a group:

    * before the forward, every slot's normalizers (:func:`batch_counts`),
      so each loss is its share of the global micro-batch's loss (with a
      batch's own counts, every loss gives the bits it gives without);
    * after the backward, every gradient (zeros where this rank has none),
      which leaves have one, the logs and ``stop``.

    So every rank applies the global batch's gradient and takes the same
    NaN-guard decision, and the logs are the global batch's: ``stop`` is
    True when any rank asked to stop, and ``scenes`` counts the update's
    scenes on every rank.  When no rank has a scene the step returns None
    and changes nothing (every feed has ended).

    NaN guard: when the loss or any gradient is non-finite, neither the
    optimizer nor the schedule steps, so the parameters and the AdamW
    moments stay as they were, and ``train/step_skipped`` is 1.  Deciding
    that reads the device once per update.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    names = [f"train/{name}" for name, _, _ in losses] + ["train/total"]
    pinned = torch.device(device).type == "cuda"

    def train_step(scenes: Union[SceneBatch, Sequence[SceneBatch]], step: int, seed: int,
                   stop: bool = False) -> Optional[Dict[str, Any]]:
        micro = [scenes] if isinstance(scenes, SceneBatch) else list(scenes)
        slots = accum_steps or max(1, len(micro))
        if len(micro) > slots:
            raise ValueError(f"a group of {len(micro)} micro-batches; the step was built for "
                             f"accum_steps={accum_steps}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        mine = [i for i, m in enumerate(micro) if m.x.shape[0]]
        none = torch.zeros(2, device=device)
        counts = torch.stack([batch_counts(micro[i]) if i in mine else none
                              for i in range(slots)])
        mesh.all_reduce_([counts])
        if not mine and float(counts[:, 0].sum()) == 0.0:
            return None
        seeds = micro_seeds(mesh.rank_seed(mix_seed(seed, step)), len(micro))
        values = torch.zeros(len(names), device=device)
        for i in mine:
            s = seeds[i]
            drop = (torch.Generator(device=device).manual_seed(mix_seed(s, 1))
                    if ts_drop_rate else None)
            total, logged = micro_loss(model, losses, micro[i], counts[i],
                                       torch.Generator(device=device).manual_seed(s), drop, s,
                                       ts_drop_rate)
            total.backward()
            values = values + logged
        if slots > 1:
            # over the slots that hold a scene on some rank: a group may be short
            inv = 1.0 / (counts[:, 0] > 0).sum()
            values = values * inv
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        # which leaves have a gradient, and the stop flag; copied from pinned
        # memory, so the host does not wait here for the backward to drain
        flags = torch.tensor([float(p.grad is not None) for p in params] + [float(stop)])
        flags = (flags.pin_memory() if pinned else flags).to(device, non_blocking=True)
        mesh.all_reduce_(grads + [values, flags])
        finite = torch.stack([torch.isfinite(values[-1])]
                             + [torch.isfinite(g).all() for g in grads]).all()
        # one read from the device an update
        *has_grad, stops, ok, n_scenes = torch.cat([
            flags, finite[None].float(), counts[:, 0].sum()[None]]).tolist()
        for p, g, has in zip(params, grads, has_grad):
            if has:
                p.grad = g
        if ok:
            optimizer.step()
            scheduler.step()
        logs = dict(zip(names, values.unbind()))
        logs.update({"train/step_skipped": 0.0 if ok else 1.0, "stop": stops > 0,
                     "scenes": int(n_scenes)})
        return logs

    return train_step


@dataclasses.dataclass
class _Captured:
    """One batch layout's CUDA graph of the update: its static inputs, its
    log vector and the launches its capture recorded."""
    graph: Any
    inputs: List[SceneBatch]
    out: torch.Tensor
    launches: List[int]


class ChainedStep:
    """``chained(groups, step, seed, stop=False) -> logs``: one optimizer
    update per group of ``groups`` (``trajsde_tpu/train/loop.py``'s
    ``chained_step``; a group is a ``SceneBatch`` or a list of micro-batches,
    as :func:`make_train_step` takes it), update ``j`` the eager step's
    update at ``step + j``: the same draws from the same seeds
    (``mix_seed``, ``mesh.rank_seed``, :func:`micro_seeds`), the same
    forward, losses, backward and guard.

    :meth:`update` is one update that reads nothing on the host: the
    encoder's noise, the dropout masks and ``ts_drop`` draw from
    generators kept for the step's life and reseeded before each update
    (each draws what the eager step's fresh generator draws); a fused
    decoder's rollout kernels read the update's keys from a device buffer
    (``sde_rollout.rollout_keys``); the NaN guard, AdamW and the schedule
    run on the device (:class:`~trajsde_tpu_torch.train.optim.DeviceAdamW`).
    On the CPU, and with ``graphs=False``, the chain runs it as it is.

    On a card (``graphs`` defaults to True there) the update is captured
    as a ``torch.cuda.CUDAGraph`` once per batch layout (:func:`layout`),
    after it has run once uncaptured on a side stream as that layout's
    first update; every later update with that layout copies its batches
    into the graph's inputs and replays it.  The graphs share one memory
    pool: a replay writes everything it reads but the state, the inputs,
    the keys and the generators' seeds, which live outside the pool, and
    its log vector is copied out before the next replay.  A capped AA
    block's ``aa_overflow_edges`` is None after a chain, captured or not:
    JAX's train step does not keep the count either, and a captured one
    would point into the pool.  A replay adds
    the launches its capture recorded to the kernels' counts (the capture
    itself launches nothing and counts nothing).  A capture that fails
    raises; nothing falls back to the eager step.

    The logs are the mean over the chain's updates (a skipped update's
    NaN included), ``train/step_skipped`` their sum, ``scenes`` the
    chain's scenes and ``stop`` the caller's flag; they, and the schedule's
    position, are read from the device once, after the chain.  Single
    process only: in a process group the update's all-reduces would have
    to be captured (ROADMAP.md Queue 1 item 5f).
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                 losses: List[Tuple[str, float, Callable]], device,
                 ts_drop_rate: float = 0.0, accum_steps: Optional[int] = None,
                 graphs: Optional[bool] = None):
        if mesh.world() > 1:
            raise NotImplementedError("a chained train step in a process group: ROADMAP.md "
                                      "Queue 1 item 5f")
        self.model, self.optimizer, self.losses = model, optimizer, losses
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.ts_drop_rate = ts_drop_rate
        self.accum_steps = accum_steps
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.names = [f"train/{name}" for name, _, _ in losses] + ["train/total"]
        self.adamw = DeviceAdamW(optimizer, scheduler, self.device)
        self.gens: List[torch.Generator] = []        # micro-batch i's draws
        self.drop_gens: List[torch.Generator] = []   # its ts_drop mask
        self.keys = torch.zeros((max(1, accum_steps or 1), 2), dtype=torch.int32,
                                device=self.device)
        self.captured: Dict[tuple, _Captured] = {}
        self.capture_s: List[float] = []   # seconds of each layout's warm-up and capture
        self.pool_bytes = 0   # what the captures reserved on the card (the graphs' pool)
        self.chain_logs: Optional[torch.Tensor] = None
        self._pool = None
        self._sown = [m for m in model.modules() if hasattr(m, "aa_overflow_edges")]

    def _generators(self, n: int) -> None:
        while len(self.gens) < n:
            self.gens.append(torch.Generator(device=self.device))
            self.drop_gens.append(torch.Generator(device=self.device))
        if self.keys.shape[0] < n:
            if self.captured:   # a graph reads the buffer it captured
                raise ValueError(f"a group of {n} micro-batches after a capture with at most "
                                 f"{self.keys.shape[0]}; build the step with accum_steps")
            self.keys = torch.zeros((n, 2), dtype=torch.int32, device=self.device)

    def seed(self, seeds: Sequence[int]) -> None:
        """Seed micro-batch ``i``'s generators and rollout keys with
        ``seeds[i]`` (host calls, no read of the device)."""
        self._generators(len(seeds))
        for i, s in enumerate(seeds):
            self.gens[i].manual_seed(s)
            self.drop_gens[i].manual_seed(mix_seed(s, 1))
        keys = torch.tensor([key_words(s) for s in seeds], dtype=torch.int32,
                            pin_memory=self.device.type == "cuda")
        self.keys[:len(seeds)].copy_(keys, non_blocking=True)

    def update(self, micro: Sequence[SceneBatch]) -> torch.Tensor:
        """One optimizer update on ``micro`` with the generators and keys as
        :meth:`seed` left them: ``[losses..., total, skipped]`` on the
        device.  Reads nothing on the host (a CUDA graph captures it)."""
        slots = self.accum_steps or len(micro)
        if not 0 < len(micro) <= slots or not all(m.x.shape[0] for m in micro):
            raise ValueError(f"a chained update takes 1 to {slots} micro-batches, each with a "
                             f"scene; got {[m.x.shape[0] for m in micro]}")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        none = torch.zeros(2, device=self.device)
        counts = torch.stack([batch_counts(m) for m in micro]
                             + [none] * (slots - len(micro)))
        values = torch.zeros(len(self.names), device=self.device)
        for i, m in enumerate(micro):
            total, logged = micro_loss(self.model, self.losses, m, counts[i], self.gens[i],
                                       self.drop_gens[i], self.keys[i], self.ts_drop_rate)
            total.backward()
            values = values + logged
        if slots > 1:
            inv = 1.0 / (counts[:, 0] > 0).sum()
            values = values * inv
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(inv)
        grads = [p.grad for p in self.params if p.grad is not None]
        finite = torch.stack([torch.isfinite(values[-1])]
                             + [torch.isfinite(g).all() for g in grads]).all()
        self.adamw.step(finite)
        return torch.cat([values, (~finite).to(values.dtype)[None]])

    def _capture(self, micro: List[SceneBatch]) -> torch.Tensor:
        """Run ``micro``'s update on a side stream (the layout's warm-up),
        then capture the update into a graph for its layout; returns the
        update's logs."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.update(micro)
        current.wait_stream(side)
        out.record_stream(current)
        # the warm-up's activations go back to the card before the capture
        # takes its own pool, so the peak is one update's, not two
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        inputs = [dataclasses.replace(m, **{f.name: v.clone() for f in dataclasses.fields(m)
                                             if (v := getattr(m, f.name)) is not None})
                  for m in micro]
        graph = torch.cuda.CUDAGraph()
        for gen in self.gens[:len(micro)] + self.drop_gens[:len(micro)]:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = ops.read_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                static = self.update(inputs)
        except Exception as e:
            raise RuntimeError(f"capturing the chained train step for the batch layout "
                               f"{layout(micro)} failed: {e}") from e
        finally:
            recorded = [b - a for a, b in zip(before, ops.read_counts())]
            ops.add_counts([-n for n in recorded])
        self.captured[layout(micro)] = _Captured(graph, inputs, static, recorded)
        self.capture_s.append(time.perf_counter() - t0)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        return out

    def _run(self, micro: List[SceneBatch]) -> torch.Tensor:
        if not self.graphs:
            return self.update(micro)
        entry = self.captured.get(layout(micro))
        if entry is None:
            return self._capture(micro)
        for dst, src in zip(entry.inputs, micro):
            for f in dataclasses.fields(dst):
                if (v := getattr(dst, f.name)) is not None:
                    v.copy_(getattr(src, f.name), non_blocking=True)
        entry.graph.replay()
        ops.add_counts(entry.launches)
        return entry.out

    def __call__(self, groups: Sequence[Union[SceneBatch, Sequence[SceneBatch]]], step: int,
                 seed: int, stop: bool = False) -> Optional[Dict[str, Any]]:
        chain = [[g] if isinstance(g, SceneBatch) else list(g) for g in groups]
        if not chain:
            return None
        self.adamw.begin()
        logs = torch.empty((len(chain), len(self.names) + 1), device=self.device)
        scenes = 0
        for j, micro in enumerate(chain):
            self.seed(micro_seeds(mesh.rank_seed(mix_seed(seed, step + j)), len(micro)))
            logs[j].copy_(self._run(micro))
            scenes += sum(m.x.shape[0] for m in micro)
        self.chain_logs = logs   # each update's logs, on the device
        for m in self._sown:
            m.aa_overflow_edges = None
        # the one read from the device a chain
        *values, skipped, count = torch.cat([
            logs[:, :-1].mean(0).double(), logs[:, -1].sum()[None].double(),
            self.adamw.count[None]]).tolist()
        self.adamw.finish(int(count))
        out: Dict[str, Any] = dict(zip(self.names, values))
        out.update({"train/step_skipped": skipped, "stop": stop, "scenes": scenes})
        return out


def layout(item: Union[SceneBatch, Sequence]) -> tuple:
    """The shape of every field of a ``SceneBatch``; of a group (a list),
    its length and its first member's layout."""
    if isinstance(item, SceneBatch):
        return tuple(None if (v := getattr(item, f.name)) is None else tuple(v.shape)
                     for f in dataclasses.fields(item))
    return (len(item),) + layout(item[0])


def group_microbatches(batches: Iterable, k: int) -> Iterator[list]:
    """``k`` batches of one layout at a time (``trajsde_tpu/train/loop.py``'s
    ``group_microbatches``): batches are buffered by the shape of every
    field, so a bucketing loader's mixed (A, L) shapes group with their own
    kind, and a group is yielded when it is full; at the end each partial
    group still trains.  The port keeps a group as a list (each micro-batch
    runs its own forward), where JAX stacks it on a leading axis.  Groups
    group again into chains the same way, keyed by :func:`layout` (a
    partial group chains with its own kind, as JAX's stacked shapes do)."""
    buffers: Dict[tuple, list] = {}
    for batch in batches:
        key = layout(batch)
        buffers.setdefault(key, []).append(batch)
        if len(buffers[key]) == k:
            yield buffers.pop(key)
    yield from buffers.values()


def make_eval_step(model: nn.Module, metrics, is_gtabs: bool = True, device="cuda") -> Callable:
    """``eval_step(scene, batch_idx) -> {metric name: (sum, count)}`` in eval
    mode without gradients; batch ``i`` draws from ``(EVAL_SEED, i)``, with
    the rank folded in under data parallelism."""

    @torch.no_grad()
    def eval_step(scene: SceneBatch, batch_idx: int):
        model.eval()
        s = mesh.rank_seed(mix_seed(EVAL_SEED, batch_idx))
        out = model(scene, generator=torch.Generator(device=device).manual_seed(s),
                    rollout_seed=s)
        pred, target, reg_mask, source = agent_slices(scene, out, is_gtabs)
        return {m.name: m.update_fn(pred, target, reg_mask, source) for m in metrics}

    return eval_step


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_prefetch(batches: Iterable[SceneBatch], device, size: int = 2
                    ) -> Iterator[SceneBatch]:
    """The batches of ``batches`` on ``device``, ``size`` ahead of the
    consumer (``trajsde_tpu/train/loop.py``'s ``device_prefetch``).

    A background thread pulls each CPU batch, sheds what no device consumer
    reads (:func:`strip_for_device`) and, on CUDA, copies it to the card
    through pinned buffers on its own stream (:class:`~trajsde_tpu_torch.data.staging.PinnedStager`, a
    ring of ``size + 1`` per batch layout).  The consumer's stream waits on
    the event behind the copy, and every tensor is marked as used on that
    stream, so the caching allocator does not hand its memory out early.
    On the CPU the stripped batches pass through.  Errors of the loader or
    the copy re-raise at the consumer; a consumer that leaves early stops
    the thread, which closes ``batches``, and waits for it.
    """
    dev = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = iter(batches)
        try:
            stage = PinnedStager(dev, size + 1) if dev.type == "cuda" else None
            for batch in it:
                batch = strip_for_device(batch)
                if not put(batch if stage is None else stage(batch)):
                    return
            put(end)
        except BaseException as e:  # re-raised at the consumer
            put(e)
        finally:
            if hasattr(it, "close"):
                it.close()

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            if dev.type == "cuda":
                item = wait_for_copy(*item, dev)
            yield item
    finally:
        # a consumer that leaves early (preemption) waits for the thread to
        # close ``batches``, which shuts a loader's worker processes down
        stop.set()
        thread.join(timeout=60)


@dataclasses.dataclass
class Trainer:
    """Epoch-driven trainer: ``fit`` trains, evaluates after every epoch and
    saves a checkpoint per epoch scored by ``monitor``.

    ``logger`` is any object with ``log_scalars(step, dict)``; one that also
    has ``log_scalars_async`` (``ExperimentLogger``) gets the per-step
    records as device tensors.  Batches are ``SceneBatch``es on the CPU (a
    list, or a ``BatchLoader``), moved to ``device`` through
    :func:`device_prefetch`.  ``perf/batch_wait_ms`` is the mean time a step
    waited for its batch.  ``profiler`` (a ``ProfilerHook``) hears of each
    step before it runs.

    ``accum_steps = K > 1`` accumulates gradients: the batches the feed
    brings are grouped K at a time by :func:`group_microbatches`, and each
    group is one optimizer update (``state.step`` counts updates; size the
    schedule on ``ceil(batches / K)`` updates an epoch).  Checkpoints go
    through ``checkpointer.save``; an asynchronous one
    (``CheckpointManager(async_save=True)``) has landed when ``fit``
    returns.

    ``chain_steps = C > 1`` (``train.py --chain``) groups the groups again,
    C of one layout at a time (axis order ``[chain,][micro,] batch``), and
    runs each chain through :class:`ChainedStep`: C updates, on a card
    C replays of a CUDA graph, and one read of the device.  ``state.step``
    advances by the chain's length (a trailing partial chain still trains),
    the logs are the chain's mean with ``train/step_skipped`` its sum, and
    a record is written when the step crosses a multiple of ``log_every``;
    the stop flag is read after each chain.  Single process only.

    Preemption: SIGTERM or SIGINT sets a flag; the
    update in flight finishes, then ``fit`` saves an unscored checkpoint,
    logs ``preempted`` and returns, so a ``--ckpt`` resume loses at most a
    step.  In a process group the flag rides in the step's all-reduce (and
    in one more at the end of the train and the val pass), so every rank
    stops after the same update and saves together, whichever rank the
    signal reached.  A signal during the val pass ends it and saves unscored rather
    than score a partial pass.  A second SIGINT raises
    ``KeyboardInterrupt``.  The handlers are installed only from the main
    thread and restored on the way out.  The loader's worker processes
    inherit the handler, so SIGINT sets a flag in their copy of the
    trainer; SIGTERM ends them (PyTorch's worker handler), and a loader
    error after the signal ends the pass like the signal itself.
    """
    losses: List[Tuple[str, float, Callable]]
    metrics: List[Any]
    device: Any = "cuda"
    logger: Optional[Any] = None
    checkpointer: Optional[Any] = None
    monitor: str = "ADE_T"
    is_gtabs: bool = True
    log_every: int = 1
    ts_drop_rate: float = 0.0
    profiler: Optional[Any] = None
    accum_steps: int = 1
    chain_steps: int = 1
    epoch_logs: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    preempted: bool = dataclasses.field(default=False, init=False)

    def _nfe_logs(self, model: nn.Module) -> Dict[str, float]:
        """Function-evaluation counts per forward (fixed grids: constants)."""
        logs = {}
        if isinstance(getattr(model, "encoder", None), LocalEncoderSDESep):
            steps = float(model.encoder.historical_steps)
            logs["nfe/encoder_sde_steps"] = steps
            logs["nfe/encoder_g_evals"] = 2.0 * steps   # both diffusion nets
        if isinstance(getattr(model, "decoder", None), SDEDecoder):
            logs["nfe/decoder_sde_steps"] = float(model.decoder.future_steps)
        return logs

    def _install_preempt_handlers(self) -> Dict[int, Any]:
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            if self.preempted and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self.preempted = True

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}

    @staticmethod
    def _restore_handlers(previous: Dict[int, Any]) -> None:
        for sig, old in previous.items():
            # None: the handler was not installed from Python
            signal.signal(sig, signal.SIG_DFL if old is None else old)

    def _log_step(self, step: int, logs: Dict[str, Any]) -> None:
        log_async = getattr(self.logger, "log_scalars_async", None)
        if log_async is not None:
            log_async(step, logs)
        else:
            self.logger.log_scalars(step, {k: float(v) for k, v in logs.items()})

    def _next(self, feed: Iterator[SceneBatch]) -> Optional[SceneBatch]:
        """The feed's next batch; None at its end, and when the loader fails
        after a preemption signal (a signal to the process group reaches
        the loader's workers too)."""
        try:
            return next(feed, None)
        except Exception:
            if self.preempted:
                return None
            raise

    def _feed(self, feed: Iterator[SceneBatch]) -> Iterator[SceneBatch]:
        while (scene := self._next(feed)) is not None:
            yield scene

    @staticmethod
    def _agree(flag: bool, dev: torch.device) -> bool:
        """``flag`` on any rank (one all-reduce in a process group)."""
        t = torch.tensor([float(flag)], device=dev)
        mesh.all_reduce_([t])
        return bool(t.item() > 0)

    def _emergency_stop(self, state: TrainState) -> TrainState:
        if self.checkpointer is not None:
            # synchronous: the process is about to end
            self.checkpointer.save(state, metric=None, step=state.step, wait=True)
        if self.logger is not None:
            self.logger.log_scalars(state.step, {"preempted": 1.0})
        return state

    def fit(self, state: TrainState, train_batches: Callable[[], Iterable[SceneBatch]],
            val_batches: Callable[[], Iterable[SceneBatch]], max_epochs: int) -> TrainState:
        if (self.checkpointer is not None and self.metrics
                and self.monitor not in {m.name for m in self.metrics}):
            # a typo'd monitor would save every checkpoint unscored, and the
            # pruner would then delete the real best
            raise ValueError(f"monitor {self.monitor!r} is not a registered metric "
                             f"({sorted(m.name for m in self.metrics)})")
        dev = resolve_device(self.device)
        chain = max(1, self.chain_steps)
        make = ChainedStep if chain > 1 else make_train_step
        train_step = make(state.model, state.optimizer, state.scheduler, self.losses, dev,
                          ts_drop_rate=self.ts_drop_rate, accum_steps=max(1, self.accum_steps))
        if self.logger is not None:
            self.logger.log_scalars(state.step, self._nfe_logs(state.model))
        self.preempted = False   # a stale flag must not stop a resumed fit
        previous = self._install_preempt_handlers()
        try:
            for epoch in range(max_epochs):
                t0 = time.perf_counter()
                n_steps = scenes = 0
                skipped = wait = 0.0
                with contextlib.closing(device_prefetch(train_batches(), dev)) as feed:
                    groups = group_microbatches(self._feed(feed), max(1, self.accum_steps))
                    if chain > 1:
                        groups = group_microbatches(groups, chain)
                    while True:
                        t_wait = time.perf_counter()
                        group = next(groups, None)
                        wait += time.perf_counter() - t_wait
                        if self.profiler is not None and group is not None:
                            self.profiler.on_step(state.step + 1)
                        # a rank whose feed has ended still joins the others' updates
                        logs = train_step(group or [], state.step, state.seed,
                                          stop=self.preempted)
                        if logs is None:   # every rank's feed has ended
                            break
                        stop = logs.pop("stop")
                        n = len(group) if chain > 1 else 1
                        state.step += n
                        n_steps += n
                        scenes += logs.pop("scenes")
                        skipped += logs["train/step_skipped"]
                        if (self.logger is not None and state.step // self.log_every
                                > (state.step - n) // self.log_every):
                            self._log_step(state.step,
                                           logs | {"train/steps_skipped_cum": skipped})
                        # one rank has no one to agree with: a signal that came
                        # during its update stops it after that update
                        if stop or (self.preempted and mesh.world() == 1):
                            return self._emergency_stop(state)
                # the train time closes on a synchronized clock, before the val pass
                _synchronize(dev)
                train_dt = time.perf_counter() - t0
                if self._agree(self.preempted, dev):
                    return self._emergency_stop(state)
                results = self.evaluate(state, val_batches)
                if self._agree(self.preempted, dev):   # a partial val pass is not a score
                    return self._emergency_stop(state)
                record = {f"val/{k}": v for k, v in results.items()} | {
                    "epoch": float(epoch),
                    "epoch_time_s": time.perf_counter() - t0,
                    "perf/steps_per_s": n_steps / max(train_dt, 1e-9),
                    "perf/scenes_per_s": scenes / max(train_dt, 1e-9),
                    "perf/batch_wait_ms": 1e3 * wait / max(n_steps, 1),
                    "train/steps_skipped": skipped,
                }
                self.epoch_logs.append(record)
                if self.logger is not None:
                    self.logger.log_scalars(state.step, record)
                if self.checkpointer is not None:
                    metric = results.get(self.monitor)
                    if metric is not None and not math.isfinite(metric):
                        metric = None   # NaN (an empty split) must not enter the pruner's sort
                    self.checkpointer.save(state, metric=metric, step=state.step)
        finally:
            self._restore_handlers(previous)
            if self.profiler is not None:
                self.profiler.stop()
            if self.checkpointer is not None:
                self.checkpointer.wait()   # land an asynchronous save
        return state

    def evaluate(self, state: TrainState, batches: Callable[[], Iterable[SceneBatch]]
                 ) -> Dict[str, float]:
        """The metrics over ``batches``; a preemption signal ends the pass
        early (``fit`` then saves unscored).  In a process group each rank
        evaluates its slices (a slice of no scene runs nothing) and the
        metrics' (sum, count) pairs are summed over the ranks."""
        dev = resolve_device(self.device)
        eval_step = make_eval_step(state.model, self.metrics, self.is_gtabs, dev)
        for m in self.metrics:
            m.reset()
        with contextlib.closing(device_prefetch(batches(), dev)) as feed:
            i = 0
            while (scene := self._next(feed)) is not None and not self.preempted:
                if scene.x.shape[0]:
                    contribs = eval_step(scene, i)
                    for m in self.metrics:
                        m.accumulate(contribs[m.name])
                i += 1
        all_reduce_metrics(self.metrics, dev)
        return {m.name: m.compute() for m in self.metrics}
