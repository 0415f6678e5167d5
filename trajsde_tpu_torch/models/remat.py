"""Rematerialization of a block's activations (flax's ``nn.remat``).

``remat=True`` on either encoder runs its AA and AL blocks through
:func:`call_block`: in a training forward under grad the block's saved
tensors (the ``[B, Th, Aq, Ak, D]`` pair tensors of the dense AA chain, the
``[B, A, L, D]`` lane pairs, the fused op's pair features) are dropped and
the block runs again in the backward to rebuild them.  Outside a gradient
the block is called directly, so eval, ``forward_ood`` and serving run the
plain path bit for bit.

The recompute must draw the masks the forward drew.  ``torch.utils.checkpoint``
restores the default CPU and CUDA generators; an explicit
``torch.Generator`` (the trainer's per-step one) has moved on by then, so
:func:`call_block` takes its state before the block, sets it for the
recompute and puts the generator back afterwards, where the forward left
it.  ``get_state`` / ``set_state`` run on the host.

Inside a CUDA graph's capture they cannot: there a CUDA generator's draws
read their seed and offset from device memory that each replay fills from
the generator's host state, plus an offset fixed at capture, and
``get_state`` / ``set_state`` raise.  A :class:`ReplayTape` carries the
recompute's draws through the capture instead (``ChainedStep`` keeps one a
graph).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


class ReplayTape:
    """The remat blocks' dropout replay in one CUDA graph of a train update.

    The update runs once uncaptured (its layout's first update) under
    :func:`taping`: each rematerialized block that draws from a CUDA
    generator notes the generator and its offset (``get_offset``) before
    the block, in call order.  :meth:`register` gives each noted block a
    generator of its own, its replay state, registered with the graph
    before the capture.  In the capture, under :func:`taping` again, the
    block's recompute swaps its replay state into the block's generator
    (``graphsafe_set_state``) and swaps the generator's own state back
    after.  :meth:`arm`, before each replay, seeds each replay state with
    its block's generator's seed at the noted offset: the replay fills the
    block's draws and the recompute's from the same seed and offset, so
    the recompute draws the forward's masks, as on the host.  The offsets
    hold in every replay because an update makes the same draws each time
    from a generator seeded just before it."""

    def __init__(self):
        self.blocks: List[Tuple[torch.Generator, int]] = []
        self.states: List[torch.Generator] = []
        self._taken = 0

    def note(self, generator: torch.Generator) -> None:
        """An uncaptured remat block is about to draw from ``generator``."""
        self.blocks.append((generator, generator.get_offset()))

    def register(self, graph) -> None:
        """A replay state for every noted block, registered with ``graph``."""
        self.states = [torch.Generator(device=gen.device) for gen, _ in self.blocks]
        for state in self.states:
            graph.register_generator_state(state)

    def take(self, generator: torch.Generator) -> torch.Generator:
        """The replay state of the next block in the capture."""
        if self._taken >= len(self.states) or self.blocks[self._taken][0] is not generator:
            raise RuntimeError(
                f"remat block {self._taken + 1} under capture does not match the uncaptured "
                f"update's ({len(self.blocks)} blocks noted): the capture must make the "
                "uncaptured update's draws")
        self._taken += 1
        return self.states[self._taken - 1]

    def arm(self) -> None:
        """Set every replay state for the next replay (host calls)."""
        for (gen, offset), state in zip(self.blocks, self.states):
            state.manual_seed(gen.initial_seed())
            state.set_offset(offset)


_tape: Optional[ReplayTape] = None


@contextlib.contextmanager
def taping(tape: ReplayTape) -> Iterator[ReplayTape]:
    """Remat blocks note their draws on ``tape`` (uncaptured) or take their
    replay states from it (under capture) inside the block."""
    global _tape
    previous, _tape = _tape, tape
    try:
        yield tape
    finally:
        _tape = previous


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def call_block(block: nn.Module, *args, generator: Optional[torch.Generator] = None,
               remat: bool = False) -> torch.Tensor:
    """``block(*args, generator)``; with ``remat``, while ``block`` trains
    under grad, through non-reentrant ``torch.utils.checkpoint``, which keeps
    the plain path's autograd graph (so the gradients are its bits) and
    re-runs a ``torch.autograd.Function``'s forward (K3 launches again in
    the recompute; K4 still once).  The first forward leaves ``generator``
    advanced as the plain call does; each recompute replays its draws from
    the state it had before the block and leaves it where it was.  Under a
    CUDA graph's capture the recompute draws from the block's replay state
    on the active :class:`ReplayTape` (a capture without one raises), and
    the default generators are not preserved: the port's train step draws
    nothing from them."""
    if not (remat and block.training and torch.is_grad_enabled()):
        return block(*args, generator)
    capturing = _capturing()
    replay = start = None
    if capturing:
        if generator is None or _tape is None:
            raise RuntimeError("a remat block under CUDA graph capture replays its dropout "
                               "from an explicit generator and a ReplayTape (remat.taping)")
        replay = _tape.take(generator)
    elif generator is not None:
        if _tape is not None and generator.device.type == "cuda":
            _tape.note(generator)
        start = generator.get_state()
    calls = 0

    def run(*inputs):
        nonlocal calls
        calls += 1
        if calls == 1 or generator is None:
            return block(*inputs, generator)
        if replay is not None:
            now = generator.graphsafe_get_state()
            generator.graphsafe_set_state(replay)
            try:
                return block(*inputs, generator)
            finally:
                generator.graphsafe_set_state(now)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(*inputs, generator)
        finally:   # the recompute may stop early, once it has what the backward needs
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=not capturing)
