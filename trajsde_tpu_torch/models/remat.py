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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def call_block(block: nn.Module, *args, generator: Optional[torch.Generator] = None,
               remat: bool = False) -> torch.Tensor:
    """``block(*args, generator)``; with ``remat``, while ``block`` trains
    under grad, through non-reentrant ``torch.utils.checkpoint``, which keeps
    the plain path's autograd graph (so the gradients are its bits) and
    re-runs a ``torch.autograd.Function``'s forward (K3 launches again in
    the recompute; K4 still once).  The first forward leaves ``generator``
    advanced as the plain call does; each recompute replays its draws from
    the state it had before the block and leaves it where it was."""
    if not (remat and block.training and torch.is_grad_enabled()):
        return block(*args, generator)
    start = None if generator is None else generator.get_state()
    calls = 0

    def run(*inputs):
        nonlocal calls
        calls += 1
        if calls == 1 or generator is None:
            return block(*inputs, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(*inputs, generator)
        finally:   # the recompute may stop early, once it has what the backward needs
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=True)
