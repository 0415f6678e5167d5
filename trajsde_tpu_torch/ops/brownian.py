"""Counter-based virtual Brownian tree (``trajsde_tpu/ops/brownian.py``).

A Brownian path ``W`` on ``[t0, t1]`` with ``W(t0) = 0`` on a dyadic grid of
``2**depth`` leaves, each node drawn by a Lévy bridge between its
interval's ends.  Node ``c`` (``c = 1 .. 2**depth``) is one unit normal of
the state's shape: ``c = 2**depth`` gives ``W(t1)``, every other ``c`` is
the midpoint leaf of a dyadic interval (odd multiples of decreasing powers
of two are distinct, so the midpoint index names its node).

The JAX tree draws node ``c`` as ``normal(fold_in(key, c))`` at each
query; that stream cannot be replayed here.  The port takes the node
normals as one tensor ``nodes [2**depth, *shape]`` (node ``c`` at
``nodes[c - 1]``), pinned by the caller or drawn from the caller's
``torch.Generator`` in one ``torch.randn`` when the tree is built.  Every
leaf is then built once, level by level, with the descent's arithmetic, and
a query is an index into the leaves.  So, as in JAX:

* ``W(s, u) + W(u, t) = W(s, t)`` up to the rounding of the differences
  (both sides are differences of the same leaves);
* a value depends only on ``(nodes, t)``, never on the order of queries;
* a query rounds ``t`` to the nearest leaf, half to even
  (``torch.round`` is ``jnp.round``), clipped to ``[0, 2**depth]``.

A query does not read the device's values on the host, so a solver loop
that queries the tree never synchronizes with the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

F32 = torch.float32


class BrownianTree:
    """Virtual Brownian path ``W`` on ``[t0, t1]`` with ``W(t0) = 0``.

    ``shape`` is the state's shape; every query returns that shape in f32.
    ``depth`` levels give a resolution of ``(t1 - t0) / 2**depth``.  ``t0``
    and ``t1`` may be Python floats or 0-d tensors; the tree lives on the
    device of ``nodes``, or else of ``t0``.
    """

    def __init__(self, t0, t1, shape: Sequence[int], depth: int = 12,
                 nodes: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        self.depth = int(depth)
        self.n_leaves = n = 2 ** self.depth
        self.shape = tuple(shape)
        device = None if nodes is None else nodes.device
        self.t0 = torch.as_tensor(t0, dtype=F32, device=device)
        self.t1 = torch.as_tensor(t1, dtype=F32, device=self.t0.device)
        if nodes is None:
            nodes = torch.randn((n,) + self.shape, generator=generator, device=self.t0.device,
                                dtype=F32)
        if tuple(nodes.shape) != (n,) + self.shape:
            raise ValueError(f"nodes {tuple(nodes.shape)}: expected {(n,) + self.shape} "
                             f"(2**depth unit normals of the state's shape)")
        self.span = self.t1 - self.t0
        self.leaves = self._build(nodes.to(F32))

    @torch.no_grad()
    def _build(self, nodes: torch.Tensor) -> torch.Tensor:
        """W at every leaf, [2**depth + 1, *shape]: the descent's bridge,
        ``W(mid) = (W(lo) + W(hi)) / 2 + sqrt((hi - lo) * leaf / 4) z``,
        evaluated for all intervals of a level at once."""
        n = self.n_leaves
        leaves = nodes.new_empty((n + 1,) + self.shape)
        leaves[0] = 0.0
        leaves[n] = nodes[n - 1] * torch.sqrt(self.span)
        leaf_dt = self.span / n
        step = n
        while step > 1:
            half = step // 2
            # (hi - lo) * leaf_dt * 0.5, then sqrt(half_dt * 0.5): JAX's order
            half_dt = step * leaf_dt * 0.5
            scale = torch.sqrt(half_dt * 0.5)
            lo, hi = leaves[0:n:step], leaves[step:n + 1:step]
            leaves[half:n:step] = 0.5 * (lo + hi) + scale * nodes[half - 1:n:step]
            step = half
        return leaves

    def index(self, t) -> torch.Tensor:
        """The leaf of ``t``, a 1-element int64 tensor on the tree's device."""
        t = torch.as_tensor(t, dtype=F32, device=self.t0.device)
        x = (t - self.t0) / self.span
        return torch.round(x * self.n_leaves).to(torch.int64).clamp(0, self.n_leaves).reshape(1)

    def __call__(self, t) -> torch.Tensor:
        """W(t), rounded to the leaf grid."""
        return self.leaves.index_select(0, self.index(t))[0]

    def increment(self, ta, tb) -> torch.Tensor:
        """W(tb) - W(ta); additive over adjacent intervals (the same leaves)."""
        return self(tb) - self(ta)
