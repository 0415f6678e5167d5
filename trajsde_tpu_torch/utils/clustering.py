"""Sampled trajectories -> K ranked modes: endpoint K-means and ranking
(``trajsde_tpu/utils/clustering.py``).

The analog of the reference's ``models/utils/dec_utils.py:14-106`` (a
``@ray.remote`` K-means and Ward ranking, dead code in its shipped configs
but part of its inventory).  The endpoint K-means runs as vectorized torch
ops on the device of its input.  The JAX package draws the initial centres
with ``jax.random.choice(key, S, (k,), replace=False)``; that stream has no
torch counterpart, so the draw is an argument (``init_idx``) or comes from
an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def kmeans_endpoints(trajs: torch.Tensor, k: int = 6, iters: int = 10, *,
                     generator: Optional[torch.Generator] = None,
                     init_idx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means over trajectory endpoints: ``trajs [S, T, 2]`` -> (assignment
    [S] int64, centres [k, 2]).  Lloyd iterations; a cluster left empty
    keeps its centre.  Fewer samples than clusters degrade to ``k = S``.
    The initial centres are ``trajs[init_idx, -1]`` (k distinct indices),
    else a permutation drawn from ``generator`` (on the CPU)."""
    pts = trajs[:, -1, :]
    S = pts.shape[0]
    k = min(k, S)
    if init_idx is None:
        init_idx = torch.randperm(S, generator=generator)[:k]
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx))
    init_idx = init_idx.to(device=pts.device, dtype=torch.int64)
    if init_idx.shape != (k,):
        raise ValueError(f"init_idx has shape {tuple(init_idx.shape)}, expected ({k},)")
    centers = pts[init_idx]

    def assign_of(c):
        return ((pts[:, None] - c[None]) ** 2).sum(-1).argmin(-1)

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(assign_of(centers), k).to(pts.dtype)  # [S, k]
        counts = onehot.sum(0)
        sums = onehot.T @ pts
        centers = torch.where(counts[:, None] > 0, sums / counts[:, None].clamp_min(1), centers)
    return assign_of(centers), centers


def cluster_and_rank(trajs: np.ndarray, k: int = 6, seed: int = 0,
                     init_idx=None) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce S sampled trajectories ``[S, T, 2]`` (numpy) to k ranked modes.

    Returns (modes [k, T, 2], probs [k]): each cluster's mean trajectory and
    its share of the samples, in descending order of share (a stable
    sort), the reduction ``cluster_traj`` / ``cluster_and_rank`` performs in
    the reference.  ``init_idx`` pins the initial centres; without it they
    are drawn from a generator seeded with ``seed``.  An empty cluster takes
    a sample drawn from one numpy ``default_rng(seed)`` shared by every
    empty cluster."""
    S, T, _ = trajs.shape
    k = min(k, S)
    assign, _ = kmeans_endpoints(torch.from_numpy(np.asarray(trajs)), k=k, init_idx=init_idx,
                                 generator=torch.Generator().manual_seed(int(seed)))
    assign = assign.cpu().numpy()
    modes = np.zeros((k, T, 2), np.float32)
    probs = np.zeros((k,), np.float32)
    # one rng for ALL empty-cluster fallbacks: re-seeding per cluster would
    # hand every empty cluster the identical replacement trajectory
    fallback_rng = np.random.default_rng(seed)
    for c in range(k):
        m = assign == c
        probs[c] = m.mean()
        if m.any():
            modes[c] = trajs[m].mean(0)
        else:
            modes[c] = trajs[fallback_rng.integers(0, S)]
    order = np.argsort(-probs, kind="stable")
    return modes[order], probs[order]
