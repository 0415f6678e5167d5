"""Dense, statically-shaped scene batches as a plain dataclass of tensors.

Same fields, shapes and conventions as ``trajsde_tpu/data/scene.py``:

  B  — scenes per batch            A  — padded actors per scene
  Th — historical steps (21)       Tf — future steps (60)
  L  — padded lane segments        S  — poses per lane segment (10)

``padding_mask`` is True where a time step is INVALID; ``*_valid`` flags
are True where a slot is USED.  Geometry lives in the AV-centred scene
frame; only ``x`` carries the 1/5 nuScenes scaling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SceneBatch:
    x: torch.Tensor               # [B, A, Th, 2] float — displacement features
    positions: torch.Tensor       # [B, A, Th+Tf, 2] float — absolute positions
    padding_mask: torch.Tensor    # [B, A, Th+Tf] bool — True where INVALID
    bos_mask: torch.Tensor        # [B, A, Th] bool — True at first valid step
    rotate_angles: torch.Tensor   # [B, A] float — per-actor heading
    actor_valid: torch.Tensor     # [B, A] bool — slot is a real actor
    agent_index: torch.Tensor     # [B] int64 — focal agent slot
    av_index: torch.Tensor        # [B] int64 — AV slot
    source: torch.Tensor          # [B] int64 — 0 = nuScenes, 1 = Argoverse
    y: Optional[torch.Tensor] = None               # [B, A, Tf, 2] future targets
    lane_positions: Optional[torch.Tensor] = None  # [B, L, S, 2]
    lane_paddings: Optional[torch.Tensor] = None   # [B, L, S] bool — True = padded pose
    lane_valid: Optional[torch.Tensor] = None      # [B, L] bool
    goal_idcs: Optional[torch.Tensor] = None       # [B, A, L] float one-hot goal lane
    has_goal: Optional[torch.Tensor] = None        # [B, A] bool
    seq_id: Optional[torch.Tensor] = None          # [B] int64

    @classmethod
    def from_numpy(cls, **arrays) -> "SceneBatch":
        """Wrap numpy arrays (None stays None) without copying them;
        integer ids become int64 so they index directly, and a read-only
        array (a view of another framework's buffer, a memmap) is copied,
        since a tensor over it could be written."""
        out = {}
        for k, v in arrays.items():
            if v is None:
                out[k] = None
                continue
            a = np.asarray(v)
            if a.dtype.kind in "iu" and a.dtype != np.int64:
                a = a.astype(np.int64)
            elif not a.flags.writeable:
                a = a.copy()
            out[k] = torch.from_numpy(a)
        return cls(**out)

    def to(self, device) -> "SceneBatch":
        return dataclasses.replace(self, **{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    @property
    def historical_steps(self) -> int:
        return self.x.shape[2]

    def rotate_mat(self) -> torch.Tensor:
        """Per-actor rotations ``[[cos, -sin], [sin, cos]]``, [B, A, 2, 2]
        (row-vector convention: ``v' = v @ R``)."""
        c = torch.cos(self.rotate_angles)
        s = torch.sin(self.rotate_angles)
        row0 = torch.stack([c, -s], dim=-1)
        row1 = torch.stack([s, c], dim=-1)
        return torch.stack([row0, row1], dim=-2)


def strip_for_device(batch: SceneBatch) -> SceneBatch:
    """Shed the bytes no consumer on the device reads, before the copy to
    the card (``trajsde_tpu/data/scene.py``'s ``strip_for_device``).

    - ``goal_idcs`` and ``has_goal``: no model, loss, metric or serving
      projection of the port reads them.
    - ``positions[..., Th:, :]``: the port's consumers read
      ``positions[:, :, :Th]`` or ``positions[:, :, ref_time]`` with
      ``ref_time < Th`` (``models/graph.py``, ``server.py``); the targets
      live in ``y``.

    Exact: it removes bytes, not precision.  Idempotent: a stripped batch
    comes back as the same object.  The sliced positions are a view.
    """
    th = batch.x.shape[-2]
    pos = batch.positions
    truncate = pos.shape[-2] != th
    if not truncate and batch.goal_idcs is None and batch.has_goal is None:
        return batch
    return dataclasses.replace(batch, positions=pos[..., :th, :] if truncate else pos,
                               goal_idcs=None, has_goal=None)


def rotate_into(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate 2-vectors ``v`` by matrices ``rot`` (row-vector convention)."""
    return torch.einsum("...j,...ji->...i", v, rot)
