"""Dense attention masks and edge vectors from a ``SceneBatch``
(``trajsde_tpu/models/graph.py``): every ragged edge set of the reference
is a boolean mask over a fixed-shape adjacency."""
from __future__ import annotations

import torch

from trajsde_tpu_torch.data.scene import SceneBatch, rotate_into


def aa_masks(scene: SceneBatch, local_radius: float) -> torch.Tensor:
    """Agent-agent adjacency per historical step, [B, Th, A, A] bool:
    ``out[b, t, i, j]`` iff both are valid at ``t``, ``i != j`` and
    ``|p_j - p_i| < local_radius``."""
    Th = scene.historical_steps
    valid = (~scene.padding_mask[:, :, :Th]) & scene.actor_valid[:, :, None]
    valid = valid.permute(0, 2, 1)                                 # [B, Th, A]
    pos = scene.positions[:, :, :Th].permute(0, 2, 1, 3)           # [B, Th, A, 2]
    diff = pos[:, :, None, :, :] - pos[:, :, :, None, :]
    dist2 = (diff * diff).sum(-1)
    A = valid.shape[-1]
    not_self = ~torch.eye(A, dtype=torch.bool, device=valid.device)
    return (
        valid[:, :, :, None]
        & valid[:, :, None, :]
        & not_self
        & (dist2 < local_radius * local_radius)
    )


def aa_edge_vectors(scene: SceneBatch) -> torch.Tensor:
    """``vec[b, t, i, j] = positions[j, t] - positions[i, t]``,
    [B, Th, A(recv i), A(send j), 2]."""
    Th = scene.historical_steps
    pos = scene.positions[:, :, :Th].permute(0, 2, 1, 3)
    return pos[:, :, None, :, :] - pos[:, :, :, None, :]


def _lane_end(scene: SceneBatch) -> torch.Tensor:
    """Last VALID pose of each padded lane polyline, [B, L, 2]."""
    lane_len = (~scene.lane_paddings).sum(-1)                      # [B, L]
    last = (lane_len - 1).clamp(0, scene.lane_positions.shape[2] - 1)
    idx = last[:, :, None, None].expand(-1, -1, 1, 2)
    return torch.gather(scene.lane_positions, 2, idx)[:, :, 0, :]


def al_edges(
    scene: SceneBatch,
    ref_time: int,
    local_radius: float,
    lon_window: tuple = (-20.0, 80.0),
    lat_window: float = 50.0,
) -> tuple:
    """Actor-lane adjacency + edge vectors, ([B, A, L] bool, [B, A, L, 2]):
    vector = lane END pose - actor position at the reference step, kept iff
    in the actor-frame window, within ``local_radius``, and both valid."""
    lane_end = _lane_end(scene)
    actor_pos = scene.positions[:, :, ref_time]
    vec = lane_end[:, None, :, :] - actor_pos[:, :, None, :]       # [B, A, L, 2]
    vec_local = rotate_into(vec, scene.rotate_mat()[:, :, None])
    window = (
        (vec_local[..., 0] > lon_window[0])
        & (vec_local[..., 0] < lon_window[1])
        & (vec_local[..., 1] > -lat_window)
        & (vec_local[..., 1] < lat_window)
    )
    dist2 = (vec * vec).sum(-1)
    actor_ref_valid = (~scene.padding_mask[:, :, ref_time]) & scene.actor_valid
    mask = (
        window
        & (dist2 < local_radius * local_radius)
        & actor_ref_valid[:, :, None]
        & scene.lane_valid[:, None, :]
    )
    return mask, vec


def lane_features(scene: SceneBatch) -> torch.Tensor:
    """End pose - start pose of each lane segment, [B, L, 2]."""
    return _lane_end(scene) - scene.lane_positions[:, :, 0]


def global_edges(scene: SceneBatch, ref_time: int) -> tuple:
    """(mask [B, A, A], rel_pos [B, A, A, 2], rel_theta [B, A, A]) at the
    reference step: actors valid there, no distance cutoff, no self loops."""
    valid = (~scene.padding_mask[:, :, ref_time]) & scene.actor_valid
    A = valid.shape[-1]
    not_self = ~torch.eye(A, dtype=torch.bool, device=valid.device)
    mask = valid[:, :, None] & valid[:, None, :] & not_self
    pos = scene.positions[:, :, ref_time]
    rel_pos = pos[:, None, :, :] - pos[:, :, None, :]
    rel_theta = scene.rotate_angles[:, None, :] - scene.rotate_angles[:, :, None]
    return mask, rel_pos, rel_theta
