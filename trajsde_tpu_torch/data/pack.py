"""Packing ragged grid-aligned scenes into dense ``SceneBatch``es
(``trajsde_tpu/data/pack.py``).

When a scene exceeds the padded capacity, actors are kept by distance to
the focal agent at the reference step (agent and AV always kept) and lanes
by the distance of their first pose to the agent.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from trajsde_tpu_torch.data.grid import REF_TIME, TF, TH
from trajsde_tpu_torch.data.scene import SceneBatch

ACTOR_BUCKETS = (8, 16, 32, 48, 64, 96, 128)
LANE_BUCKETS = (32, 64, 128, 192, 256, 384, 512)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _actor_keep_order(scene: Dict[str, np.ndarray]) -> np.ndarray:
    """Agent, AV, then actors by distance of their LAST OBSERVED past
    position to the agent at the reference step; actors never observed
    rank last."""
    n = scene["x"].shape[0]
    agent = int(scene["agent_index"])
    av = int(scene["av_index"])
    pad = np.asarray(scene["padding_mask"], bool)[:, : REF_TIME + 1]
    obs = ~pad
    has_obs = obs.any(-1)
    last = np.where(has_obs, REF_TIME - np.argmax(obs[:, ::-1], axis=-1), 0)
    last_pos = scene["positions"][np.arange(n), last]
    d = np.linalg.norm(last_pos - scene["positions"][agent, REF_TIME], axis=-1)
    d[~has_obs] = np.inf
    d[agent] = -np.inf
    if av != agent:
        d[av] = -np.inf
    return np.argsort(d, kind="stable")


def _lane_keep_order(scene: Dict[str, np.ndarray]) -> np.ndarray:
    agent = int(scene["agent_index"])
    ref_pos = scene["positions"][agent, REF_TIME]
    d = np.linalg.norm(scene["lane_positions"][:, 0] - ref_pos, axis=-1)
    return np.argsort(d, kind="stable")


def truncation_stats(
    scenes: List[Dict[str, np.ndarray]], num_actors: int, num_lanes: int
) -> Dict[str, int]:
    """How much a capacity (A, L) would drop from ``scenes``."""
    actors_dropped = sum(max(0, s["x"].shape[0] - num_actors) for s in scenes)
    lanes_dropped = sum(max(0, s["lane_positions"].shape[0] - num_lanes) for s in scenes)
    scenes_truncated = sum(
        1 for s in scenes
        if s["x"].shape[0] > num_actors or s["lane_positions"].shape[0] > num_lanes
    )
    return dict(actors_dropped=actors_dropped, lanes_dropped=lanes_dropped,
                scenes_truncated=scenes_truncated)


def pack_scenes(
    scenes: List[Dict[str, np.ndarray]],
    num_actors: int,
    num_lanes: int,
    lane_poses: int = 10,
) -> SceneBatch:
    """Pad/truncate grid-aligned scene dicts into one dense batch of CPU
    tensors (the caller moves it to its device)."""
    B, A, L, S = len(scenes), num_actors, num_lanes, lane_poses
    T = TH + TF

    x = np.zeros((B, A, TH, 2), np.float32)
    y = np.zeros((B, A, TF, 2), np.float32)
    positions = np.zeros((B, A, T, 2), np.float32)
    padding = np.ones((B, A, T), bool)
    bos = np.zeros((B, A, TH), bool)
    angles = np.zeros((B, A), np.float32)
    actor_valid = np.zeros((B, A), bool)
    agent_index = np.zeros((B,), np.int32)
    av_index = np.zeros((B,), np.int32)
    source = np.zeros((B,), np.int32)
    lane_positions = np.zeros((B, L, S, 2), np.float32)
    lane_paddings = np.ones((B, L, S), bool)
    lane_valid = np.zeros((B, L), bool)
    has_y = any(s.get("y") is not None for s in scenes)
    # goal-lane labels, kept for parity and submissions
    has_goals = any(s.get("goal_idcs") is not None for s in scenes)
    goal_idcs = np.zeros((B, A, L), np.float32) if has_goals else None
    has_goal = np.zeros((B, A), bool) if has_goals else None
    seq_id = np.zeros((B,), np.int32)

    for b, scene in enumerate(scenes):
        order = _actor_keep_order(scene)[:A]
        n = order.shape[0]
        inv = {int(o): i for i, o in enumerate(order)}
        lorder = _lane_keep_order(scene)[:L]
        m = lorder.shape[0]

        x[b, :n] = scene["x"][order]
        if scene.get("y") is not None:
            y[b, :n] = scene["y"][order]
        positions[b, :n] = scene["positions"][order]
        padding[b, :n] = scene["padding_mask"][order]
        bos[b, :n] = scene["bos_mask"][order]
        angles[b, :n] = scene["rotate_angles"][order]
        actor_valid[b, :n] = True
        lp = scene["lane_positions"][lorder]
        lpad = scene["lane_paddings"][lorder].astype(bool)
        s_in = min(S, lp.shape[1])
        lane_positions[b, :m, :s_in] = lp[:, :s_in]
        lane_paddings[b, :m, :s_in] = lpad[:, :s_in]
        lane_valid[b, :m] = ~lpad[:, :s_in].all(-1)
        agent_index[b] = inv[int(scene["agent_index"])]
        av_index[b] = inv.get(int(scene["av_index"]), 0)
        source[b] = int(scene["source"])
        seq_id[b] = int(scene.get("seq_id", b))
        if has_goals and scene.get("goal_idcs") is not None:
            g = np.asarray(scene["goal_idcs"], np.float32)[order][:, lorder]
            goal_idcs[b, :n, :m] = g
            hg = scene.get("has_goal")
            if hg is None:
                has_goal[b, :n] = g.any(-1)
            else:
                # an actor whose goal lane the lane keep-order cut has an
                # all-zero one-hot row: its flag drops with it
                has_goal[b, :n] = np.asarray(hg, bool)[order] & g.any(-1)

    return SceneBatch.from_numpy(
        x=x, y=y if has_y else None, positions=positions, padding_mask=padding,
        bos_mask=bos, rotate_angles=angles, actor_valid=actor_valid,
        agent_index=agent_index, av_index=av_index, source=source,
        lane_positions=lane_positions, lane_paddings=lane_paddings,
        lane_valid=lane_valid, goal_idcs=goal_idcs, has_goal=has_goal, seq_id=seq_id,
    )
