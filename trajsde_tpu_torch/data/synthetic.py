"""Synthetic scenes for tests and the chip smoke run.

A copy of ``trajsde_tpu/data/synthetic.py``: from the same
``np.random.Generator`` state both packages draw the same numbers in the
same order, so ``make_raw_scene`` / ``make_scene_batch`` give identical
numpy fields.  Batches come back as CPU tensors; move them with
``SceneBatch.to(device)``.
"""
from __future__ import annotations

import numpy as np

from trajsde_tpu_torch.data.grid import NUS_SCALE, REF_TIME, TF, TH, domain_slot_masks
from trajsde_tpu_torch.data.scene import SceneBatch

# domain-native step counts: nuScenes 2 Hz 5 past + 12 future; Argoverse 20 + 30
DOMAIN_STEPS = {0: (5, 12), 1: (20, 30)}


def make_raw_scene(
    rng: np.random.Generator,
    source: int,
    num_actors: int = 12,
    num_lanes: int = 24,
    lane_poses: int = 10,
) -> dict:
    """One DOMAIN-NATIVE scene dict (the preprocessors' output format,
    before grid alignment): unscaled metres, per-domain step counts."""
    tp, tf = DOMAIN_STEPS[source]
    tt = tp + tf
    N, L, S = num_actors, num_lanes, lane_poses
    dt = 0.5 if source == 0 else 0.1

    positions = np.zeros((N, tt, 2), np.float32)
    padding = np.ones((N, tt), bool)
    bos = np.zeros((N, tp), bool)
    angles = np.zeros((N,), np.float32)
    for a in range(N):
        p0 = rng.uniform(-40, 40, 2).astype(np.float32)
        vel = rng.uniform(-8, 8, 2).astype(np.float32)
        t_axis = (np.arange(tt) - (tp - 1)) * dt
        positions[a] = p0[None] + vel[None] * t_axis[:, None]
        angles[a] = np.arctan2(vel[1], vel[0])
        # start <= tp-2: an actor with future labels has >= 2 past observations
        start = 0 if a == 0 else int(rng.integers(0, tp - 1))
        padding[a, start:] = False
        if rng.uniform() < 0.15 and a != 0:
            padding[a, tp:] = True
        positions[a][padding[a]] = 0.0
        bos[a, start] = True

    ref = positions[:, tp - 1]
    x = positions[:, :tp] - ref[:, None]
    x[padding[:, :tp]] = 0.0
    y = positions[:, tp:] - ref[:, None]
    y[padding[:, tp:]] = 0.0

    lane_positions = np.zeros((L, S, 2), np.float32)
    lane_paddings = np.ones((L, S), bool)
    for l in range(L):
        start = rng.uniform(-60, 60, 2).astype(np.float32)
        d = rng.uniform(-np.pi, np.pi)
        dvec = np.array([np.cos(d), np.sin(d)], np.float32)
        n_pose = int(rng.integers(2, S + 1))
        lane_positions[l, :n_pose] = start[None] + dvec[None] * np.arange(
            n_pose, dtype=np.float32
        )[:, None]
        lane_paddings[l, :n_pose] = False

    scene = dict(
        x=x.astype(np.float32),
        y=y.astype(np.float32),
        positions=positions,
        padding_mask=padding,
        bos_mask=bos,
        rotate_angles=angles,
        agent_index=np.int32(0),
        av_index=np.int32(0),
        theta=np.float32(rng.uniform(-np.pi, np.pi)),
        lane_positions=lane_positions,
        lane_paddings=lane_paddings,
        source=np.int32(source),
    )
    if source == 0:
        scene["category"] = rng.integers(0, 9, size=N).astype(np.int32)
    return scene


def make_scene_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    num_actors: int = 16,
    num_lanes: int = 32,
    lane_poses: int = 10,
    sources=None,
) -> SceneBatch:
    """A grid-aligned batch (CPU tensors) with constant-velocity actors."""
    B, A, L, S = batch_size, num_actors, num_lanes, lane_poses
    T = TH + TF

    x = np.zeros((B, A, TH, 2), np.float32)
    y = np.zeros((B, A, TF, 2), np.float32)
    positions = np.zeros((B, A, T, 2), np.float32)
    padding = np.ones((B, A, T), bool)
    bos = np.zeros((B, A, TH), bool)
    angles = np.zeros((B, A), np.float32)
    actor_valid = np.zeros((B, A), bool)
    source = np.zeros((B,), np.int32)
    agent_index = np.zeros((B,), np.int32)

    lane_positions = np.zeros((B, L, S, 2), np.float32)
    lane_paddings = np.ones((B, L, S), bool)
    lane_valid = np.zeros((B, L), bool)

    for b in range(B):
        src = int(rng.integers(0, 2)) if sources is None else int(sources[b % len(sources)])
        source[b] = src
        past_slots, fut_slots = domain_slot_masks(src)
        slot_mask = np.concatenate([past_slots, fut_slots])

        n_act = int(rng.integers(2, A + 1))
        actor_valid[b, :n_act] = True
        for a in range(n_act):
            p0 = rng.uniform(-40, 40, size=2).astype(np.float32)
            vel = rng.uniform(-8, 8, size=2).astype(np.float32)
            heading = np.arctan2(vel[1], vel[0]).astype(np.float32)
            t_axis = (np.arange(T) - REF_TIME) / 10.0
            traj = p0[None] + vel[None] * t_axis[:, None]
            traj += rng.normal(0, 0.05, size=traj.shape)
            positions[b, a] = traj.astype(np.float32)
            angles[b, a] = heading

            # first valid slot excludes the reference slot, so every
            # future-labelled actor has >= 2 past observations
            first_slot_choices = np.nonzero(past_slots)[0][:-1]
            start = int(rng.choice(first_slot_choices)) if a else 0
            valid = slot_mask.copy()
            valid[:start] = False
            if not valid[REF_TIME]:  # unseen at ref => no future
                valid[TH:] = False
            if rng.uniform() < 0.2 and a != 0:
                valid[TH:] = False
            padding[b, a] = ~valid
            positions[b, a][~valid] = 0.0

            vp = valid[:TH]
            if vp.any():
                first = int(np.argmax(vp))
                bos[b, a, first] = True
            ref_pos = positions[b, a, REF_TIME]
            x[b, a][vp] = positions[b, a, :TH][vp] - ref_pos
            vf = valid[TH:]
            y[b, a][vf] = positions[b, a, TH:][vf] - ref_pos
        if src == 0:
            x[b] /= NUS_SCALE

        agent_index[b] = 0  # actor 0 is always fully valid above

        n_lane = int(rng.integers(4, L + 1))
        lane_valid[b, :n_lane] = True
        for l in range(n_lane):
            start = rng.uniform(-60, 60, size=2).astype(np.float32)
            direction = rng.uniform(-np.pi, np.pi)
            d = np.array([np.cos(direction), np.sin(direction)], np.float32)
            n_pose = int(rng.integers(2, S + 1))
            poses = start[None] + d[None] * np.arange(n_pose, dtype=np.float32)[:, None]
            lane_positions[b, l, :n_pose] = poses
            lane_paddings[b, l, :n_pose] = False

    return SceneBatch.from_numpy(
        x=x, y=y, positions=positions, padding_mask=padding, bos_mask=bos,
        rotate_angles=angles, actor_valid=actor_valid, agent_index=agent_index,
        av_index=np.zeros(B, np.int32), source=source,
        lane_positions=lane_positions, lane_paddings=lane_paddings,
        lane_valid=lane_valid,
    )
