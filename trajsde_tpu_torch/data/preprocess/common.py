"""Shared preprocessing geometry (pure numpy, devkit-free, unit-tested).

The reference's offline preprocessors (``dataset/Argoverse/Argoverse_abs.py``,
``dataset/nuScenes/nuScenes_hivt.py``) interleave devkit I/O with the
geometric transforms.  Here the transforms are pure functions over plain
arrays so they are testable without the map APIs; the devkit adapters
(:mod:`.argoverse`, :mod:`.nuscenes`) only extract raw tracks/centerlines
and delegate everything else to this module.

Scene output contract (the "raw scene dict" consumed by
:func:`trajsde_tpu_torch.data.grid.align_to_grid`): domain-native time axes,
AV/target-centered rotated frame, fields ``x, y, positions, padding_mask,
bos_mask, rotate_angles, agent_index, av_index, theta, lane_positions,
lane_paddings, source`` (+ ``category`` for nuScenes).

The port's copy of ``trajsde_tpu/data/preprocess/common.py`` (numpy only);
its code differs only in the import paths.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def scene_frame(origin_xy: np.ndarray, heading_vec: np.ndarray) -> Tuple[np.ndarray, float]:
    """(rotation matrix, theta) of the scene frame from the anchor's heading.

    Matches ``Argoverse_abs.py:192-197``: theta = atan2 of the heading
    vector; points transform as ``(p - origin) @ R`` with
    ``R = [[cosθ, -sinθ], [sinθ, cosθ]]``.
    """
    theta = float(np.arctan2(heading_vec[1], heading_vec[0]))
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]], np.float32)
    return rot, theta


def to_scene(points: np.ndarray, origin: np.ndarray, rot: np.ndarray) -> np.ndarray:
    return ((points - origin) @ rot).astype(np.float32)


def build_tracks(
    obs_steps: Sequence[np.ndarray],
    obs_xy: Sequence[np.ndarray],
    num_past: int,
    num_future: int,
    origin: np.ndarray,
    rot: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Assemble per-actor padded tracks in the scene frame.

    obs_steps[i] — int step indices where actor ``i`` is observed;
    obs_xy[i] — matching global xy.  Reproduces the reference track rules
    (``Argoverse_abs.py:200-231``):

    * ``padding_mask`` True at unobserved steps;
    * actors unseen at the reference step (``num_past-1``) or with < 2
      historical observations get their whole future masked;
    * heading from the last two historical observations;
    * ``bos_mask`` True where step valid and previous step invalid;
    * ``x[:, :past]`` = positions − ref position (zeroed at padding);
      ``y`` = future positions − ref position (zeroed at masked future).
    """
    n = len(obs_steps)
    total = num_past + num_future
    ref = num_past - 1
    positions = np.zeros((n, total, 2), np.float32)
    padding = np.ones((n, total), bool)
    angles = np.zeros((n,), np.float32)

    for i, (steps, xy) in enumerate(zip(obs_steps, obs_xy)):
        steps = np.asarray(steps, int)
        local = to_scene(np.asarray(xy, np.float32), origin, rot)
        positions[i, steps] = local
        padding[i, steps] = False
        hist = steps[steps < num_past]
        if padding[i, ref] or hist.size < 2:
            padding[i, num_past:] = True
        if hist.size >= 2:
            h = positions[i, hist[-1]] - positions[i, hist[-2]]
            angles[i] = np.arctan2(h[1], h[0])

    positions[padding] = 0.0
    bos = np.zeros((n, num_past), bool)
    bos[:, 0] = ~padding[:, 0]
    bos[:, 1:num_past] = padding[:, : num_past - 1] & ~padding[:, 1:num_past]

    ref_pos = positions[:, ref]
    x = positions[:, :num_past] - ref_pos[:, None]
    x[padding[:, :num_past]] = 0.0
    y = positions[:, num_past:] - ref_pos[:, None]
    y[padding[:, num_past:]] = 0.0
    return dict(
        x=x, y=y, positions=positions, padding_mask=padding,
        bos_mask=bos, rotate_angles=angles,
    )


def resample_polyline(points: np.ndarray, spacing: float = 1.0) -> np.ndarray:
    """Points at every ``spacing`` meters of arclength along a polyline.

    The numpy equivalent of the reference's shapely
    ``line.interpolate(i)`` loop (``Argoverse_abs.py:316-323``): one point
    per integer arclength from 0 (inclusive) up to the total length.
    """
    points = np.asarray(points, np.float64)
    if len(points) < 2:
        return points.astype(np.float32)
    seg = np.diff(points, axis=0)
    seg_len = np.linalg.norm(seg, axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    # largest multiple of `spacing` <= total; for the reference's
    # spacing=1 this is exactly floor(total) (Argoverse_abs.py:316-323),
    # and non-integer spacings keep their valid tail samples
    targets = np.arange(0.0, np.floor(total / spacing) * spacing + 1e-9, spacing)
    if targets.size == 0:
        return np.zeros((0, 2), np.float32)
    idx = np.clip(np.searchsorted(cum, targets, side="right") - 1, 0, len(seg) - 1)
    t = (targets - cum[idx]) / np.maximum(seg_len[idx], 1e-12)
    out = points[idx] + seg[idx] * t[:, None]
    return out.astype(np.float32)


def chunk_centerline(
    points: np.ndarray, lseg_len: int = 10
) -> List[Dict[str, np.ndarray]]:
    """Split a resampled centerline into ≤``lseg_len``-pose segments.

    Reproduces ``Argoverse_abs.py:328-340``: n_segments =
    ceil(P / (lseg_len+1)); per segment, midpoints of consecutive poses and
    their difference vectors; empty (single-pose) chunks dropped.
    """
    out = []
    P = len(points)
    if P < 2:
        return out
    n_segments = int(np.ceil(P / (lseg_len + 1)))
    n_poses = int(np.ceil(P / n_segments))
    for k in range(n_segments):
        seg = points[k * n_poses : (k + 1) * n_poses]
        if len(seg) - 1 > 0:
            out.append(
                dict(
                    positions=((seg[1:] + seg[:-1]) / 2).astype(np.float32),
                    vectors=(seg[1:] - seg[:-1]).astype(np.float32),
                    count=len(seg) - 1,
                )
            )
    return out


def pad_lane_segments(
    segments: List[Dict[str, np.ndarray]], lseg_len: int = 10
) -> Dict[str, np.ndarray]:
    """Stack variable-length segments into padded [L, S, 2] tensors."""
    L = len(segments)
    lane_positions = np.zeros((L, lseg_len, 2), np.float32)
    lane_vectors = np.zeros((L, lseg_len, 2), np.float32)
    lane_paddings = np.ones((L, lseg_len), bool)
    lengths = np.zeros((L,), np.int32)
    for i, seg in enumerate(segments):
        c = min(int(seg["count"]), lseg_len)
        lane_positions[i, :c] = seg["positions"][:c]
        lane_vectors[i, :c] = seg["vectors"][:c]
        lane_paddings[i, :c] = False
        lengths[i] = c
    return dict(
        lane_positions=lane_positions,
        lane_vectors=lane_vectors,
        lane_paddings=lane_paddings,
        lane_lengths=lengths,
    )


def wrap_angle(a: np.ndarray) -> np.ndarray:
    return (a + np.pi) % (2 * np.pi) - np.pi


# ---------------------------------------------------------------------------
# lane-graph connectivity (nuScenes_hivt.py:663-726) — pure geometry; the
# devkit only supplies the per-lane ``outgoing`` token map
# ---------------------------------------------------------------------------
def successor_edges(
    seg_tokens: List, outgoing: Dict
) -> List[List[int]]:
    """Successor edge list per lane segment (``nuScenes_hivt.py:663-681``).

    Consecutive chunks of the same source lane chain front-to-back; a
    lane's LAST chunk connects to the first listed chunk of each outgoing
    lane present in the scene.
    """
    e_succ: List[List[int]] = []
    first_idx: Dict = {}
    for i, tok in enumerate(seg_tokens):  # first chunk index per lane token
        first_idx.setdefault(tok, i)
    for node_id, tok in enumerate(seg_tokens):
        e: List[int] = []
        if node_id + 1 < len(seg_tokens) and seg_tokens[node_id + 1] == tok:
            e.append(node_id + 1)
        else:
            for out_tok in outgoing.get(tok, ()):  # map-api adapter supplied
                if out_tok in first_idx:
                    e.append(first_idx[out_tok])
        e_succ.append(e)
    return e_succ


def predecessor_edges(e_succ: List[List[int]]) -> List[List[int]]:
    """Transpose of the successor lists (``:684-695``)."""
    e_pred: List[List[int]] = [[] for _ in e_succ]
    for node_id, succs in enumerate(e_succ):
        for s in succs:
            e_pred[s].append(node_id)
    return e_pred


def proximal_edges(
    seg_positions: List[np.ndarray],
    seg_vectors: List[np.ndarray],
    e_succ: List[List[int]],
    dist_thresh: float = 4.0,
    yaw_thresh: float = np.pi / 4,
) -> List[List[int]]:
    """Proximal (side-by-side) edges (``:697-726``): non-successor pairs
    whose closest poses are ≤ ``dist_thresh`` apart and whose mean headings
    differ by ≤ ``yaw_thresh``."""
    n = len(seg_positions)
    yaws = [
        float(np.arctan2(v[:, 1].mean(), v[:, 0].mean())) for v in seg_vectors
    ]
    e_prox: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if j in e_succ[i] or i in e_succ[j]:
                continue
            d2 = np.min(
                np.sum(
                    (seg_positions[i][:, None, :] - seg_positions[j][None, :, :]) ** 2,
                    axis=-1,
                )
            )
            if d2 <= dist_thresh * dist_thresh:
                diff = wrap_angle(np.asarray(yaws[i] - yaws[j]))
                if abs(float(diff)) <= yaw_thresh:
                    e_prox[i].append(j)
                    e_prox[j].append(i)
    return e_prox


def lane_edge_arrays(
    e_succ: List[List[int]],
    e_pred: List[List[int]],
    e_prox: List[List[int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten edge lists to ``(lane_edges [2, E], edge_types [E])`` with
    type ids 0 = succ, 1 = pred, 2 = proximal (``:518-540``)."""
    src, dst, typ = [], [], []
    for node_id in range(len(e_succ)):
        for dst_id in e_succ[node_id]:
            src.append(node_id), dst.append(dst_id), typ.append(0.0)
        for dst_id in e_pred[node_id]:
            src.append(node_id), dst.append(dst_id), typ.append(1.0)
        for dst_id in e_prox[node_id]:
            src.append(node_id), dst.append(dst_id), typ.append(2.0)
    return (
        np.asarray([src, dst], np.int64).reshape(2, -1),
        np.asarray(typ, np.float32),
    )


def lane2_subsets(
    lane_actor_index: np.ndarray, edges: Dict[str, List[List[int]]]
) -> Dict[str, np.ndarray]:
    """Per-actor lane-graph edges re-indexed into lane-actor-PAIR space
    (``nuScenes_hivt.py:355-394``): for each actor, every lane-graph edge
    whose endpoints are both among the actor's lanes becomes an edge
    between the corresponding lane-actor pair ids."""
    out = {k: [] for k in ("succ", "pred", "neigh")}
    if lane_actor_index.size == 0:
        return {k: np.zeros((2, 0), np.int64) for k in out}
    lanes, actors = lane_actor_index
    edge_ids = np.arange(lanes.shape[0])
    for actor in np.unique(actors):
        sel = actors == actor
        lane4actor, eids = lanes[sel], edge_ids[sel]
        by_lane: Dict[int, List[int]] = {}
        for l, e in zip(lane4actor, eids):
            by_lane.setdefault(int(l), []).append(int(e))
        for eid, src in zip(eids, lane4actor):
            for key in out:
                for dst in edges[key][int(src)]:
                    for ej in by_lane.get(int(dst), ()):
                        out[key].append((int(eid), ej))
    return {
        k: np.asarray(v, np.int64).reshape(-1, 2).T.copy() for k, v in out.items()
    }


def assign_goal_lanes(
    goal_pos: np.ndarray,
    goal_diff: np.ndarray,
    goal_mask: np.ndarray,
    segments: List[Dict[str, np.ndarray]],
    angle_thres_deg: float = 30.0,
    dist_thres: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-actor goal-lane assignment (``Argoverse_abs.py:343-391``).

    An actor's goal lane is the nearest segment whose closest-pose distance
    ≤ ``dist_thres`` and whose local direction is within
    ``angle_thres_deg`` of the actor's final heading (the angle test is
    skipped when the final displacement is < 0.1 m).

    Returns (goal_onehot [N, L], has_goal [N]).
    """
    N = goal_pos.shape[0]
    L = len(segments)
    goal = np.zeros((N, L), np.float32)
    has_goal = np.zeros((N,), bool)
    if L == 0:
        return goal, has_goal

    for n in range(N):
        if not goal_mask[n]:
            continue
        q, d = goal_pos[n], goal_diff[n]
        q_angle = np.arctan2(d[1], d[0])
        dists = np.empty(L)
        angs = np.empty(L)
        for l, seg in enumerate(segments):
            dd = np.linalg.norm(seg["positions"] - q, axis=-1)
            j = int(np.argmin(dd))
            dists[l] = dd[j]
            v = seg["vectors"][j]
            angs[l] = abs(wrap_angle(q_angle - np.arctan2(v[1], v[0])))
        ok = dists <= dist_thres
        if np.linalg.norm(d) >= 0.1:
            ok &= angs <= np.deg2rad(angle_thres_deg)
        if ok.any():
            cand = np.where(ok)[0]
            best = cand[int(np.argmin(dists[cand]))]
            goal[n, best] = 1.0
            has_goal[n] = True
    return goal, has_goal


def ref_positions_global(obs_steps, obs_xy, ref_step: int, origin) -> np.ndarray:
    """Global position of every actor at the reference step (``origin``
    placeholder for actors unobserved there) — the shared gather both
    dataset adapters use to query the lane provider."""
    return np.stack(
        [
            np.asarray(xy, np.float32)[list(np.asarray(st, int)).index(ref_step)]
            if ref_step in np.asarray(st, int)
            else origin
            for st, xy in zip(obs_steps, obs_xy)
        ]
    )
