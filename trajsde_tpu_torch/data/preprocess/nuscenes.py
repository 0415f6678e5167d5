"""nuScenes offline preprocessor → per-scene ``.npz`` shards.

Capability analog of ``dataset/nuScenes/nuScenes_hivt.py`` on the pure
geometry of :mod:`.common`: per prediction-challenge token —

* target-agent-centered scene frame from the annotation pose, heading
  from the annotation quaternion (``nuScenes_hivt.py:180-193,217-219``);
* 2 Hz tracks: 4 past + reference + 12 future steps via ``PredictHelper``
  past/future windows, parked vehicles skipped (``:545-605``);
* lane geometry from ``NuScenesMap`` arcline paths within ``radius``,
  discretized at 1 m and chunked into ≤10-pose segments (``:449-543``);
* per-actor integer ``category`` ids (``:39-41``) — consumed by the
  runtime CATEGORY_INTEREST future-masking rule;
* goal-lane assignment as in the Argoverse pipeline (``:294-394``).

Devkit access is isolated in :func:`devkit_scene_iter` /
:func:`devkit_lane_provider`; everything else is testable without it.

The port's copy of ``trajsde_tpu/data/preprocess/nuscenes.py`` (numpy only);
its code differs only in the import paths.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np

from trajsde_tpu_torch.data.preprocess import common

NUM_PAST, NUM_FUT = 5, 12
REF_STEP = NUM_PAST - 1

CATEGORY_IDS: Dict[str, int] = {
    "vehicle.car": 0,
    "vehicle.truck": 1,
    "vehicle.bus": 2,
    "vehicle.construction": 3,
    "vehicle.emergency": 4,
    "vehicle.trailer": 5,
    "vehicle.motorcycle": 6,
    "vehicle.bicycle": 7,
    "human.pedestrian": 8,
    "movable_object": 9,
    "static_object": 10,
}


def category_id(category_name: str) -> int:
    for prefix, cid in CATEGORY_IDS.items():
        if category_name.startswith(prefix):
            return cid
    return 11


def devkit_lane_provider(nusc_map_root: str):
    """Lane provider over ``NuScenesMap`` arcline paths (import-gated).

    Returns ``(centerlines, tokens, outgoing)`` — the outgoing-lane token
    map feeds the lane-graph connectivity extraction
    (``nuScenes_hivt.py:663-681``).
    """
    from nuscenes.map_expansion.map_api import NuScenesMap  # type: ignore
    from nuscenes.map_expansion import arcline_path_utils  # type: ignore

    maps: Dict[str, object] = {}

    def provider(positions_global: np.ndarray, map_name: str, radius: float = 80.0):
        if map_name not in maps:
            maps[map_name] = NuScenesMap(dataroot=nusc_map_root, map_name=map_name)
        nmap = maps[map_name]
        lane_tokens = set()
        for p in positions_global:
            records = nmap.get_records_in_radius(p[0], p[1], radius, ["lane", "lane_connector"])
            lane_tokens.update(records["lane"])
            lane_tokens.update(records["lane_connector"])
        centerlines, tokens, outgoing = [], [], {}
        # sorted: set iteration order is salted by PYTHONHASHSEED — shards
        # must be byte-reproducible across runs
        for tok in sorted(lane_tokens):
            path = nmap.get_arcline_path(tok)
            poses = arcline_path_utils.discretize_lane(path, resolution_meters=1.0)
            if len(poses) >= 2:
                centerlines.append(np.asarray(poses, np.float32)[:, :2])
                tokens.append(tok)
                outgoing[tok] = list(nmap.get_outgoing_lane_ids(tok))
        return centerlines, tokens, outgoing

    return provider


def process_scene(
    obs_steps: List[np.ndarray],
    obs_xy: List[np.ndarray],
    categories: List[int],
    agent_track: int,
    origin: np.ndarray,
    heading_vec: np.ndarray,
    map_name: str,
    lane_provider: Callable,
    lseg_len: int = 10,
) -> dict:
    """Assemble one raw nuScenes scene dict from extracted observations."""
    rot, theta = common.scene_frame(origin, heading_vec)
    tracks = common.build_tracks(obs_steps, obs_xy, NUM_PAST, NUM_FUT, origin, rot)

    ref_valid = ~tracks["padding_mask"][:, REF_STEP]
    ref_global = common.ref_positions_global(obs_steps, obs_xy, REF_STEP, origin)
    provided = lane_provider(ref_global[ref_valid], map_name)
    if isinstance(provided, tuple):
        centerlines, lane_tokens, outgoing = provided
    else:  # legacy provider: centerlines only, no connectivity
        centerlines, lane_tokens, outgoing = provided, list(range(len(provided))), {}
    segments, seg_tokens = [], []
    for cl, tok in zip(centerlines, lane_tokens):
        pts = common.resample_polyline(common.to_scene(cl, origin, rot))
        chunks = common.chunk_centerline(pts, lseg_len)
        segments.extend(chunks)
        seg_tokens.extend([tok] * len(chunks))
    lanes = common.pad_lane_segments(segments, lseg_len)

    # lane-graph connectivity (nuScenes_hivt.py:449-543,663-726)
    e_succ = common.successor_edges(seg_tokens, outgoing)
    e_pred = common.predecessor_edges(e_succ)
    e_prox = common.proximal_edges(
        [s["positions"] for s in segments], [s["vectors"] for s in segments], e_succ
    )
    lane_edges, lane_edge_types = common.lane_edge_arrays(e_succ, e_pred, e_prox)

    goal_pos = tracks["positions"][:, -1]
    # verbatim reference quirk (see argoverse.py note / Argoverse_abs.py:240):
    # a padded penultimate step leaves a zero placeholder in the diff
    goal_diff = tracks["positions"][:, -1] - tracks["positions"][:, -2]
    goal_mask = ~tracks["padding_mask"][:, -1]
    goal_idcs, has_goal = common.assign_goal_lanes(goal_pos, goal_diff, goal_mask, segments)

    # per-actor lane2 subsets in lane-actor-pair space (``:355-394``): the
    # directional window at the reference step defines the pairs
    lane_ends = np.stack(
        [s["positions"][min(int(s["count"]), lseg_len) - 1] for s in segments]
    ) if segments else np.zeros((0, 2), np.float32)
    pair_lanes, pair_actors = [], []
    c, s_ = np.cos(tracks["rotate_angles"]), np.sin(tracks["rotate_angles"])
    for a in np.nonzero(ref_valid)[0]:
        vec = lane_ends - tracks["positions"][a, REF_STEP]
        lon = vec[:, 0] * c[a] + vec[:, 1] * s_[a]
        lat = -vec[:, 0] * s_[a] + vec[:, 1] * c[a]
        ok = (-20 < lon) & (lon < 80) & (-50 < lat) & (lat < 50)
        for l in np.nonzero(ok)[0]:
            pair_lanes.append(l)
            pair_actors.append(a)
    lane_actor_index = np.asarray([pair_lanes, pair_actors], np.int64).reshape(2, -1)
    lane2 = common.lane2_subsets(
        lane_actor_index, {"succ": e_succ, "pred": e_pred, "neigh": e_prox}
    )

    return dict(
        **tracks,
        **lanes,
        goal_idcs=goal_idcs,
        has_goal=has_goal,
        category=np.asarray(categories, np.int32),
        agent_index=np.int32(agent_track),
        av_index=np.int32(agent_track),  # target-centered frame: anchor = agent
        theta=np.float32(theta),
        source=np.int32(0),
        lane_edges=lane_edges,
        lane_edge_types=lane_edge_types,
        # lane2_* edges index into THIS pair enumeration — persist it or
        # the pair ids are uninterpretable downstream (the runtime
        # al_edges applies a radius filter, so counts/order differ)
        lane_actor_index=lane_actor_index,
        lane2_succ=lane2["succ"],
        lane2_pred=lane2["pred"],
        lane2_neigh=lane2["neigh"],
    )


class NuScenesPreprocessor:
    """Prediction-challenge runner: tokens → ``.npz`` scene shards."""

    def __init__(
        self,
        dataroot: str,
        out_dir: str,
        split: str = "train",
        version: str = "v1.0-trainval",
        lseg_len: int = 10,
    ):
        self.dataroot = dataroot
        self.out_dir = out_dir
        self.split = split
        self.version = version
        self.lseg_len = lseg_len

    def run(self) -> int:
        from nuscenes import NuScenes  # type: ignore
        from nuscenes.prediction import PredictHelper  # type: ignore
        from nuscenes.eval.prediction.splits import get_prediction_challenge_split  # type: ignore
        from pyquaternion import Quaternion  # type: ignore

        nusc = NuScenes(version=self.version, dataroot=self.dataroot, verbose=False)
        helper = PredictHelper(nusc)
        lane_provider = devkit_lane_provider(self.dataroot)
        tokens = get_prediction_challenge_split(self.split, dataroot=self.dataroot)
        os.makedirs(self.out_dir, exist_ok=True)

        count = 0
        for token in tokens:
            instance_token, sample_token = token.split("_")
            ann = helper.get_sample_annotation(instance_token, sample_token)
            origin = np.asarray(ann["translation"][:2], np.float32)
            q = Quaternion(ann["rotation"])
            yaw = q.yaw_pitch_roll[0]
            heading = np.array([np.cos(yaw), np.sin(yaw)], np.float32)

            sample = nusc.get("sample", sample_token)
            scene = nusc.get("scene", sample["scene_token"])
            log = nusc.get("log", scene["log_token"])

            obs_steps, obs_xy, categories = [], [], []
            agent_track = None
            for i, a in enumerate(helper.get_annotations_for_sample(sample_token)):
                inst = a["instance_token"]
                # reference actor filter (nuScenes_hivt.py:556-563): vehicles
                # only, and PARKED vehicles are skipped entirely unless they
                # are the focal instance — a data-distribution rule, not
                # just a mask
                if "vehicle" not in a["category_name"] and inst != instance_token:
                    continue
                if (
                    inst != instance_token
                    and a["attribute_tokens"]
                    and "parked"
                    in nusc.get("attribute", a["attribute_tokens"][0])["name"]
                ):
                    continue
                past = helper.get_past_for_agent(
                    inst, sample_token, seconds=2, in_agent_frame=False
                )
                fut = helper.get_future_for_agent(
                    inst, sample_token, seconds=6, in_agent_frame=False
                )
                now = np.asarray(a["translation"][:2], np.float32)[None]
                past = np.asarray(past, np.float32).reshape(-1, 2)[::-1]
                fut = np.asarray(fut, np.float32).reshape(-1, 2)
                xy = np.concatenate([past, now, fut], 0)
                start = REF_STEP - len(past)
                steps = np.arange(start, start + len(xy))
                keep = (steps >= 0) & (steps < NUM_PAST + NUM_FUT)
                obs_steps.append(steps[keep])
                obs_xy.append(xy[keep])
                categories.append(category_id(a["category_name"]))
                if inst == instance_token:
                    agent_track = len(obs_steps) - 1
            if agent_track is None:
                continue

            out = process_scene(
                obs_steps, obs_xy, categories, agent_track, origin, heading,
                log["location"], lane_provider, self.lseg_len,
            )
            np.savez(os.path.join(self.out_dir, f"{token}.npz"), **out)
            count += 1
        return count


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args()
    n = NuScenesPreprocessor(args.dataroot, args.out_dir, args.split, args.version).run()
    print(f"processed {n} scenes")
