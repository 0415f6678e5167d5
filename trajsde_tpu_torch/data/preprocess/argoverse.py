"""Argoverse v1 offline preprocessor → per-scene ``.npz`` shards.

Capability analog of ``dataset/Argoverse/Argoverse_abs.py`` re-structured
around the pure geometry in :mod:`.common`: per forecasting CSV —

* actors filtered to those present at the reference step 19
  (``Argoverse_abs.py:180-185``);
* AV-centered scene frame rotated by the AV heading (``:193-197``);
* padded tracks / bos masks / per-actor headings (``:200-231``);
* lane centerlines within 80 m of any ref-step actor, resampled at 1 m and
  chunked into ≤10-pose segments (``:285-341``);
* goal-lane assignment at distance ≤ 2.5 m / heading ≤ 30° (``:343-391``).

The map API is injected (``lane_provider``) so the transform pipeline is
testable without ``argoverse-api``; when the devkit is installed the
default provider wraps ``ArgoverseMap``.

The port's copy of ``trajsde_tpu/data/preprocess/argoverse.py`` (numpy only);
its code differs only in the import paths.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from trajsde_tpu_torch.data.preprocess import common

REF_STEP = 19
NUM_PAST, NUM_FUT = 20, 30


def devkit_lane_provider():
    """Default lane provider backed by ``argoverse-api`` (import-gated)."""
    from argoverse.map_representation.map_api import ArgoverseMap  # type: ignore

    am = ArgoverseMap()

    def provider(positions_global: np.ndarray, city: str, radius: float = 80.0):
        lane_ids = set()
        for p in positions_global:
            lane_ids.update(am.get_lane_ids_in_xy_bbox(p[0], p[1], city, radius))
        return [
            np.asarray(am.get_lane_segment_centerline(lid, city)[:, :2], np.float32)
            for lid in lane_ids
        ]

    return provider


def process_scene(
    obs_steps: List[np.ndarray],
    obs_xy: List[np.ndarray],
    av_track: int,
    agent_track: int,
    city: str,
    lane_provider: Callable,
    lseg_len: int = 10,
) -> Optional[dict]:
    """Assemble one raw scene dict from extracted track observations."""
    av_xy = obs_xy[av_track]
    av_steps = np.asarray(obs_steps[av_track], int)
    if REF_STEP not in av_steps or (REF_STEP - 1) not in av_steps:
        return None
    origin = np.asarray(av_xy[list(av_steps).index(REF_STEP)], np.float32)
    prev = np.asarray(av_xy[list(av_steps).index(REF_STEP - 1)], np.float32)
    rot, theta = common.scene_frame(origin, origin - prev)

    tracks = common.build_tracks(obs_steps, obs_xy, NUM_PAST, NUM_FUT, origin, rot)

    ref_valid = ~tracks["padding_mask"][:, REF_STEP]
    ref_pos_global = common.ref_positions_global(obs_steps, obs_xy, REF_STEP, origin)
    centerlines = lane_provider(ref_pos_global[ref_valid], city)

    segments = []
    for cl in centerlines:
        pts = common.resample_polyline(common.to_scene(cl, origin, rot))
        segments.extend(common.chunk_centerline(pts, lseg_len))
    lanes = common.pad_lane_segments(segments, lseg_len)

    goal_pos = tracks["positions"][:, -1]
    # verbatim reference quirk (``Argoverse_abs.py:240``): the penultimate
    # position may be a zero placeholder when that step is padded, making
    # the heading spurious for actors unobserved at step -2 — reproduced
    # for label parity, not endorsed
    goal_diff = tracks["positions"][:, -1] - tracks["positions"][:, -2]
    goal_mask = ~tracks["padding_mask"][:, -1]
    goal_idcs, has_goal = common.assign_goal_lanes(
        goal_pos, goal_diff, goal_mask, segments
    )

    return dict(
        **tracks,
        **lanes,
        goal_idcs=goal_idcs,
        has_goal=has_goal,
        agent_index=np.int32(agent_track),
        av_index=np.int32(av_track),
        theta=np.float32(theta),
        source=np.int32(1),
    )


class ArgoversePreprocessor:
    """Directory-level runner: forecasting CSVs → ``.npz`` scene shards."""

    def __init__(
        self,
        raw_dir: str,
        out_dir: str,
        lane_provider: Optional[Callable] = None,
        lseg_len: int = 10,
    ):
        self.raw_dir = raw_dir
        self.out_dir = out_dir
        self.lane_provider = lane_provider or devkit_lane_provider()
        self.lseg_len = lseg_len

    def process_csv(self, path: str) -> Optional[dict]:
        import pandas as pd

        df = pd.read_csv(path)
        timestamps = np.sort(df["TIMESTAMP"].unique())
        if len(timestamps) <= REF_STEP:
            return None  # truncated CSV: no reference step to anchor on
        ref_df = df[df["TIMESTAMP"] == timestamps[REF_STEP]]
        actor_ids = list(ref_df["TRACK_ID"].unique())
        df = df[df["TRACK_ID"].isin(actor_ids)]

        step_of = {t: i for i, t in enumerate(timestamps)}
        obs_steps, obs_xy = [], []
        for tid in actor_ids:
            tdf = df[df["TRACK_ID"] == tid].sort_values("TIMESTAMP")
            obs_steps.append(np.array([step_of[t] for t in tdf["TIMESTAMP"]], int))
            obs_xy.append(tdf[["X", "Y"]].to_numpy(np.float32))

        av_ids = df[df["OBJECT_TYPE"] == "AV"]["TRACK_ID"]
        agent_ids = df[df["OBJECT_TYPE"] == "AGENT"]["TRACK_ID"]
        if av_ids.empty or agent_ids.empty:
            # AV/AGENT absent at the reference timestamp: skip the scene
            # (the same unprocessable-scene contract as process_scene's
            # missing-heading path) instead of IndexError-ing the run
            return None
        av_id = av_ids.iloc[0]
        agent_id = agent_ids.iloc[0]
        return process_scene(
            obs_steps,
            obs_xy,
            actor_ids.index(av_id),
            actor_ids.index(agent_id),
            str(df["CITY_NAME"].iloc[0]),
            self.lane_provider,
            self.lseg_len,
        )

    def run(self) -> int:
        os.makedirs(self.out_dir, exist_ok=True)
        count = 0
        for fn in sorted(os.listdir(self.raw_dir)):
            if not fn.endswith(".csv"):
                continue
            scene = self.process_csv(os.path.join(self.raw_dir, fn))
            if scene is None:
                continue
            np.savez(
                os.path.join(self.out_dir, os.path.splitext(fn)[0] + ".npz"), **scene
            )
            count += 1
        return count


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--raw-dir", required=True)
    p.add_argument("--out-dir", required=True)
    args = p.parse_args()
    n = ArgoversePreprocessor(args.raw_dir, args.out_dir).run()
    print(f"processed {n} scenes")
