"""Serving engine, synchronous slice (``trajsde_tpu/server.py``).

``ServingEngine.predict(raw_scenes)`` grid-aligns preprocessor-output
scene dicts, packs them into padded batch buckets (the last scene repeats
to fill a bucket), runs the kernel serving forward and projects the
focal agent's modes back into the world frame.  Every batch's randomness
derives on the host from ``(seed, counter)``: the encoder draws from a
``torch.Generator`` seeded with ``mix_seed(seed, counter)``, and the
rollout kernel's seed is the same value.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from trajsde_tpu_torch.data.grid import NUS_SCALE, align_to_grid
from trajsde_tpu_torch.data.pack import pack_scenes, pick_bucket
from trajsde_tpu_torch.device import resolve_device
from trajsde_tpu_torch.models.sde_encoder import gather_agent
from trajsde_tpu_torch.ops.sde_rollout import mix_seed
from trajsde_tpu_torch.serving import make_serving_fn

__all__ = ["ServingEngine", "align_scene", "make_postprocess", "mix_seed"]


def make_postprocess(is_gtabs: bool, ref_time: int, slim: bool = False):
    """Focal-agent world-frame projection: agent modes rotated out of the
    agent frame and offset by its reference-time position, plus softmax
    mode scores.  Delta-target outputs (``is_gtabs=False``) are cumsummed
    and nuScenes rows scaled back to metres first.  ``slim=True`` drops the
    dense per-actor grids from the result."""

    def postprocess(scene, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loc = out["loc"][..., :2]
        if not is_gtabs:
            loc = torch.cumsum(loc, dim=-2)
            scale = torch.where(scene.source == 0, NUS_SCALE, 1.0).to(loc.dtype)
            loc_m = loc * scale.reshape(scale.shape + (1,) * (loc.ndim - 1))
        else:
            loc_m = loc
        idx = scene.agent_index
        agent_loc = gather_agent(loc_m, idx, axis=2)                # [B, K, Tf, 2]
        ang = gather_agent(scene.rotate_angles, idx, axis=1)
        c, s = torch.cos(ang), torch.sin(ang)
        rot_t = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
        origin = gather_agent(scene.positions[:, :, ref_time], idx, axis=1)
        world = torch.einsum("bktj,bji->bkti", agent_loc, rot_t) + origin[:, None, None]
        pi = torch.softmax(gather_agent(out["pi"], idx, axis=1), dim=-1)
        res = {"agent_world": world, "agent_pi": pi}
        if not slim:
            res["loc"] = loc
            res["pi_all"] = out["pi"]
        if "stds" in out:
            res["stds"] = out["stds"].float()
            res["agent_std"] = gather_agent(res["stds"], idx, axis=1)
        return res

    return postprocess


def align_scene(raw: Dict[str, np.ndarray], is_gtabs: bool = True) -> Tuple[Dict, int]:
    """Grid-align one raw scene -> ``(aligned, seq_id)`` (seq_id -1 when
    the scene carries no identity)."""
    sid = int(np.asarray(raw["seq_id"])) if "seq_id" in raw else -1
    aligned = align_to_grid(dict(raw, source=raw.get("source", np.int32(0))),
                            is_gtabs=is_gtabs)
    return aligned, sid


class ServingEngine:
    """Bucketed synchronous serving of an SDE-decoder model on ``device``."""

    def __init__(
        self,
        model,
        *,
        num_actors: int,
        num_lanes: int,
        device="cuda",
        increments: str = "rademacher",
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
        max_batch=None,
        is_gtabs: bool = True,
        ref_time: int = 20,
        seed: int = 0,
        ood: bool = False,
        slim: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.buckets = tuple(b for b in sorted(batch_buckets)
                             if max_batch is None or b <= max_batch)
        if not self.buckets:
            raise ValueError(f"max_batch={max_batch} excludes every batch bucket "
                             f"{tuple(sorted(batch_buckets))}")
        self.max_batch = self.buckets[-1]
        self.num_actors = num_actors
        self.num_lanes = num_lanes
        self.is_gtabs = is_gtabs
        self.ood = ood
        self.slim = slim
        self._seed = int(seed)
        self._counter = 0
        self._serve = make_serving_fn(model, self.device, increments=increments, ood=ood)
        self._post = make_postprocess(is_gtabs, ref_time, slim=slim)

    def predict(self, raw_scenes: List[Dict[str, np.ndarray]]) -> List[Dict]:
        """Batched prediction, ``max_batch`` scenes at a time, each batch
        padded to the bucket that covers it."""
        out: List[Dict] = []
        for i in range(0, len(raw_scenes), self.max_batch):
            aligned = [align_scene(s, self.is_gtabs)
                       for s in raw_scenes[i: i + self.max_batch]]
            out.extend(self._run_batch(aligned))
        return out

    def _run_batch(self, aligned_scenes: List[Tuple[Dict, int]]) -> List[Dict]:
        n = len(aligned_scenes)
        bucket = pick_bucket(n, self.buckets)
        aligned = [a for a, _ in aligned_scenes]
        padded = aligned + [aligned[-1]] * (bucket - n)
        scene = pack_scenes(padded, self.num_actors, self.num_lanes).to(self.device)
        self._counter += 1
        seed = mix_seed(self._seed, self._counter)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            post = self._post(scene, self._serve(scene, seed, generator=gen))
        post = {k: v.cpu().numpy() for k, v in post.items()}
        results = []
        for i in range(n):
            r = {
                "agent_world": post["agent_world"][i],
                "agent_pi": post["agent_pi"][i],
                "seq_id": np.int32(aligned_scenes[i][1]),
            }
            if not self.slim:
                r["loc"] = post["loc"][i]
                r["pi"] = post["pi_all"][i]
            if self.ood:
                r["ood_std"] = post["stds"][i]
                r["agent_std"] = post["agent_std"][i]
            results.append(r)
        return results
