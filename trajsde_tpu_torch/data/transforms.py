"""Scene-batch transforms on the device (``trajsde_tpu/data/transforms.py``).

* :func:`ts_drop`: random historical-step masking, the reference's
  ``ts_drop`` regularizer.  Each historical step drops with probability
  ``rate``, except begin-of-sequence steps and the last historical step;
  a dropped step zeroes its features and joins the padding mask.
* :func:`leave_only_agent` and :func:`leave_only_agent_output`: a batch,
  and a decoder output, cut down to each scene's focal agent (a 1-actor
  batch whose one slot is the agent).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from trajsde_tpu_torch.data.scene import SceneBatch


def ts_drop(scene: SceneBatch, rate: float, generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None) -> SceneBatch:
    """Drop historical steps with probability ``rate``.  The uniform draws
    are ``u`` (``bos_mask``'s shape) when given, else drawn from
    ``generator`` on the scene's device."""
    th = scene.historical_steps
    if u is None:
        u = torch.rand(scene.bos_mask.shape, generator=generator, device=scene.x.device)
    drop = (u.to(scene.x.device) < rate) & ~scene.bos_mask
    drop[:, :, -1] = False
    x = scene.x.masked_fill(drop[..., None], 0.0)
    padding = scene.padding_mask.clone()
    padding[:, :, :th] |= drop
    return dataclasses.replace(scene, x=x, padding_mask=padding)


def take_per_scene(arr: Optional[torch.Tensor], idx: torch.Tensor, axis: int = 1
                   ) -> Optional[torch.Tensor]:
    """One index per scene along ``axis``, kept as a size-1 axis (None
    passes through)."""
    if arr is None:
        return None
    shape = [1] * arr.ndim
    shape[0] = arr.shape[0]
    sizes = list(arr.shape)
    sizes[axis] = 1
    return torch.gather(arr, axis, idx.to(torch.int64).reshape(shape).expand(sizes))


def leave_only_agent_output(output: dict, agent_index: torch.Tensor) -> dict:
    """A decoder output dict cut to the focal-agent rows (size-1 actor
    axis): the output half of :func:`leave_only_agent`."""
    out = dict(output)
    out["loc"] = take_per_scene(output["loc"], agent_index, axis=2)
    out["reg_mask"] = take_per_scene(output["reg_mask"], agent_index, axis=1)
    for key in ("pi", "y"):
        if output.get(key) is not None:
            out[key] = take_per_scene(output[key], agent_index, axis=1)
    return out


def leave_only_agent(scene: SceneBatch) -> SceneBatch:
    """The batch cut to its focal agents: every per-actor field keeps the
    agent's slot, which becomes slot 0 (``agent_index`` and ``av_index``)."""
    idx = scene.agent_index
    zeros = torch.zeros_like(idx)
    fields = ("x", "y", "positions", "padding_mask", "bos_mask", "rotate_angles",
              "actor_valid", "goal_idcs", "has_goal")
    return dataclasses.replace(
        scene, **{f: take_per_scene(getattr(scene, f), idx) for f in fields},
        agent_index=zeros, av_index=zeros)
