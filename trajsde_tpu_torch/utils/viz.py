"""Scene, prediction and OOD plots (``trajsde_tpu/utils/viz.py``).

``viz_scene`` draws the history, the lanes and the future; ``viz_predictions``
the decoder's modes against the ground truth; ``viz_ood`` colours each
actor by its OOD score (the analog of the commented-out std plots in the
reference's ``enc_hivt_nusargo_sde_sep2.py:320-368``).  matplotlib is
imported at the first plot, with the ``Agg`` backend, so importing this
module needs no matplotlib.  Tensors of a ``SceneBatch`` on any device are
read through ``.detach().cpu().numpy()``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _scene_arrays(scene, b: int) -> dict:
    has_lanes = scene.lane_positions is not None
    return {
        "positions": _np(scene.positions[b]),
        "padding": _np(scene.padding_mask[b]),
        # lane fields are optional on SceneBatch: draw actors-only scenes
        "lanes": _np(scene.lane_positions[b]) if has_lanes else np.zeros((0, 1, 2), np.float32),
        "lane_pad": _np(scene.lane_paddings[b]) if has_lanes else np.ones((0, 1), bool),
        "lane_valid": _np(scene.lane_valid[b]) if has_lanes else np.zeros((0,), bool),
        "actor_valid": _np(scene.actor_valid[b]),
        "agent": int(scene.agent_index[b]),
        "th": int(scene.historical_steps),
    }


def _draw_base(ax, s: dict) -> None:
    for lane in range(s["lanes"].shape[0]):
        if not s["lane_valid"][lane]:
            continue
        poses = s["lanes"][lane][~s["lane_pad"][lane]]
        ax.plot(poses[:, 0], poses[:, 1], color="0.8", lw=1, zorder=0)
    th = s["th"]
    for a in range(s["positions"].shape[0]):
        if not s["actor_valid"][a]:
            continue
        hist = s["positions"][a, :th][~s["padding"][a, :th]]
        color = "tab:red" if a == s["agent"] else "tab:blue"
        if len(hist):
            ax.plot(hist[:, 0], hist[:, 1], color=color, lw=1.5)
            ax.scatter(hist[-1, 0], hist[-1, 1], color=color, s=12, zorder=3)
    ax.set_aspect("equal")


def _save(plt, fig, out_path: str) -> str:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def viz_scene(scene, b: int, out_path: str) -> str:
    """Scene ``b``: lanes, histories and futures (needs the future positions)."""
    plt = _plt()
    s = _scene_arrays(scene, b)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_base(ax, s)
    th = s["th"]
    for a in range(s["positions"].shape[0]):
        if not s["actor_valid"][a]:
            continue
        fut = s["positions"][a, th:][~s["padding"][a, th:]]
        if len(fut):
            ax.plot(fut[:, 0], fut[:, 1], color="tab:green", lw=1, alpha=0.7)
    return _save(plt, fig, out_path)


def viz_predictions(scene, output, b: int, out_path: str, actor: Optional[int] = None) -> str:
    """The decoder's modes of one actor (agent frame -> scene frame) over
    scene ``b``."""
    plt = _plt()
    s = _scene_arrays(scene, b)
    a = s["agent"] if actor is None else actor
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_base(ax, s)
    th = s["th"]
    origin = s["positions"][a, th - 1]
    ang = float(_np(scene.rotate_angles[b, a]))
    c, si = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -si], [si, c]], np.float32)
    loc = _np(output["loc"][b, :, a, :, :2])  # [F, Tf, 2] agent frame
    for f in range(loc.shape[0]):
        world = loc[f] @ rot.T + origin
        ax.plot(world[:, 0], world[:, 1], color="tab:orange", lw=1, alpha=0.6)
    fut = s["positions"][a, th:][~s["padding"][a, th:]]
    if len(fut):
        ax.plot(fut[:, 0], fut[:, 1], color="tab:green", lw=2)
    return _save(plt, fig, out_path)


def viz_ood(scene, stds, b: int, out_path: str) -> str:
    """Colour the actors of scene ``b`` by their OOD score (``stds [B, A]``,
    the embedding std over SDE samples).  Reads only the history and the
    lanes, so a batch whose future positions were stripped for the device
    draws the same picture."""
    plt = _plt()
    s = _scene_arrays(scene, b)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_base(ax, s)
    std = _np(stds[b])
    th = s["th"]
    # actors unobserved at the reference step hold zero placeholders:
    # without the padding mask they would scatter as a cluster at (0, 0)
    valid = s["actor_valid"] & ~s["padding"][:, th - 1]
    pos = s["positions"][:, th - 1]
    sc = ax.scatter(pos[valid, 0], pos[valid, 1], c=std[valid], cmap="viridis", s=40, zorder=4)
    fig.colorbar(sc, ax=ax, label="OOD std")
    return _save(plt, fig, out_path)
