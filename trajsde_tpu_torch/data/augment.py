"""Train-time geometric augmentation (host-side numpy), a copy of
``trajsde_tpu/data/augment.py``.

A random x- and/or y-flip of all scene geometry, lanes included, drawn
from a seeded ``numpy.random.Generator``.  The same float operations as the
JAX package's, so a flipped scene is bit-equal to its.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_GEOM_KEYS = (
    "x",
    "y",
    "positions",
    "lane_positions",
    "lane_vectors",
    "lane_actor_vectors",
)


def _flip(scene: Dict[str, np.ndarray], axis: int) -> None:
    """Negate coordinate ``axis`` (0 = x-flip, 1 = y-flip) in place."""
    sign = np.ones(2, np.float32)
    sign[axis] = -1.0
    for key in _GEOM_KEYS:
        if scene.get(key) is not None:
            scene[key] = scene[key] * sign
    for key in ("theta", "rotate_angles"):
        if scene.get(key) is not None:
            ang = scene[key]
            cx, sy = np.cos(ang), np.sin(ang)
            if axis == 0:  # x-flip: atan2(sin, -cos)
                scene[key] = np.arctan2(sy, -cx).astype(np.float32)
            else:  # y-flip: atan2(-sin, cos)
                scene[key] = np.arctan2(-sy, cx).astype(np.float32)


def random_flip(scene: Dict[str, np.ndarray], rng: np.random.Generator) -> Dict[str, np.ndarray]:
    scene = dict(scene)
    if rng.integers(0, 2):
        _flip(scene, 0)
    if rng.integers(0, 2):
        _flip(scene, 1)
    return scene
