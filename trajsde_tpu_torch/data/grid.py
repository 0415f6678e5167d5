"""Temporal-grid alignment of domain-native scenes (host-side numpy).

A copy of ``trajsde_tpu/data/grid.py``: the shared 21-past / 60-future
slot grid at 10 Hz, nuScenes (2 Hz) on every 5th slot with its
displacement features scaled by 1/5, Argoverse (10 Hz) on past slots 1-20
and future slots 0-29, and non-interest categories' futures masked out.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

TH, TF = 21, 60
REF_TIME = 20
NUS_SCALE = 5.0
CATEGORY_INTEREST = (0, 1, 2, 3, 4, 5, 7, 8)


def domain_slot_masks(source: int):
    """(past_slots [21], fut_slots [60]) of one source's samples."""
    past = np.zeros(TH, dtype=bool)
    fut = np.zeros(TF, dtype=bool)
    if source == 0:
        past[::5] = True
        fut[4::5] = True
    elif source == 1:
        past[1:] = True
        fut[:30] = True
    else:
        raise ValueError(f"unknown source {source}")
    return past, fut


def align_to_grid(scene: Dict[str, np.ndarray], is_gtabs: bool = True) -> Dict[str, np.ndarray]:
    """Scatter a domain-native scene onto the shared grid.

    Input arrays use the domain's own step counts (nuScenes 5 past / 12
    future; Argoverse 20 past / 30 future); output uses [TH]/[TF]/[TH+TF].
    """
    source = int(scene["source"])
    past_mask, fut_mask = domain_slot_masks(source)
    tot_mask = np.concatenate([past_mask, fut_mask])

    x = np.asarray(scene["x"], np.float32)
    y = scene.get("y")
    positions = np.asarray(scene["positions"], np.float32)
    padding = np.asarray(scene["padding_mask"], bool)
    bos = np.asarray(scene["bos_mask"], bool)
    N = x.shape[0]

    if source == 0:
        x = x / NUS_SCALE

    if not is_gtabs and y is not None:
        y = np.asarray(y, np.float32)
        y_pad = np.concatenate([np.zeros((N, 1, 2), np.float32), y], axis=1)
        y = y_pad[:, 1:] - y_pad[:, :-1]
        if source == 0:
            y = y / NUS_SCALE

    category = scene.get("category")
    if category is not None:
        interest = np.isin(np.asarray(category), np.asarray(CATEGORY_INTEREST))
        padding = padding.copy()
        # the last-60 slice runs on the DOMAIN-native axis: for nuScenes
        # (17 slots) that is the whole track
        padding[~interest, -min(TF, padding.shape[1]):] = True

    out = dict(scene)
    out.pop("category", None)

    gx = np.zeros((N, TH, 2), np.float32)
    gx[:, past_mask] = x
    gy = None
    if y is not None:
        gy = np.zeros((N, TF, 2), np.float32)
        gy[:, fut_mask] = y
    gbos = np.zeros((N, TH), bool)
    gbos[:, past_mask] = bos
    gpad = np.ones((N, TH + TF), bool)
    gpad[:, tot_mask] = padding
    gpos = np.zeros((N, TH + TF, 2), np.float32)
    gpos[:, tot_mask] = positions

    out.update(x=gx, y=gy, bos_mask=gbos, padding_mask=gpad, positions=gpos)
    return out
