"""Weights across the two packages: flax parameter tree <-> ``state_dict``.

The port's modules carry the flax scope names, so a ``state_dict`` key is
the flax path joined by dots, with two renames: a Dense ``kernel [in, out]``
becomes ``Linear.weight [out, in]`` and a LayerNorm ``scale`` becomes its
``weight``.  Tokens (``bos_token``, ``hidden``) and biases keep their
names and layouts.  The round trip is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A nested dict of arrays (optionally under ``"params"``) -> the
    port's ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            a = np.asarray(val)
            if key == "kernel":
                key, a = "weight", a.T
            elif key == "scale":
                key = "weight"
            out[".".join(prefix + (key,))] = torch.from_numpy(np.ascontiguousarray(a).copy())

    walk(tree, ())
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the flax parameter tree (numpy leaves,
    without the ``"params"`` wrapper)."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        *path, key = name.split(".")
        a = t.detach().cpu().numpy()
        if key == "weight":
            key, a = ("kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = np.ascontiguousarray(a).copy()
    return tree
