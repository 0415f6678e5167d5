"""Weights across the two packages: flax parameter tree <-> ``state_dict``.

The port's modules carry the flax scope names, so a ``state_dict`` key is
the flax path joined by dots, with two renames: a Dense ``kernel [in, out]``
becomes ``Linear.weight [out, in]`` and a LayerNorm ``scale`` becomes its
``weight``.  Tokens (``bos_token``, ``hidden``) and biases keep their
names and layouts.  The round trip is exact.  :func:`aa_packed_from_flax`
packs a flax agent-agent subtree for the ``aa_attention`` op.
"""
from __future__ import annotations

from types import SimpleNamespace
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


def aa_packed_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax AA subtree ``{"nbr_embed": ..., "attn": ...}`` (a linen
    ``MultipleInputEmbedding`` and ``EdgeAttention``, numpy leaves) -> the
    packed pair-chain weights plus ``wq`` / ``bq``, equal to
    ``pack_aa_params`` of the JAX package: the port's two modules load the
    subtree and :func:`~trajsde_tpu_torch.ops.aa_fused.pack_aa_params`
    packs them."""
    from trajsde_tpu_torch.models.embedding import MultipleInputEmbedding
    from trajsde_tpu_torch.models.layers import EdgeAttention
    from trajsde_tpu_torch.ops.aa_fused import pack_aa_params

    D = np.asarray(tree["nbr_embed"]["in0_dense0"]["kernel"]).shape[1]
    nbr = MultipleInputEmbedding([2, 2], D)
    nbr.load_state_dict(params_from_flax(tree["nbr_embed"]))
    attn = EdgeAttention(D, 1)  # the head count shapes no parameter
    attn.load_state_dict(params_from_flax(tree["attn"]))
    return pack_aa_params(SimpleNamespace(nbr_embed=nbr, attn=attn))


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
