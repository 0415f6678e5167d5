"""Weights across the two packages: flax parameter tree <-> ``state_dict``.

The port's modules carry the flax scope names, so a ``state_dict`` key is
the flax path joined by dots, with two renames: a Dense ``kernel [in, out]``
becomes ``Linear.weight [out, in]`` and a LayerNorm ``scale`` becomes its
``weight``.  Tokens (``bos_token``, ``hidden``) and biases keep their
names and layouts.  The round trip is exact.  :func:`aa_packed_from_flax`
packs a flax agent-agent subtree for the ``aa_attention`` op, and
:func:`adamw_state_from_optax` turns the JAX package's optax AdamW state
into the port's.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Mapping, Tuple

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


def _optax_states(node: Any):
    """The states of an optax chain, depth first (plain tuples are chains,
    named tuples states; ``MaskedState`` nests its own under
    ``inner_state``)."""
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        for child in node:
            yield from _optax_states(child)
        return
    yield node
    inner = getattr(node, "inner_state", None)
    if inner is not None:
        yield from _optax_states(inner)


def adamw_state_from_optax(opt_state: Any, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Tuple[dict, int]:
    """The JAX package's ``optax.adamw`` state
    (``trajsde_tpu/train/optim.py``: ``scale_by_adam``, the masked or plain
    weight decay, ``scale_by_learning_rate`` over the cosine schedule; its
    named tuples with numpy or array leaves) -> (a ``state_dict`` for
    ``optimizer``, the schedule's position for its ``LambdaLR``'s
    ``last_epoch``).

    ``ScaleByAdamState``'s ``mu`` / ``nu`` become each parameter's
    ``exp_avg`` / ``exp_avg_sq`` (flax kernels transposed, as
    :func:`params_from_flax` does) and its ``count`` the ``step``; the
    schedule's ``count`` is the position (the adam count when the chain
    keeps none).  The weight-decay mask carries no numbers: ``optimizer``,
    built by ``train/optim.py`` from the same config, holds it in its
    groups, whose hyperparameters are kept."""
    adam = sched = None
    for node in _optax_states(opt_state):
        fields = getattr(node, "_fields", ())   # a named tuple's, not tuple.count
        if "mu" in fields and "nu" in fields:
            adam = node
        elif "count" in fields:
            sched = node
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    count = int(np.asarray(adam.count))
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    names = {id(p): n for n, p in model.named_parameters()}
    out = optimizer.state_dict()
    state, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if tuple(mu[name].shape) != tuple(p.shape):
                raise ValueError(f"optax moment of {name!r} has shape {tuple(mu[name].shape)}, "
                                 f"the parameter {tuple(p.shape)}")
            state[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].to(p.dtype), "exp_avg_sq": nu[name].to(p.dtype)}
            i += 1
    missing = set(mu) - set(names.values())
    if missing:
        raise ValueError(f"optax moments without a parameter in the model: {sorted(missing)}")
    out["state"] = state
    position = count if sched is None else int(np.asarray(sched.count))
    return out, position


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
