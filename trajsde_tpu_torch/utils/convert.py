"""Reference-checkpoint import: a Lightning ``state_dict`` -> the port's
``state_dict`` (``trajsde_tpu/utils/convert.py``).

A user migrating from the reference (daeheepark/TrajSDE) holds
checkpoints written by Lightning's ``ModelCheckpoint``: a torch pickle
whose ``state_dict`` holds ``encoder.* / aggregator.* / decoder.*``
tensors named by the reference's module attributes.  This module maps
every live tensor onto the port's model, so the checkpoint serves or
fine-tunes here without retraining (``scripts/convert_checkpoint_torch.py``,
then ``test_torch.py --ckpt`` / ``train_torch.py --wonly``).

The rule table is the JAX package's, keyed by the port's ``state_dict``
keys instead of flax paths: a port key is the flax path joined by dots,
with a Dense ``kernel`` and a LayerNorm ``scale`` named ``weight``
(``bridge.py``).  A reference ``nn.Linear.weight [out, in]`` is already
the port's ``Linear.weight``, so linear weights (and the temporal
encoder's ``self_attn.in_proj_weight``) pass unchanged; the temporal
encoder's token and position parameters drop their singleton broadcast
axis.  Known-dead reference tensors are skipped by name
(``_SKIP_SUFFIXES``, ``_SKIP_EXACT``): the ALEncoder's intersection /
turn / control embeddings, which no live config consumes
(``enc_hivt_nusargo_grid.py:325-330``), the decoder's ``hidden``, never
read in its forward (``dec_hivt_nusargo_sde.py:69,86``), the OU prior's
frozen ``theta`` / ``mu`` (``enc_hivt_nusargo_sde_sep2.py:405-406``) and
the temporal encoder's causal-mask buffer, which the port rebuilds
(``enc_hivt_nusargo_grid.py:233,250-254``).

A fused encoder (``encoder.fused: true``) holds the dense encoder's
parameters and packs them at call time, so it converts by the same rules.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from trajsde_tpu_torch.config import ALIASES

_SKIP_SUFFIXES = (
    "is_intersection_embed",
    "turn_direction_embed",
    "traffic_control_embed",
    "h_func.theta",
    "h_func.mu",
    "temporal_encoder.attn_mask",
)
_SKIP_EXACT = ("decoder.hidden",)

_IDENT = lambda w: w  # noqa: E731


def _squeeze1(w: torch.Tensor) -> torch.Tensor:
    return w[:, 0, :]


# each transform's inverse, for ``to_reference``
_INVERSE = {_IDENT: lambda w: w, _squeeze1: lambda w: w.unsqueeze(1)}


class RuleSet:
    """The port's ``state_dict`` key -> (reference key, tensor transform)."""

    def __init__(self) -> None:
        self.rules: Dict[str, Tuple[str, Callable[[torch.Tensor], torch.Tensor]]] = {}

    def param(self, key: str, tkey: str, fn: Callable = _IDENT) -> None:
        assert key not in self.rules, key
        self.rules[key] = (tkey, fn)

    def linear(self, key: str, tmod: str) -> None:
        self.param(f"{key}.weight", f"{tmod}.weight")
        self.param(f"{key}.bias", f"{tmod}.bias")

    def ln(self, key: str, tmod: str) -> None:
        self.param(f"{key}.weight", f"{tmod}.weight")
        self.param(f"{key}.bias", f"{tmod}.bias")


# shared blocks (``models/utils/embedding.py:22-70``, ``ode_utils.py:111-152``)
def _single_embed(m: RuleSet, fp: str, tp: str) -> None:
    for i, idx in enumerate((0, 3, 6)):
        m.linear(f"{fp}.Dense_{i}", f"{tp}.embed.{idx}")
        m.ln(f"{fp}.LayerNorm_{i}", f"{tp}.embed.{idx + 1}")


def _multi_embed(m: RuleSet, fp: str, tp: str, n_inputs: int = 2) -> None:
    for i in range(n_inputs):
        m.linear(f"{fp}.in{i}_dense0", f"{tp}.module_list.{i}.0")
        m.ln(f"{fp}.in{i}_ln0", f"{tp}.module_list.{i}.1")
        m.linear(f"{fp}.in{i}_dense1", f"{tp}.module_list.{i}.3")
    m.ln(f"{fp}.aggr_ln0", f"{tp}.aggr_embed.0")
    m.linear(f"{fp}.aggr_dense", f"{tp}.aggr_embed.2")
    m.ln(f"{fp}.aggr_ln1", f"{tp}.aggr_embed.3")


def _attn(m: RuleSet, fp: str, tp: str, pairs) -> None:
    for port_n, ref_n in pairs:
        m.linear(f"{fp}.attn.{port_n}", f"{tp}.{ref_n}")


_AA_ATTN = [(n, n) for n in
            ("lin_q", "lin_k", "lin_v", "lin_ih", "lin_hh", "lin_self", "out_proj")]
_GLOBAL_ATTN = [
    ("lin_q", "lin_q_node"), ("lin_k", "lin_k_node"), ("lin_v", "lin_v_node"),
    ("lin_k_edge", "lin_k_edge"), ("lin_v_edge", "lin_v_edge"),
    ("lin_ih", "lin_ih"), ("lin_hh", "lin_hh"), ("lin_self", "lin_self"),
    ("out_proj", "out_proj"),
]


def _mlp_block(m: RuleSet, fp: str, tp: str) -> None:
    m.linear(f"{fp}.mlp.Dense_0", f"{tp}.0")
    m.linear(f"{fp}.mlp.Dense_1", f"{tp}.3")


def _gru(m: RuleSet, fp: str, tp: str) -> None:
    for gate, seq in (("update_gate", "update_gate"), ("reset_gate", "reset_gate"),
                      ("new_state", "new_state_net")):
        m.linear(f"{fp}.{gate}_0", f"{tp}.{seq}.0")
        m.linear(f"{fp}.{gate}_1", f"{tp}.{seq}.2")


def _ffunc(m: RuleSet, fp: str, tp: str, num_layers: int = 2) -> None:
    # net = Linear(D+2, D) + num_layers x (Tanh, Linear): linears at even indices
    for i in range(num_layers + 1):
        m.linear(f"{fp}.dense{i}", f"{tp}.net.{2 * i}")


def _gfunc(m: RuleSet, fp: str, tp: str, num_layers: int = 2) -> None:
    for i in range(num_layers):
        m.linear(f"{fp}.dense{i}", f"{tp}.net.{2 * i}")
    m.linear(f"{fp}.dense_out", f"{tp}.net.{2 * num_layers}")


# encoders (``enc_hivt_nusargo_grid.py``, ``enc_hivt_nusargo_sde_sep2.py``)
def _aa_encoder(m: RuleSet, fp: str, tp: str) -> None:
    m.param(f"{fp}.bos_token", f"{tp}.bos_token")
    _single_embed(m, f"{fp}.center_embed", f"{tp}.center_embed")
    _multi_embed(m, f"{fp}.nbr_embed", f"{tp}.nbr_embed")
    _attn(m, fp, tp, _AA_ATTN)
    m.ln(f"{fp}.norm1", f"{tp}.norm1")
    m.ln(f"{fp}.norm2", f"{tp}.norm2")
    _mlp_block(m, fp, f"{tp}.mlp")


def _al_encoder(m: RuleSet, fp: str, tp: str) -> None:
    _multi_embed(m, f"{fp}.lane_embed", f"{tp}.lane_embed")
    _attn(m, fp, tp, _AA_ATTN)
    m.ln(f"{fp}.norm1", f"{tp}.norm1")
    m.ln(f"{fp}.norm2", f"{tp}.norm2")
    _mlp_block(m, fp, f"{tp}.mlp")


def _temporal_encoder(m: RuleSet, fp: str, tp: str, num_layers: int = 4) -> None:
    for name in ("padding_token", "cls_token", "pos_embed"):
        m.param(f"{fp}.{name}", f"{tp}.{name}", _squeeze1)
    for i in range(num_layers):
        lp, lt = f"{fp}.layer{i}", f"{tp}.transformer_encoder.layers.{i}"
        m.param(f"{lp}.self_attn.in_proj.weight", f"{lt}.self_attn.in_proj_weight")
        m.param(f"{lp}.self_attn.in_proj.bias", f"{lt}.self_attn.in_proj_bias")
        m.linear(f"{lp}.self_attn.out_proj", f"{lt}.self_attn.out_proj")
        m.ln(f"{lp}.norm1", f"{lt}.norm1")
        m.ln(f"{lp}.norm2", f"{lt}.norm2")
        m.linear(f"{lp}.mlp.Dense_0", f"{lt}.linear1")
        m.linear(f"{lp}.mlp.Dense_1", f"{lt}.linear2")
    m.ln(f"{fp}.norm", f"{tp}.transformer_encoder.norm")


def _local_encoder(m: RuleSet, fp: str, tp: str, num_temporal_layers: int) -> None:
    """Vanilla HiVT ``LocalEncoder`` (``enc_hivt_nusargo_grid.py:22-92``)."""
    _aa_encoder(m, f"{fp}.aa_encoder", f"{tp}.aa_encoder")
    _temporal_encoder(m, f"{fp}.temporal_encoder", f"{tp}.temporal_encoder",
                      num_temporal_layers)
    _al_encoder(m, f"{fp}.al_encoder", f"{tp}.al_encoder")


def _sde_encoder(m: RuleSet, fp: str, tp: str, sde_layers: int) -> None:
    """``LocalEncoderSDESepPara2`` (``enc_hivt_nusargo_sde_sep2.py:25-63``)."""
    _aa_encoder(m, f"{fp}.aa_encoder", f"{tp}.aa_encoder")
    _al_encoder(m, f"{fp}.al_encoder", f"{tp}.al_encoder")
    _gru(m, f"{fp}.sde_rnn.gru", f"{tp}.gru_unit")
    _ffunc(m, f"{fp}.sde_rnn.f_func", f"{tp}.lsde_func.f_func", sde_layers)
    _gfunc(m, f"{fp}.sde_rnn.g_nus", f"{tp}.lsde_func.g_nus", sde_layers)
    _gfunc(m, f"{fp}.sde_rnn.g_argo", f"{tp}.lsde_func.g_argo", sde_layers)
    m.param(f"{fp}.hidden", f"{tp}.hidden")


# aggregator and decoders (``agg_hivt.py``, ``dec_hivt_nusargo_{grid,sde}.py``)
def _aggregator(m: RuleSet, fp: str, tp: str, num_layers: int = 3) -> None:
    _multi_embed(m, f"{fp}.rel_embed", f"{tp}.rel_embed")
    for i in range(num_layers):
        lp, lt = f"{fp}.layer{i}", f"{tp}.global_interactor_layers.{i}"
        _attn(m, lp, lt, _GLOBAL_ATTN)
        m.ln(f"{lp}.norm1", f"{lt}.norm1")
        m.ln(f"{lp}.norm2", f"{lt}.norm2")
        _mlp_block(m, lp, f"{lt}.mlp")
    m.ln(f"{fp}.norm", f"{tp}.norm")
    m.linear(f"{fp}.multihead_proj", f"{tp}.multihead_proj")


def _mlp_decoder(m: RuleSet, fp: str, tp: str) -> None:
    """``MLPDecoder`` (``dec_hivt_nusargo_grid.py:10-64``)."""
    m.linear(f"{fp}.aggr_dense", f"{tp}.aggr_embed.0")
    m.ln(f"{fp}.aggr_ln", f"{tp}.aggr_embed.1")
    for pre, idxs in (("loc", (0, 3)), ("scale", (0, 3)), ("pi", (0, 3, 6))):
        for i, idx in enumerate(idxs):
            m.linear(f"{fp}.{pre}_dense{i}", f"{tp}.{pre}.{idx}")
            if i < len(idxs) - 1:  # a LayerNorm follows every linear but the head
                m.ln(f"{fp}.{pre}_ln{i}", f"{tp}.{pre}.{idx + 1}")


def _sde_decoder(m: RuleSet, fp: str, tp: str) -> None:
    """``SDEDecoder`` (``dec_hivt_nusargo_sde.py:14-105``); its FFunc / GFunc
    are the fixed-depth local copies (``:107-160``), not config-scaled."""
    m.linear(f"{fp}.aggr_dense", f"{tp}.aggr_embed.0")
    m.ln(f"{fp}.aggr_ln", f"{tp}.aggr_embed.1")
    _ffunc(m, f"{fp}.sde_rollout.f_func", f"{tp}.lsde_func.f_func", 2)
    _gfunc(m, f"{fp}.sde_rollout.g_func", f"{tp}.lsde_func.g_func", 2)
    for pre, seq in (("loc", "decoder"), ("scale", "scale"), ("pi", "pi")):
        m.linear(f"{fp}.{pre}_layers_0", f"{tp}.{seq}.0")
        m.ln(f"{fp}.{pre}_layers_1", f"{tp}.{seq}.1")
        m.linear(f"{fp}.{pre}_layers_2", f"{tp}.{seq}.3")


_ENCODERS = {
    "LocalEncoder": lambda m, kw: _local_encoder(
        m, "encoder", "encoder", int(kw.get("num_temporal_layers", 4))),
    "LocalEncoderSDESepPara2": lambda m, kw: _sde_encoder(
        m, "encoder", "encoder", int(kw.get("sde_layers", 2))),
}
_DECODERS = {
    "MLPDecoder": lambda m, kw: _mlp_decoder(m, "decoder", "decoder"),
    "SDEDecoder": lambda m, kw: _sde_decoder(m, "decoder", "decoder"),
}


def build_rules(cfg: Mapping[str, Any]) -> RuleSet:
    """The ``RuleSet`` of a config dict (the reference YAML schema).  A
    component written with its native name (``LocalEncoderSDESep``)
    resolves to the reference's rules (``LocalEncoderSDESepPara2``)."""
    canon = {native: ref for ref, native in ALIASES.items()}

    def component(section):
        sec = cfg[section]
        name = sec["module_name"]
        return canon.get(name, name), dict(sec.get("kwargs", {}))

    m = RuleSet()
    enc_name, enc_kw = component("encoder")
    agg_name, agg_kw = component("aggregator")
    dec_name, dec_kw = component("decoder")
    if enc_name not in _ENCODERS:
        raise ValueError(f"no conversion rules for encoder {enc_name!r}")
    _ENCODERS[enc_name](m, enc_kw)
    if agg_name != "GlobalInteractor":
        raise ValueError(f"no conversion rules for aggregator {agg_name!r}")
    _aggregator(m, "aggregator", "aggregator",
                int(agg_kw.get("num_global_layers", agg_kw.get("num_layers", 3))))
    if dec_name not in _DECODERS:
        raise ValueError(f"no conversion rules for decoder {dec_name!r}")
    _DECODERS[dec_name](m, dec_kw)
    return m


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def convert_state_dict(state_dict: Mapping[str, Any], cfg: Mapping[str, Any],
                       model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Map a reference ``state_dict`` (tensors or arrays) onto ``model``'s.

    Returns ``(state_dict, report)``: CPU tensors in the order and dtypes of
    ``model.state_dict()``, and ``report`` with the sorted ``skipped``
    (known-dead tensors present in the checkpoint) and ``unused``
    (unrecognised keys, e.g. torchmetrics buffers).  Raises ``KeyError`` on
    a model leaf without a rule or a tensor the checkpoint lacks, and
    ``ValueError`` on a shape mismatch: a partial conversion would be worse
    than none."""
    rules = build_rules(cfg).rules
    out: Dict[str, torch.Tensor] = {}
    used: set = set()
    for key, leaf in model.state_dict().items():
        if key not in rules:
            raise KeyError(f"parameter {key} has no conversion rule: the config does not "
                           "match the checkpoint's architecture")
        tkey, fn = rules[key]
        if tkey not in state_dict:
            raise KeyError(f"reference checkpoint is missing {tkey!r} (needed for {key})")
        value = fn(_tensor(state_dict[tkey]))
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {tkey} gives "
                             f"{tuple(value.shape)}, model expects {tuple(leaf.shape)}")
        used.add(tkey)
        out[key] = value.to(leaf.dtype).contiguous().clone()

    skipped: List[str] = []
    unused: List[str] = []
    for k in state_dict:
        if k in used:
            continue
        (skipped if k in _SKIP_EXACT or k.endswith(_SKIP_SUFFIXES) else unused).append(k)
    return out, {"skipped": sorted(skipped), "unused": sorted(unused)}


def to_reference(state_dict: Mapping[str, torch.Tensor],
                 cfg: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_state_dict`: the port's ``state_dict``
    under the reference's names and layouts (CPU tensors, the live
    tensors only), which ``convert_state_dict`` maps back bit for bit."""
    rules = build_rules(cfg).rules
    return {rules[k][0]: _INVERSE[rules[k][1]](v.detach().cpu()).contiguous().clone()
            for k, v in state_dict.items()}
