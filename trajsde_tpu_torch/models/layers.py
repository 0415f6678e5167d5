"""Shared attention / gating primitives (``trajsde_tpu/models/layers.py``).

Submodules carry the flax scope names of the JAX package (``lin_q``,
``Dense_0``, ``update_gate_0`` ...), so a ``state_dict`` key is the flax
parameter path with ``kernel``/``scale`` renamed to ``weight``
(:mod:`trajsde_tpu_torch.bridge`).  Dropout follows flax: active only in
``training`` mode, its keep mask drawn from the caller's
``torch.Generator``; in eval mode (the JAX modules' ``deterministic=True``)
it is the identity.

Mixed precision follows flax's ``dtype=``: a module built with
``dtype="bfloat16"`` keeps its parameters in f32 and computes in bf16.
:class:`Linear` casts its input, weight and bias to bf16 and rounds the
product before adding the bias, as ``nn.Dense`` does (``F.linear`` would
round once); :class:`LayerNorm` normalizes in f32 as flax does and rounds
only its output.  The casts are explicit, not ``torch.autocast``, which would
return LayerNorm in f32 and leave other elementwise ops in whatever dtype
they arrive in.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def compute_dtype(dtype) -> Optional[torch.dtype]:
    """A module's ``dtype`` argument as its compute dtype: None (f32, the
    plain path) for None / ``"float32"`` / ``torch.float32``, bf16 for
    ``"bfloat16"`` / ``torch.bfloat16``; anything else raises."""
    if dtype in (None, "float32", torch.float32):
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"dtype={dtype!r}: the port computes in float32 or bfloat16")


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s compute dtype: in bf16 the
    input, weight and bias are cast, the product is rounded to bf16 and the
    bias added in bf16 (two roundings, as flax's ``dot_general`` then
    ``y += bias``).  The ``state_dict`` keys are ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return F.linear(x, self.weight, self.bias)
        return torch.matmul(x.to(cd), self.weight.to(cd).t()) + self.bias.to(cd)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``nn.LayerNorm``'s compute dtype: the
    statistics and the normalization run in f32 with f32 scale and bias,
    and only the output is cast (flax's ``force_float32_reductions``).  In a
    reduced dtype the f32 steps are flax's own, the variance as E[x^2] -
    E[x]^2 and ``(x - mean) * (rsqrt(var + eps) * scale) + bias``:
    ``F.layer_norm``'s two-pass variance and folded affine land about one
    bf16 output in 1,500 on the other side of a rounding, and the attention
    after it spreads that ulp.  f32 keeps ``F.layer_norm``, within 1e-6 of
    flax's."""

    def __init__(self, features: int, dtype=None):
        super().__init__(features, eps=LN_EPS)
        self.compute_dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias).to(cd)


def weak(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX combines it with an array of ``dtype``: a
    weakly typed scalar takes the array's dtype, so in bf16 ``x / sqrt(8)``
    divides by 2.828125."""
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` in f32; in a reduced dtype flax's ``nn.sigmoid``
    as XLA evaluates it there, ``1 / (1 + exp(-x))`` rounded at each op."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax`` in f32; in a reduced dtype ``jax.nn.softmax``'s
    steps (``exp(x - max)`` over its sum), each rounded to the dtype."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to ``mask``; all-masked rows give
    exactly 0 (``torch.softmax`` over an all ``-inf`` row gives NaN)."""
    big_neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, torch.full_like(logits, big_neg))
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    s = e.sum(dim=dim, keepdim=True)
    return e / s.clamp_min(1e-16)


def layer_norm(features: int, dtype=None) -> LayerNorm:
    return LayerNorm(features, dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``.  ``F.dropout`` takes no
    generator, so the mask is drawn here."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / weak(1.0 - rate, x.dtype), torch.zeros_like(x))


class MlpBlock(nn.Module):
    """Linear(4D) -> ReLU -> Dropout -> Linear(D) -> Dropout."""

    def __init__(self, embed_dim: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.rate = dropout
        self.Dense_0 = Linear(embed_dim, embed_dim * 4, dtype)
        self.Dense_1 = Linear(embed_dim * 4, embed_dim, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(torch.relu(self.Dense_0(x)), self.rate, self.training, generator)
        return dropout(self.Dense_1(h), self.rate, self.training, generator)


class EdgeAttention(nn.Module):
    """Dense masked edge attention with HiVT's gated update.

    center [..., Nq, D], mask [..., Nq, Nk] bool, and either
    ``kv_pair [..., Nq, Nk, D]`` (pair mode) or ``kv_node [..., Nk, D]`` +
    ``kv_edge [..., Nq, Nk, D]`` (node+edge mode, whose keys/values are
    the sum of both projections).  Returns [..., Nq, D].  Dropout acts on
    the attention weights and on the output.
    """

    def __init__(self, embed_dim: int, num_heads: int, edge_stream: bool = False,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        D = embed_dim
        self.num_heads = num_heads
        self.rate = dropout
        names = ["lin_q", "lin_k", "lin_v", "lin_ih", "lin_hh", "lin_self", "out_proj"]
        if edge_stream:
            names += ["lin_k_edge", "lin_v_edge"]
        for n in names:
            self.add_module(n, Linear(D, D, dtype))

    def forward(
        self,
        center: torch.Tensor,
        mask: torch.Tensor,
        kv_pair: Optional[torch.Tensor] = None,
        kv_node: Optional[torch.Tensor] = None,
        kv_edge: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        D = center.shape[-1]
        H = self.num_heads
        hd = D // H
        q = self.lin_q(center)
        if kv_pair is not None:
            k = self.lin_k(kv_pair)
            v = self.lin_v(kv_pair)
        else:
            k = self.lin_k(kv_node).unsqueeze(-3) + self.lin_k_edge(kv_edge)
            v = self.lin_v(kv_node).unsqueeze(-3) + self.lin_v_edge(kv_edge)
        q = q.reshape(q.shape[:-1] + (H, hd))
        k = k.reshape(k.shape[:-1] + (H, hd))
        v = v.reshape(v.shape[:-1] + (H, hd))

        alpha = torch.einsum("...qhd,...qkhd->...qkh", q, k) / weak(hd ** 0.5, q.dtype)
        alpha = masked_softmax(alpha, mask.unsqueeze(-1), dim=-2)
        alpha = dropout(alpha, self.rate, self.training, generator)
        agg = torch.einsum("...qkh,...qkhd->...qhd", alpha, v)
        return self.update(center, agg.reshape(agg.shape[:-2] + (D,)), generator)

    def update(self, center: torch.Tensor, agg: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """HiVT's gated update of the aggregate, ``out_proj`` and the output
        dropout (shared with the fused AA path, whose kernel gives ``agg``)."""
        gate = sigmoid(self.lin_ih(agg) + self.lin_hh(center))
        out = agg + gate * (self.lin_self(center) - agg)
        return dropout(self.out_proj(out), self.rate, self.training, generator)


class MultiheadSelfAttention(nn.Module):
    """Plain multi-head self-attention over a sequence axis with an additive
    mask (the temporal transformer's).

    x [..., S, D], attn_mask [..., S, S] (added to the logits, the head
    axis inserted in front of its last two axes, so a batched mask cannot
    broadcast against the heads) -> [..., S, D].  ``in_proj`` is one
    [D, 3D] projection split into q, k, v; dropout acts on the attention
    weights.  Written in tensor ops, not ``scaled_dot_product_attention``,
    so the mask's ``finfo.min`` and the dropout draws are the JAX
    package's.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.rate = dropout
        self.in_proj = Linear(embed_dim, 3 * embed_dim, dtype)
        self.out_proj = Linear(embed_dim, embed_dim, dtype)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        D, H = x.shape[-1], self.num_heads
        hd = D // H
        q, k, v = (t.reshape(t.shape[:-1] + (H, hd)) for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) / weak(hd ** 0.5, q.dtype)
        logits = logits + attn_mask[..., None, :, :]
        w = dropout(softmax(logits, dim=-1), self.rate, self.training, generator)
        out = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out_proj(out.reshape(out.shape[:-2] + (D,)))


class GRUUnit(nn.Module):
    """Masked GRU cell fusing SDE state with per-step observations.

    Gates are Linear -> tanh -> Linear MLPs.  Update and reset read
    ``[h, x]`` and pass a sigmoid; the new state reads ``[x, reset * h]``
    and has no sigmoid.  Rows whose mask is False keep ``h``.
    """

    def __init__(self, latent_dim: int, n_units: int, dtype=None):
        super().__init__()
        din = 2 * latent_dim
        for gate in ("update_gate", "reset_gate", "new_state"):
            self.add_module(f"{gate}_0", Linear(din, n_units, dtype))
            self.add_module(f"{gate}_1", Linear(n_units, latent_dim, dtype))

    def _net(self, gate: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(getattr(self, f"{gate}_0")(x))
        return getattr(self, f"{gate}_1")(h)

    def forward(self, h_cur: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        concat = torch.cat([h_cur, x], dim=-1)
        update = sigmoid(self._net("update_gate", concat))
        reset = sigmoid(self._net("reset_gate", concat))
        new_state = self._net("new_state", torch.cat([x, reset * h_cur], dim=-1))
        h_next = (1.0 - update) * new_state + update * h_cur
        m = mask.unsqueeze(-1).to(h_cur.dtype)
        return m * h_next + (1.0 - m) * h_cur
