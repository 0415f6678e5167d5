"""Agent-agent and agent-lane attention encoders, the temporal
transformer and the baseline's ``LocalEncoder``
(``trajsde_tpu/models/local_encoder.py``).

Time is another batch axis of one dense masked attention, as in the JAX
package.  The query and key sets may differ (Aq = A + 1 in the SDE
encoder, whose focal-agent twin is a query row only).  ``fused=True``
runs the AA block's pair chain through kernel K3, and its gradient through
kernel K4 (:mod:`trajsde_tpu_torch.ops.aa_fused`), with the same parameters;
in bf16 through K3b and K4b, the chain in bf16 as the JAX package runs it.
``neighbor_cap=K`` gathers each receiver's K nearest in-radius senders
before the dense pair chain, as the JAX package does.  ``dtype`` is the
compute dtype of every Linear and LayerNorm (flax's mixed precision,
:mod:`trajsde_tpu_torch.models.layers`); geometry (rotations, edge
vectors, the cap's distances) stays f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.models.embedding import MultipleInputEmbedding, SingleInputEmbedding
from trajsde_tpu_torch.models.layers import (EdgeAttention, MlpBlock, MultiheadSelfAttention,
                                             compute_dtype, dropout, layer_norm)
from trajsde_tpu_torch.models.remat import call_block
from trajsde_tpu_torch.ops.aa_fused import fused_aa_aggregate, pack_aa_params


class AAEncoder(nn.Module):
    """Per-step agent-agent attention.

    x_q [B, Th, Aq, 2], x_k [B, Th, Ak, 2], rot_q [B, Aq, 2, 2],
    bos_q [B, Aq, Th], mask [B, Th, Aq, Ak], edge_vec [B, Th, Aq, Ak, 2]
    -> [B, Th, Aq, D].

    ``fused=True`` keeps the parameter tree of the dense path (the
    ``nbr_embed`` / ``attn`` / ``norm1`` submodules), so weights and
    checkpoints serve both paths.  Under a bf16 ``dtype`` the fused pair
    chain computes in bf16 (kernels K3b / K4b on the card) and ``ln_mm``
    (the JAX module's default, True) takes its LayerNorm statistics from
    bf16-rounded inputs, as JAX's ``_ln_mm``; in f32 ``ln_mm`` changes
    nothing.  ``input_diff=False`` keeps the centre embedding where
    ``bos_q`` is set instead of substituting the bos token.

    ``0 < neighbor_cap < Ak`` (dense path only) gathers each receiver's
    ``neighbor_cap`` nearest in-radius senders into [B, Th, Aq, K] before
    the pair chain: exact while no receiver has more in-radius senders
    than the cap, else the farthest extras drop.  Of equally far senders
    the lower index is kept, as ``lax.top_k`` keeps it.  Each capped
    forward sets ``aa_overflow_edges``, the dropped edges as a 0-dim
    tensor on the device (JAX sows it to ``diagnostics``); an uncapped
    forward leaves it None.  Nothing reads it on the host unless the
    caller does.  After a chain of the chained train step
    (``train.loop.ChainedStep``) it is None: JAX's train step does not log
    it, and a count written under a CUDA graph would lie in its memory pool.
    """

    def __init__(self, historical_steps: int, embed_dim: int, num_heads: int,
                 node_dim: int = 2, edge_dim: int = 2, dropout: float = 0.0,
                 fused: bool = False, neighbor_cap: int = 0, input_diff: bool = True,
                 dtype=None, ln_mm: bool = True):
        super().__init__()
        if fused and neighbor_cap:
            raise NotImplementedError("neighbor_cap applies to the dense pair chain (fused=False)")
        D = embed_dim
        self.fused = fused
        self.ln_mm = bool(ln_mm)
        self.chain_dtype = "bfloat16" if compute_dtype(dtype) is torch.bfloat16 else "float32"
        self.neighbor_cap = int(neighbor_cap)
        self.aa_overflow_edges: Optional[torch.Tensor] = None
        self.input_diff = input_diff
        self.bos_token = nn.Parameter(torch.zeros(historical_steps, D))
        self.center_embed = SingleInputEmbedding(node_dim, D, dtype)
        self.nbr_embed = MultipleInputEmbedding([node_dim, edge_dim], D, dtype)
        self.attn = EdgeAttention(D, num_heads, dropout=dropout, dtype=dtype)
        self.norm1 = layer_norm(D, dtype)
        self.mlp = MlpBlock(D, dropout, dtype)
        self.norm2 = layer_norm(D, dtype)

    def forward(self, x_q, x_k, rot_q, bos_q, mask, edge_vec, generator=None):
        # centre embedding in each receiver's own frame, bos token substituted
        x_q_local = torch.einsum("btaj,baji->btai", x_q, rot_q)
        center = self.center_embed(x_q_local)
        if self.input_diff:
            center = torch.where(
                bos_q.permute(0, 2, 1).unsqueeze(-1),
                self.bos_token[None, :, None, :].to(center.dtype),
                center,
            )
        self.aa_overflow_edges = None
        if self.fused:
            center = center + self._fused_block(center, x_k, rot_q, mask, edge_vec, generator)
        else:
            if 0 < self.neighbor_cap < mask.shape[-1]:
                x_k_per_q, mask, edge_vec = self._nearest(x_k, mask, edge_vec)
                x_k_local = torch.einsum("btqkj,bqji->btqki", x_k_per_q, rot_q)
            else:
                x_k_local = torch.einsum("btkj,bqji->btqki", x_k, rot_q)
            # per-pair neighbour embedding rotated into the RECEIVER frame
            edge_local = torch.einsum("btqkj,bqji->btqki", edge_vec, rot_q)
            nbr = self.nbr_embed([x_k_local, edge_local])
            center = center + self.attn(self.norm1(center), mask, kv_pair=nbr,
                                        generator=generator)
        return center + self.mlp(self.norm2(center), generator)

    def _nearest(self, x_k, mask, edge_vec):
        """Each receiver's ``neighbor_cap`` nearest in-radius senders:
        (x_k [B, Th, Aq, K, 2], mask [B, Th, Aq, K], edge_vec
        [B, Th, Aq, K, 2]); sets ``aa_overflow_edges``.  A stable
        descending sort keeps the lower index among equal scores, which is
        ``lax.top_k``'s order (``torch.topk`` promises none)."""
        K = self.neighbor_cap
        d2 = (edge_vec * edge_vec).sum(-1)
        score = torch.where(mask, -d2, torch.full_like(d2, -torch.inf))
        idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :K]
        self.aa_overflow_edges = (mask.sum(-1) - K).clamp_min(0).sum()
        pair = idx[..., None].expand(idx.shape + (2,))
        B, Th, Aq = mask.shape[:3]
        x_k_per_q = torch.gather(x_k[:, :, None].expand(B, Th, Aq, -1, 2), 3, pair)
        return x_k_per_q, torch.gather(mask, 3, idx), torch.gather(edge_vec, 3, pair)

    def _fused_block(self, center, x_k, rot_q, mask, edge_vec, generator):
        """EdgeAttention with its pair stage (neighbour embedding -> k/v ->
        masked softmax -> aggregate) in kernel K3 (backward K4; K3b / K4b in
        bf16); the q projection, the gated update and ``out_proj`` stay
        node-wise.  As JAX's ``_fused_block``: q is the f32 product of the
        normed centre (in either dtype), and the f32 aggregate is cast to
        the compute dtype for the gated update and ``out_proj``."""
        attn = self.attn
        normed = self.norm1(center)
        q = F.linear(normed.float(), attn.lin_q.weight, attn.lin_q.bias)
        keep = None
        if self.training and attn.rate > 0.0:
            keep = (torch.rand(mask.shape + (attn.num_heads,), generator=generator,
                               device=mask.device) >= attn.rate).to(torch.float32)
        # packed in the graph, so the op's weight gradients (K4 on CUDA, the
        # plain backward on the CPU) reach every Linear and LayerNorm
        agg = fused_aa_aggregate(q, x_k, edge_vec, rot_q, mask,
                                 pack_aa_params(self, detach=False), attn.num_heads,
                                 keep=keep, dropout_rate=attn.rate,
                                 compute_dtype=self.chain_dtype, ln_mm=self.ln_mm)
        return attn.update(normed, agg.to(normed.dtype), generator)


class ALEncoder(nn.Module):
    """Lane -> actor cross attention.

    x_actor [B, A, D], lane_feat [B, L, 2], al_vec [B, A, L, 2],
    mask [B, A, L], rot [B, A, 2, 2] -> [B, A, D].
    """

    def __init__(self, embed_dim: int, num_heads: int, node_dim: int = 2, edge_dim: int = 2,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        D = embed_dim
        self.lane_embed = MultipleInputEmbedding([node_dim, edge_dim], D, dtype)
        self.attn = EdgeAttention(D, num_heads, dropout=dropout, dtype=dtype)
        self.norm1 = layer_norm(D, dtype)
        self.mlp = MlpBlock(D, dropout, dtype)
        self.norm2 = layer_norm(D, dtype)

    def forward(self, x_actor, lane_feat, al_vec, mask, rot, generator=None):
        lane_local = torch.einsum("blj,baji->bali", lane_feat, rot)
        vec_local = torch.einsum("balj,baji->bali", al_vec, rot)
        lane_embed = self.lane_embed([lane_local, vec_local])
        x_actor = x_actor + self.attn(self.norm1(x_actor), mask, kv_pair=lane_embed,
                                      generator=generator)
        return x_actor + self.mlp(self.norm2(x_actor), generator)


class TemporalEncoderLayer(nn.Module):
    """Pre-LN transformer layer: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.rate = dropout
        self.norm1 = layer_norm(embed_dim, dtype)
        self.self_attn = MultiheadSelfAttention(embed_dim, num_heads, dropout, dtype)
        self.norm2 = layer_norm(embed_dim, dtype)
        self.mlp = MlpBlock(embed_dim, dropout, dtype)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.self_attn(self.norm1(x), attn_mask, generator)
        x = x + dropout(h, self.rate, self.training, generator)
        return x + self.mlp(self.norm2(x), generator)


class TemporalEncoder(nn.Module):
    """Causal temporal transformer with a cls token.

    x [B, A, Th, D], padding_mask [B, A, Th] -> the cls output [B, A, D]:
    padded steps take ``padding_token``, the cls token is appended last (so
    under the causal mask it sees every step), ``pos_embed [Th + 1, D]`` is
    added, then the layers and a final LayerNorm."""

    def __init__(self, historical_steps: int, embed_dim: int, num_heads: int,
                 num_layers: int = 4, dropout: float = 0.0, dtype=None):
        super().__init__()
        T, D = historical_steps, embed_dim
        self.padding_token = nn.Parameter(torch.zeros(T, D))
        self.cls_token = nn.Parameter(torch.zeros(1, D))
        self.pos_embed = nn.Parameter(torch.zeros(T + 1, D))
        for i in range(num_layers):
            self.add_module(f"layer{i}", TemporalEncoderLayer(D, num_heads, dropout, dtype))
        self.num_layers = num_layers
        self.norm = layer_norm(D, dtype)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        D = x.shape[-1]
        x = torch.where(padding_mask[..., None], self.padding_token.to(x.dtype), x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[:2] + (1, D))
        x = torch.cat([x, cls], dim=2) + self.pos_embed.to(x.dtype)
        # causal: position q attends to k <= q
        idx = torch.arange(x.shape[2], device=x.device)
        attn_mask = torch.where(idx[None, :] <= idx[:, None], 0.0,
                                torch.finfo(x.dtype).min).to(x.dtype)[None]
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, attn_mask, generator)
        return self.norm(x)[:, :, -1, :]


class LocalEncoder(nn.Module):
    """The baseline's local encoder: AA attention per step (dense, or with
    ``fused=True`` through kernels K3 and K4, at 4 heads on the card), the
    temporal transformer over each actor's steps, then lane -> actor
    attention.  ``forward(scene)`` -> local_embed [B, A, D].

    Of the JAX module's knobs, ``rows_fwd`` / ``rows_bwd`` (TPU tiling) and
    ``parallel`` (which means nothing there either) are dropped by
    ``config.build``; ``ln_mm`` reaches the fused :class:`AAEncoder`, where
    it changes the bf16 chain's LayerNorm statistics.  ``neighbor_cap`` caps
    the dense AA block (:class:`AAEncoder`).
    ``remat=True`` rematerializes the AA and AL blocks in a training
    backward (:func:`~trajsde_tpu_torch.models.remat.call_block`), as JAX's
    ``nn.remat`` of both; the parameter names stay.  The output is f32 in
    either dtype."""

    def __init__(self, historical_steps: int, embed_dim: int, num_heads: int = 4,
                 dropout: float = 0.1, num_temporal_layers: int = 4,
                 local_radius: float = 50.0, input_diff: bool = True, node_dim: int = 2,
                 edge_dim: int = 2, remat: bool = False, dtype=None, fused: bool = False,
                 neighbor_cap: int = 0, ln_mm: bool = True):
        super().__init__()
        self.remat = remat
        self.compute_dtype = compute_dtype(dtype)
        self.historical_steps = historical_steps
        self.local_radius = float(local_radius)
        self.aa_encoder = AAEncoder(historical_steps, embed_dim, num_heads, node_dim, edge_dim,
                                    dropout, fused=fused, neighbor_cap=neighbor_cap,
                                    input_diff=input_diff, dtype=dtype, ln_mm=ln_mm)
        self.temporal_encoder = TemporalEncoder(historical_steps, embed_dim, num_heads,
                                                num_temporal_layers, dropout, dtype)
        self.al_encoder = ALEncoder(embed_dim, num_heads, node_dim, edge_dim, dropout, dtype)

    def forward(self, scene: SceneBatch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        Th = self.historical_steps
        rot = scene.rotate_mat()
        x_t = scene.x.permute(0, 2, 1, 3)                      # [B, Th, A, 2]
        aa_out = call_block(self.aa_encoder, x_t, x_t, rot, scene.bos_mask,
                            graph.aa_masks(scene, self.local_radius),
                            graph.aa_edge_vectors(scene), generator=generator, remat=self.remat)
        out = self.temporal_encoder(aa_out.permute(0, 2, 1, 3),
                                    scene.padding_mask[:, :, :Th], generator)
        al_mask, al_vec = graph.al_edges(scene, Th - 1, self.local_radius)
        out = call_block(self.al_encoder, out, graph.lane_features(scene), al_vec, al_mask, rot,
                         generator=generator, remat=self.remat)
        return out.float()
