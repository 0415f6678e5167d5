"""Agent-agent and agent-lane attention encoders
(``trajsde_tpu/models/local_encoder.py``).

Time is another batch axis of one dense masked attention, as in the JAX
package.  The query and key sets may differ (Aq = A + 1 in the SDE
encoder, whose focal-agent twin is a query row only).  ``fused=True``
runs the AA block's pair chain through kernel K3, and its gradient through
kernel K4 (:mod:`trajsde_tpu_torch.ops.aa_fused`), with the same parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from trajsde_tpu_torch.models.embedding import MultipleInputEmbedding, SingleInputEmbedding
from trajsde_tpu_torch.models.layers import EdgeAttention, MlpBlock, layer_norm
from trajsde_tpu_torch.ops.aa_fused import fused_aa_aggregate, pack_aa_params


class AAEncoder(nn.Module):
    """Per-step agent-agent attention.

    x_q [B, Th, Aq, 2], x_k [B, Th, Ak, 2], rot_q [B, Aq, 2, 2],
    bos_q [B, Aq, Th], mask [B, Th, Aq, Ak], edge_vec [B, Th, Aq, Ak, 2]
    -> [B, Th, Aq, D].

    ``fused=True`` keeps the parameter tree of the dense path (the
    ``nbr_embed`` / ``attn`` / ``norm1`` submodules), so weights and
    checkpoints serve both paths.
    """

    def __init__(self, historical_steps: int, embed_dim: int, num_heads: int,
                 node_dim: int = 2, edge_dim: int = 2, dropout: float = 0.0,
                 fused: bool = False, neighbor_cap: int = 0):
        super().__init__()
        if fused and neighbor_cap:
            raise NotImplementedError("neighbor_cap applies to the dense pair chain (fused=False)")
        if neighbor_cap:
            raise NotImplementedError(
                "neighbor_cap > 0 (the neighbour-capped AA gather) is not ported yet"
            )
        D = embed_dim
        self.fused = fused
        self.bos_token = nn.Parameter(torch.zeros(historical_steps, D))
        self.center_embed = SingleInputEmbedding(node_dim, D)
        self.nbr_embed = MultipleInputEmbedding([node_dim, edge_dim], D)
        self.attn = EdgeAttention(D, num_heads, dropout=dropout)
        self.norm1 = layer_norm(D)
        self.mlp = MlpBlock(D, dropout)
        self.norm2 = layer_norm(D)

    def forward(self, x_q, x_k, rot_q, bos_q, mask, edge_vec, generator=None):
        # centre embedding in each receiver's own frame, bos token substituted
        x_q_local = torch.einsum("btaj,baji->btai", x_q, rot_q)
        center = self.center_embed(x_q_local)
        center = torch.where(
            bos_q.permute(0, 2, 1).unsqueeze(-1),
            self.bos_token[None, :, None, :].to(center.dtype),
            center,
        )
        if self.fused:
            center = center + self._fused_block(center, x_k, rot_q, mask, edge_vec, generator)
        else:
            # per-pair neighbour embedding rotated into the RECEIVER frame
            x_k_local = torch.einsum("btkj,bqji->btqki", x_k, rot_q)
            edge_local = torch.einsum("btqkj,bqji->btqki", edge_vec, rot_q)
            nbr = self.nbr_embed([x_k_local, edge_local])
            center = center + self.attn(self.norm1(center), mask, kv_pair=nbr,
                                        generator=generator)
        return center + self.mlp(self.norm2(center), generator)

    def _fused_block(self, center, x_k, rot_q, mask, edge_vec, generator):
        """EdgeAttention with its pair stage (neighbour embedding -> k/v ->
        masked softmax -> aggregate) in kernel K3 (backward K4); the q
        projection, the gated update and ``out_proj`` stay node-wise."""
        attn = self.attn
        normed = self.norm1(center)
        q = attn.lin_q(normed)
        keep = None
        if self.training and attn.rate > 0.0:
            keep = (torch.rand(mask.shape + (attn.num_heads,), generator=generator,
                               device=mask.device) >= attn.rate).to(torch.float32)
        # packed in the graph, so the op's weight gradients (K4 on CUDA, the
        # plain backward on the CPU) reach every Linear and LayerNorm
        agg = fused_aa_aggregate(q, x_k, edge_vec, rot_q, mask,
                                 pack_aa_params(self, detach=False), attn.num_heads,
                                 keep=keep, dropout_rate=attn.rate)
        return attn.update(normed, agg, generator)


class ALEncoder(nn.Module):
    """Lane -> actor cross attention.

    x_actor [B, A, D], lane_feat [B, L, 2], al_vec [B, A, L, 2],
    mask [B, A, L], rot [B, A, 2, 2] -> [B, A, D].
    """

    def __init__(self, embed_dim: int, num_heads: int, node_dim: int = 2, edge_dim: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        D = embed_dim
        self.lane_embed = MultipleInputEmbedding([node_dim, edge_dim], D)
        self.attn = EdgeAttention(D, num_heads, dropout=dropout)
        self.norm1 = layer_norm(D)
        self.mlp = MlpBlock(D, dropout)
        self.norm2 = layer_norm(D)

    def forward(self, x_actor, lane_feat, al_vec, mask, rot, generator=None):
        lane_local = torch.einsum("blj,baji->bali", lane_feat, rot)
        vec_local = torch.einsum("balj,baji->bali", al_vec, rot)
        lane_embed = self.lane_embed([lane_local, vec_local])
        x_actor = x_actor + self.attn(self.norm1(x_actor), mask, kv_pair=lane_embed,
                                      generator=generator)
        return x_actor + self.mlp(self.norm2(x_actor), generator)
