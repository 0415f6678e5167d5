"""Global interaction aggregator (``trajsde_tpu/models/aggregator.py``).

``dtype`` is the compute dtype of every Linear and LayerNorm (flax's mixed
precision); the local embeddings are cast to it on the way in and the
output is f32."""
from __future__ import annotations

import torch
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.models.embedding import MultipleInputEmbedding, SingleInputEmbedding
from trajsde_tpu_torch.models.layers import (EdgeAttention, Linear, MlpBlock, compute_dtype,
                                             layer_norm)


class GlobalInteractorLayer(nn.Module):
    """Edge-aware attention layer: keys/values are the projected NORMED
    node stream plus the projected edge stream."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.attn = EdgeAttention(embed_dim, num_heads, edge_stream=True, dropout=dropout,
                                  dtype=dtype)
        self.norm1 = layer_norm(embed_dim, dtype)
        self.mlp = MlpBlock(embed_dim, dropout, dtype)
        self.norm2 = layer_norm(embed_dim, dtype)

    def forward(self, x, mask, rel_embed, generator=None):
        normed = self.norm1(x)
        x = x + self.attn(normed, mask, kv_node=normed, kv_edge=rel_embed, generator=generator)
        return x + self.mlp(self.norm2(x), generator)


class GlobalInteractor(nn.Module):
    """``forward(scene, local_embed [B, A, D], generator=None)`` ->
    ``[B, F, A, D]``, F = ``num_modes``."""

    def __init__(self, historical_steps: int, embed_dim: int, num_modes: int,
                 num_heads: int = 8, num_layers: int = 3, dropout: float = 0.1,
                 rotate: bool = True, edge_dim: int = 2, dtype=None):
        super().__init__()
        D = embed_dim
        self.compute_dtype = compute_dtype(dtype)
        self.historical_steps = historical_steps
        self.num_modes = num_modes
        self.num_layers = num_layers
        self.rotate = rotate
        self.rel_embed = (MultipleInputEmbedding([edge_dim, 2], D, dtype) if rotate
                          else SingleInputEmbedding(edge_dim, D, dtype))
        for i in range(num_layers):
            self.add_module(f"layer{i}", GlobalInteractorLayer(D, num_heads, dropout, dtype))
        self.norm = layer_norm(D, dtype)
        self.multihead_proj = Linear(D, num_modes * D, dtype)

    def forward(self, scene: SceneBatch, local_embed: torch.Tensor,
                generator=None) -> torch.Tensor:
        mask, rel_pos, rel_theta = graph.global_edges(scene, self.historical_steps - 1)
        if self.rotate:
            rel_pos_local = torch.einsum("bakj,baji->baki", rel_pos, scene.rotate_mat())
            theta_feat = torch.stack([torch.cos(rel_theta), torch.sin(rel_theta)], dim=-1)
            rel_embed = self.rel_embed([rel_pos_local, theta_feat])
        else:
            rel_embed = self.rel_embed(rel_pos)
        x = local_embed.to(self.compute_dtype or local_embed.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask, rel_embed, generator)
        x = self.multihead_proj(self.norm(x))
        B, A = x.shape[0], x.shape[1]
        return x.reshape(B, A, self.num_modes, -1).permute(0, 2, 1, 3).float()
