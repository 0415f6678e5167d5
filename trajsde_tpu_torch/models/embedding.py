"""Input embedding stacks (``trajsde_tpu/models/embedding.py``).

``nn.LayerNorm`` computes the variance in two passes where flax's
LayerNorm uses E[x^2] - E[x]^2; the two agree to ~1e-6 in f32.  ``dtype``
is the compute dtype of every Linear and LayerNorm
(:mod:`trajsde_tpu_torch.models.layers`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from trajsde_tpu_torch.models.layers import Linear, layer_norm


class SingleInputEmbedding(nn.Module):
    """3 x (Linear -> LN), ReLU between them."""

    def __init__(self, in_channel: int, out_channel: int, dtype=None):
        super().__init__()
        dims = [in_channel, out_channel, out_channel]
        for i in range(3):
            self.add_module(f"Dense_{i}", Linear(dims[i], out_channel, dtype))
            self.add_module(f"LayerNorm_{i}", layer_norm(out_channel, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            if i:
                x = torch.relu(x)
            x = getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x))
        return x


class MultipleInputEmbedding(nn.Module):
    """Per-input Linear -> LN -> ReLU -> Linear, summed, then
    LN -> ReLU -> Linear -> LN."""

    def __init__(self, in_channels: Sequence[int], out_channel: int, dtype=None):
        super().__init__()
        D = out_channel
        self.n_inputs = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"in{i}_dense0", Linear(c, D, dtype))
            self.add_module(f"in{i}_ln0", layer_norm(D, dtype))
            self.add_module(f"in{i}_dense1", Linear(D, D, dtype))
        self.aggr_ln0 = layer_norm(D, dtype)
        self.aggr_dense = Linear(D, D, dtype)
        self.aggr_ln1 = layer_norm(D, dtype)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = None
        for i, x in enumerate(inputs):
            h = torch.relu(getattr(self, f"in{i}_ln0")(getattr(self, f"in{i}_dense0")(x)))
            h = getattr(self, f"in{i}_dense1")(h)
            out = h if out is None else out + h
        out = torch.relu(self.aggr_ln0(out))
        return self.aggr_ln1(self.aggr_dense(out))
