"""Latent-SDE drift/diffusion networks and fixed-grid step modules
(``trajsde_tpu/models/sde.py``).

* ``FFunc``: Linear(D+2 -> D) on ``[y, sin t, cos t]``, then
  ``num_layers`` x (tanh, Linear(D -> D)).
* ``GFunc``: Linear(D+2 -> D), (num_layers - 1) x (tanh, Linear), then
  tanh, Linear(D -> 1), sigmoid: one diffusion magnitude per row.
* ``SDEGRUStep``: one Euler-Maruyama segment with the diffusion net picked
  per row by the nuScenes mask, then the masked GRU fusion.
* ``SDEStep``: one plain Euler-Maruyama step (the decoder rollout).

The JAX package evaluates these MLPs horizontally packed; that is the
same math, so the port computes them one by one.  Brownian draws are
explicit unit normals (``eps``) supplied by the caller.  With a bf16
``dtype`` the state is bf16, and ``dt`` and ``eps`` are cast to it, as in
the JAX steps: ``dt`` 0.1 becomes 0.10009765625.
"""
from __future__ import annotations

import torch
from torch import nn

from trajsde_tpu_torch.models.layers import GRUUnit, Linear, sigmoid


def time_feats(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[y, sin t, cos t]`` with the scalar ``t`` broadcast per row."""
    shape = y.shape[:-1] + (1,)
    ts = torch.sin(t).to(y.dtype).expand(shape)
    tc = torch.cos(t).to(y.dtype).expand(shape)
    return torch.cat([y, ts, tc], dim=-1)


class FFunc(nn.Module):
    """Posterior drift MLP."""

    def __init__(self, embed_dim: int, num_layers: int = 2, dtype=None):
        super().__init__()
        D = embed_dim
        self.num_layers = num_layers
        self.dense0 = Linear(D + 2, D, dtype)
        for i in range(num_layers):
            self.add_module(f"dense{i + 1}", Linear(D, D, dtype))

    def forward(self, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.dense0(time_feats(t, y))
        for i in range(self.num_layers):
            h = getattr(self, f"dense{i + 1}")(torch.tanh(h))
        return h


class GFunc(nn.Module):
    """Diffusion magnitude MLP -> scalar sigmoid, [..., 1]."""

    def __init__(self, embed_dim: int, num_layers: int = 2, dtype=None):
        super().__init__()
        D = embed_dim
        self.num_layers = num_layers
        self.dense0 = Linear(D + 2, D, dtype)
        for i in range(num_layers - 1):
            self.add_module(f"dense{i + 1}", Linear(D, D, dtype))
        self.dense_out = Linear(D, 1, dtype)

    def forward(self, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.dense0(time_feats(t, y))
        for i in range(self.num_layers - 1):
            h = getattr(self, f"dense{i + 1}")(torch.tanh(h))
        return sigmoid(self.dense_out(torch.tanh(h)))


class SDEGRUStep(nn.Module):
    """One ODE-RNN step: Euler-Maruyama segment + masked GRU fusion.

    ``forward(h, nus_mask, obs, obs_mask, t0, dt, eps)`` returns
    ``(h_next, g)`` with ``g [...]`` the diffusion magnitude tap that the
    encoder gathers for the discrimination head.
    """

    def __init__(self, embed_dim: int, sde_layers: int = 2, adaptive: bool = False,
                 dtype=None):
        super().__init__()
        if adaptive:
            raise NotImplementedError(
                "adaptive=True (step-doubling SDE integration) is not ported "
                "yet; the fixed-grid Euler path is the shipped configuration"
            )
        self.f_func = FFunc(embed_dim, sde_layers, dtype)
        self.g_nus = GFunc(embed_dim, sde_layers, dtype)
        self.g_argo = GFunc(embed_dim, sde_layers, dtype)
        self.gru = GRUUnit(embed_dim, embed_dim, dtype)

    def forward(self, h, nus_mask, obs, obs_mask, t0, dt, eps):
        dt, eps = dt.to(h.dtype), eps.to(h.dtype)
        f = self.f_func(t0, h)
        g = torch.where(nus_mask.unsqueeze(-1), self.g_nus(t0, h), self.g_argo(t0, h))
        y1 = h + f * dt + g * (torch.sqrt(dt) * eps)
        return self.gru(y1, obs, obs_mask), g[..., 0]


class SDEStep(nn.Module):
    """One plain Euler-Maruyama step: ``y + f dt + g sqrt(dt) eps``."""

    def __init__(self, embed_dim: int, sde_layers: int = 2, dtype=None):
        super().__init__()
        self.f_func = FFunc(embed_dim, sde_layers, dtype)
        self.g_func = GFunc(embed_dim, sde_layers, dtype)

    def forward(self, y, t0, dt, eps):
        dt, eps = dt.to(y.dtype), eps.to(y.dtype)
        f = self.f_func(t0, y)
        g = self.g_func(t0, y)
        return y + f * dt + g * (torch.sqrt(dt) * eps)


def encoder_time_grid(historical_steps: int, max_past_t: float, device=None):
    """(t0s, dts) of the backwards ODE-RNN in iteration order: the first
    segment is [-0.01, 0] (dt = 0.01) at the newest step, then one segment
    per remaining historical step."""
    pts = -torch.linspace(-max_past_t, 0.0, historical_steps, device=device).flip(0)
    t0s = torch.cat([torch.tensor([-0.01], device=device), pts[:-1]])
    t1s = torch.cat([torch.tensor([0.0], device=device), pts[1:]])
    return t0s, t1s - t0s


def decoder_time_grid(future_steps: int, max_fut_t: float, device=None):
    """(t0s, dts) of the future rollout over ``linspace(0, max_fut_t, Tf+1)``."""
    ts = torch.linspace(0.0, max_fut_t, future_steps + 1, device=device)
    return ts[:-1], ts[1:] - ts[:-1]
