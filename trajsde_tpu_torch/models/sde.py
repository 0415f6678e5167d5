"""Latent-SDE drift/diffusion networks and fixed-grid step modules
(``trajsde_tpu/models/sde.py``).

* ``FFunc``: Linear(D+2 -> D) on ``[y, sin t, cos t]``, then
  ``num_layers`` x (tanh, Linear(D -> D)).
* ``GFunc``: Linear(D+2 -> D), (num_layers - 1) x (tanh, Linear), then
  tanh, Linear(D -> 1), sigmoid: one diffusion magnitude per row.
* ``SDEGRUStep``: one Euler-Maruyama segment with the diffusion net picked
  per row by the nuScenes mask, then the masked GRU fusion; with
  ``adaptive=True`` the segment is integrated by bounded step doubling
  (:func:`trajsde_tpu_torch.ops.sdeint.sdeint_adaptive`).
* ``SDEStep``: one plain Euler-Maruyama step (the decoder rollout).

The JAX package evaluates these MLPs horizontally packed; that is the
same math, so the port computes them one by one.  Brownian draws are
explicit unit normals (``eps``) supplied by the caller, or, in the adaptive
step, the node normals of the segment's Brownian tree (``nodes``).  With a bf16
``dtype`` the state is bf16, and ``dt`` and ``eps`` are cast to it, as in
the JAX steps: ``dt`` 0.1 becomes 0.10009765625.
"""
from __future__ import annotations

import torch
from torch import nn

from trajsde_tpu_torch.models.layers import GRUUnit, Linear, sigmoid
from trajsde_tpu_torch.ops.sdeint import sdeint_adaptive

# levels of the adaptive step's Brownian tree: 2**8 node normals a segment
ADAPTIVE_DEPTH = 8
NOISE_NEEDS_FIXED_GRID = ("explicit sde_noise requires the fixed-grid path (adaptive=False); "
                          "the adaptive branch draws from its own BrownianTree")


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

    ``forward(h, nus_mask, obs, obs_mask, t0, dt, eps=None, nodes=None)``
    returns ``(h_next, g)`` with ``g [...]`` the diffusion magnitude tap that
    the encoder gathers for the discrimination head.  The fixed grid takes
    one step with the unit normals ``eps`` and taps ``g`` at the segment's
    start.  ``adaptive=True`` integrates ``[t0, t0 + dt]`` by step doubling
    (``dt0 = dt / 2``, ``dt_min = dt / 64``, ``adaptive_max_steps``
    iterations, a depth-8 Brownian tree on the node normals ``nodes
    [256, *h.shape]``), the state in f32 inside the solver, and taps ``g``
    at the segment's end state.  ``dt`` is cast to the state's dtype first
    in both.
    """

    def __init__(self, embed_dim: int, sde_layers: int = 2, adaptive: bool = False,
                 dtype=None, rtol: float = 1e-3, atol: float = 1e-3,
                 adaptive_max_steps: int = 8):
        super().__init__()
        self.adaptive = adaptive
        self.rtol, self.atol = float(rtol), float(atol)
        self.adaptive_max_steps = adaptive_max_steps
        self.f_func = FFunc(embed_dim, sde_layers, dtype)
        self.g_nus = GFunc(embed_dim, sde_layers, dtype)
        self.g_argo = GFunc(embed_dim, sde_layers, dtype)
        self.gru = GRUUnit(embed_dim, embed_dim, dtype)

    def forward(self, h, nus_mask, obs, obs_mask, t0, dt, eps=None, nodes=None):
        dt = dt.to(h.dtype)
        mask = nus_mask.unsqueeze(-1)

        def g_fn(t, y):
            return torch.where(mask, self.g_nus(t, y), self.g_argo(t, y))

        if self.adaptive:
            if eps is not None:
                raise NotImplementedError(NOISE_NEEDS_FIXED_GRID)
            ts = torch.stack([t0.float(), (t0 + dt).float()])
            ys, _ = sdeint_adaptive(self.f_func, g_fn, h, ts, dt0=dt / 2.0, rtol=self.rtol,
                                    atol=self.atol, dt_min=dt / 64.0,
                                    max_steps=self.adaptive_max_steps, depth=ADAPTIVE_DEPTH,
                                    nodes=nodes)
            y1 = ys[-1].to(h.dtype)
            g = g_fn(t0 + dt, y1)
        else:
            eps = eps.to(h.dtype)
            f = self.f_func(t0, h)
            g = g_fn(t0, h)
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
    # filled on the device (no copy from host memory, which a CUDA graph
    # cannot capture)
    t0s = torch.cat([pts.new_full((1,), -0.01), pts[:-1]])
    t1s = torch.cat([pts.new_zeros(1), pts[1:]])
    return t0s, t1s - t0s


def decoder_time_grid(future_steps: int, max_fut_t: float, device=None):
    """(t0s, dts) of the future rollout over ``linspace(0, max_fut_t, Tf+1)``."""
    ts = torch.linspace(0.0, max_fut_t, future_steps + 1, device=device)
    return ts[:-1], ts[1:] - ts[:-1]
