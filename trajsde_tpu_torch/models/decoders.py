"""Trajectory decoders: the baseline's one-shot MLP and the latent-SDE
rollout (``trajsde_tpu/models/decoders.py``).

Layouts: ``local_embed [B, A, D]``, ``global_embed [B, F, A, D]``;
outputs ``loc [B, F, A, Tf, 4]`` (location + scale), ``pi [B, A, F]``,
``reg_mask [B, A, Tf]``.  ``fuse`` and ``decode`` are separate so the
serving path can run the rollout between them through the CUDA kernel
(:mod:`trajsde_tpu_torch.serving`).  ``forward`` rolls out with a loop of
``SDEStep`` (``fused=False``, autograd through the loop) or, with
``fused=True``, through :class:`~trajsde_tpu_torch.ops.sde_rollout.SDERolloutFn`:
kernel K1 forward, kernel K2 backward.  Both keep the same parameters.
``dtype`` is the compute dtype of every Linear and LayerNorm (flax's mixed
precision): with bf16 the rollout state is bf16 on the loop path, the
kernels take it in f32 and hand it back in bf16, and ``loc`` / ``pi`` /
the scales are cast back to f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F_
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.models.layers import Linear, compute_dtype, layer_norm
from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid
from trajsde_tpu_torch.ops.sde_rollout import SDERolloutFn, pack_params, rollout_params_from_module


def _mlp_head(parent: nn.Module, prefix: str, din: int, dims, dtype=None) -> None:
    """Register ``{prefix}_dense{i}`` Linear layers of widths ``dims``
    (input ``din``), each but the last followed by ``{prefix}_ln{i}``."""
    for i, d in enumerate(dims):
        parent.add_module(f"{prefix}_dense{i}", Linear(din, d, dtype))
        if i < len(dims) - 1:
            parent.add_module(f"{prefix}_ln{i}", layer_norm(d, dtype))
        din = d


def _apply_head(parent: nn.Module, prefix: str, depth: int, x: torch.Tensor) -> torch.Tensor:
    """Dense -> LayerNorm -> ReLU for each hidden layer of a ``depth``-layer
    head, then the plain last Dense."""
    for i in range(depth - 1):
        x = torch.relu(getattr(parent, f"{prefix}_ln{i}")(getattr(parent, f"{prefix}_dense{i}")(x)))
    return getattr(parent, f"{prefix}_dense{depth - 1}")(x)


class MLPDecoder(nn.Module):
    """The baseline's one-shot decoder: the mode scores from [local,
    global], and every mode's ``Tf`` locations (and scales) at once from
    ``relu(aggr_ln(aggr_dense([global, local])))``."""

    def __init__(self, local_channels: int, global_channels: int, future_steps: int,
                 num_modes: int, uncertain: bool = True, min_scale: float = 1e-3, dtype=None):
        super().__init__()
        D = local_channels
        self.compute_dtype = compute_dtype(dtype)
        self.future_steps = future_steps
        self.num_modes = num_modes
        self.uncertain = uncertain
        self.min_scale = min_scale
        _mlp_head(self, "pi", D + global_channels, [D, D, 1], dtype)
        self.aggr_dense = Linear(D + global_channels, D, dtype)
        self.aggr_ln = layer_norm(D, dtype)
        _mlp_head(self, "loc", D, [D, future_steps * 2], dtype)
        if uncertain:
            _mlp_head(self, "scale", D, [D, future_steps * 2], dtype)

    def forward(self, scene: SceneBatch, local_embed, global_embed,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """No draws: ``generator`` is accepted for the composition's call."""
        B, F, A = global_embed.shape[:3]
        Tf = self.future_steps
        local_exp = local_embed[:, None].expand(global_embed.shape)
        pi = _apply_head(self, "pi", 3, torch.cat([local_exp, global_embed], dim=-1))
        pi = pi[..., 0].permute(0, 2, 1).float()                # [B, A, F]
        h = torch.relu(self.aggr_ln(self.aggr_dense(torch.cat([global_embed, local_exp], -1))))
        loc = _apply_head(self, "loc", 2, h).reshape(B, F, A, Tf, 2).float()
        if self.uncertain:
            scale = _apply_head(self, "scale", 2, h).reshape(B, F, A, Tf, 2).float()
            loc = torch.cat([loc, F_.elu(scale) + 1.0 + self.min_scale], dim=-1)
        return {"loc": loc, "pi": pi, "reg_mask": ~scene.padding_mask[:, :, -Tf:]}


class SDEDecoder(nn.Module):
    """The 60-step Euler-Maruyama rollout over ``linspace(0, max_fut_t,
    Tf+1)`` on the fused ``[B, F, A, D]`` state; each step's latent decodes
    to a 2-D location and scale."""

    def __init__(self, local_channels: int, global_channels: int, future_steps: int,
                 num_modes: int, max_fut_t: float = 6.0, uncertain: bool = True,
                 min_scale: float = 1e-3, sde_layers: int = 2, method: str = "euler",
                 dtype=None, fused: bool = False):
        super().__init__()
        if method != "euler":
            raise NotImplementedError(f"SDE method {method!r} is not supported (euler only)")
        if fused and sde_layers != 2:
            raise NotImplementedError(
                "SDEDecoder(fused=True) hardcodes the sde_layers=2 topology of the "
                "rollout kernels; use fused=False for other depths"
            )
        D = local_channels
        self.compute_dtype = compute_dtype(dtype)
        self.local_channels = D
        self.future_steps = future_steps
        self.num_modes = num_modes
        self.max_fut_t = float(max_fut_t)
        self.uncertain = uncertain
        self.min_scale = min_scale
        self.fused = fused
        self.aggr_dense = Linear(D + global_channels, D, dtype)
        self.aggr_ln = layer_norm(D, dtype)
        self.sde_rollout = SDEStep(D, sde_layers, dtype)
        heads = {"loc_layers": (D, 2), "pi_layers": (D + global_channels, 1)}
        if uncertain:
            heads["scale_layers"] = (D, 2)
        for name, (din, dout) in heads.items():
            self.add_module(f"{name}_0", Linear(din, D, dtype))
            self.add_module(f"{name}_1", layer_norm(D, dtype))
            self.add_module(f"{name}_2", Linear(D, dout, dtype))

    def _head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(getattr(self, f"{name}_1")(getattr(self, f"{name}_0")(x)))
        return getattr(self, f"{name}_2")(h)

    def time_grid(self, device=None):
        return decoder_time_grid(self.future_steps, self.max_fut_t, device=device)

    def fuse(self, scene: SceneBatch, local_embed, global_embed) -> torch.Tensor:
        """Initial rollout state ``y0 [B, F, A, D]``."""
        local_exp = local_embed[:, None].expand(global_embed.shape)
        h = self.aggr_dense(torch.cat([global_embed, local_exp], dim=-1))
        return torch.relu(self.aggr_ln(h))

    def decode(self, scene: SceneBatch, sol, local_embed, global_embed) -> Dict[str, torch.Tensor]:
        """Per-step latents ``sol [B, F, A, Tf, D]`` (f32 or the compute
        dtype) -> output dict, in f32."""
        Tf = self.future_steps
        local_exp = local_embed[:, None].expand(global_embed.shape)
        loc = self._head("loc_layers", sol).float()
        pi = self._head("pi_layers", torch.cat([local_exp, global_embed], dim=-1))
        pi = pi[..., 0].permute(0, 2, 1).float()                # [B, A, F]
        if self.uncertain:
            scale = F_.elu(self._head("scale_layers", sol).float()) + 1.0 + self.min_scale
            loc = torch.cat([loc, scale], dim=-1)
        return {"loc": loc, "pi": pi, "reg_mask": ~scene.padding_mask[:, :, -Tf:]}

    def rollout(self, y0: torch.Tensor, sde_noise: torch.Tensor) -> torch.Tensor:
        """The plain rollout: ``ys [Tf, *y0.shape]`` from unit normals
        ``sde_noise [Tf, *y0.shape]``."""
        t0s, dts = self.time_grid(device=y0.device)
        ys, y = [], y0
        for t in range(self.future_steps):
            y = self.sde_rollout(y, t0s[t], dts[t], sde_noise[t])
            ys.append(y)
        return torch.stack(ys)

    def fused_rollout(self, y0: torch.Tensor, seed: Union[int, torch.Tensor],
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rollout through the kernels: ``ys [Tf, *y0.shape]`` from the
        ``[B*F*A, D]`` rows in (B, F, A) order, with gaussian increments
        drawn in the kernel from ``seed`` (an int or a 0-d int64 host
        tensor, the same draws for the same value, or the keys of
        ``ops.sde_rollout.rollout_keys`` on the device) or explicit ``noise
        [Tf, B*F*A, D]``.  Gradients reach ``y0`` and every ``sde_rollout`` weight.  The
        kernels run in f32: a bf16 ``y0`` is cast up for them and ``ys``
        comes back in ``y0``'s dtype, as in the JAX decoder."""
        D = y0.shape[-1]
        w = pack_params(rollout_params_from_module(self.sde_rollout, detach=False))
        t0s, dts = self.time_grid(device=y0.device)
        ys = SDERolloutFn.apply(y0.reshape(-1, D).float().contiguous(), w, t0s, dts, seed,
                                self.future_steps, noise, "gaussian")
        return ys.reshape((self.future_steps,) + tuple(y0.shape)).to(y0.dtype)

    def forward(self, scene: SceneBatch, local_embed, global_embed,
                sde_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rollout_seed: Union[int, torch.Tensor, None] = None) -> Dict[str, torch.Tensor]:
        """``sde_noise [Tf, B, F, A, D]`` pins the Brownian unit normals;
        otherwise they are drawn from ``generator``.  With ``fused=True``
        the kernel draws them from ``rollout_seed``, which is required: a
        host integer or a 0-d int64 tensor on the host (an input, not a
        constant, of an exported program), or the int32 [2] keys of
        ``ops.sde_rollout.rollout_keys`` on the device (a captured train
        step's)."""
        y0 = self.fuse(scene, local_embed, global_embed)
        if self.fused:
            if sde_noise is not None:
                raise NotImplementedError(
                    "explicit sde_noise requires the loop rollout (fused=False); "
                    "pass noise to fused_rollout instead"
                )
            if rollout_seed is None:
                raise ValueError("SDEDecoder(fused=True) needs rollout_seed, a host integer "
                                 "or a 0-d int64 host tensor")
            ys = self.fused_rollout(y0, rollout_seed)
        else:
            if sde_noise is None:
                sde_noise = torch.randn((self.future_steps,) + y0.shape, generator=generator,
                                        device=y0.device, dtype=y0.dtype)
            ys = self.rollout(y0, sde_noise)
        sol = ys.permute(1, 2, 3, 0, 4)                            # [B, F, A, Tf, D]
        return self.decode(scene, sol, local_embed, global_embed)
