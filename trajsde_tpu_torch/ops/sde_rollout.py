"""Decoder rollout kernel K1: wrapper, plain PyTorch version, parameters.

Counterpart of ``trajsde_tpu/ops/pallas/sde_rollout.py::sde_rollout``.
On a CUDA tensor :func:`sde_rollout` launches the hand-written kernel in
``csrc/sde_rollout.cu`` (built by nvcc at first use, bound with ctypes);
on a CPU tensor it runs :func:`sde_rollout_reference`, a loop of
:func:`euler_step`.  Nothing falls back from one to the other.

In-kernel noise is a counter-based hash keyed by (seed, global row, step,
word), so the draws do not depend on the tiling; the plain version
reproduces the same 32-bit integers with int64 tensor ops, which holds
the kernel's generator to it value for value.  The TPU's on-core PRNG
bits cannot be reproduced: against JAX the generator is compared by
statistics.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

# the 14 rollout weights in the kernel's packed layout (csrc/sde_rollout.cu)
PARAM_ORDER = ("wf0", "wf1", "wf2", "wg0", "wg1", "wf0t", "wg0t",
               "bf0", "bf1", "bf2", "bg0", "bg1", "wgo", "bgo")
KERNEL_DIM = 64
INCREMENTS = {"rademacher": 1, "gaussian": 2}
_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def rollout_params_from_module(step) -> Dict[str, torch.Tensor]:
    """Split an ``SDEStep``'s weights into the kernel layout (matrices
    [in, out], biases [1, out]): ``dense0`` columns ``[:D]`` multiply y,
    columns ``D`` / ``D+1`` multiply sin t / cos t."""
    f, g = step.f_func, step.g_func
    if f.num_layers != 2:
        raise NotImplementedError(
            f"the rollout kernel hardcodes sde_layers=2 (decoder has {f.num_layers})"
        )
    D = f.dense1.weight.shape[0]
    t = lambda lin: lin.weight.detach().t()  # noqa: E731
    b = lambda lin: lin.bias.detach()[None]  # noqa: E731
    return dict(
        wf0=t(f.dense0)[:D], wf0t=t(f.dense0)[D:], bf0=b(f.dense0),
        wf1=t(f.dense1), bf1=b(f.dense1), wf2=t(f.dense2), bf2=b(f.dense2),
        wg0=t(g.dense0)[:D], wg0t=t(g.dense0)[D:], bg0=b(g.dense0),
        wg1=t(g.dense1), bg1=b(g.dense1), wgo=t(g.dense_out), bgo=b(g.dense_out),
    )


def time_table(t0s: torch.Tensor, dts: torch.Tensor) -> torch.Tensor:
    """[T, 4] f32 rows of (sin t0, cos t0, dt, sqrt dt)."""
    t0s, dts = t0s.float(), dts.float()
    return torch.stack([torch.sin(t0s), torch.cos(t0s), dts, torch.sqrt(dts)], -1).contiguous()


# --------------------------------------------------------------------------
# counter-based generator (must match csrc/sde_rollout.cu bit for bit)
# --------------------------------------------------------------------------
def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def seed_keys(seed: int):
    """The two 32-bit keys the generator derives from a seed."""
    k1 = _fmix32_int(int(seed) & _M32)
    return k1, _fmix32_int(k1 ^ 0x9E3779B9)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32): 16-bit halves keep
    every intermediate below 2**49."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_bits(keys, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits (as int64) per counter, truncated to 32 bits."""
    k1, k2 = keys
    return _fmix32(_fmix32((counter & _M32) ^ k1) ^ k2)


def draw_increments(keys, rows: torch.Tensor, t: int, num_steps: int, dim: int,
                    increments: str) -> torch.Tensor:
    """Unit increments ``z [len(rows), dim]`` for step ``t``."""
    rows = rows.to(torch.int64)[:, None]
    if increments == "rademacher":
        words = dim // 32
        lane = torch.arange(dim, device=rows.device)
        counter = (rows * num_steps + t) * words + (lane // 32)
        bit = (draw_bits(keys, counter) >> (lane % 32)) & 1
        return torch.where(bit == 1, 1.0, -1.0).to(torch.float32)
    if increments == "gaussian":
        # pair p uses words 2p, 2p+1; lane p takes r cos(a), lane p + dim/2 r sin(a)
        word = torch.arange(dim, device=rows.device)
        bits = draw_bits(keys, (rows * num_steps + t) * dim + word)
        u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
        u = u.clamp(1.0 / 16777216.0, 1.0 - 1.0 / 16777216.0)
        u1, u2 = u[:, 0::2], u[:, 1::2]
        r = torch.sqrt(-2.0 * torch.log(u1))
        a = 6.283185307179586 * u2
        return torch.cat([r * torch.cos(a), r * torch.sin(a)], dim=-1)
    raise ValueError(f"unknown increments {increments!r} (rademacher | gaussian)")


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------
def euler_step(y, s, c, dt, sqrt_dt, z, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One Euler-Maruyama step of the kernel's arithmetic."""
    h = torch.tanh(y @ p["wf0"] + (s * p["wf0t"][0] + c * p["wf0t"][1]) + p["bf0"][0])
    h = torch.tanh(h @ p["wf1"] + p["bf1"][0])
    f = h @ p["wf2"] + p["bf2"][0]
    hg = torch.tanh(y @ p["wg0"] + (s * p["wg0t"][0] + c * p["wg0t"][1]) + p["bg0"][0])
    hg = torch.tanh(hg @ p["wg1"] + p["bg1"][0])
    g = torch.sigmoid(hg @ p["wgo"] + p["bgo"][0])
    return y + f * dt + g * (sqrt_dt * z)


def sde_rollout_reference(y0, params, t0s, dts, seed, num_steps: int,
                          noise: Optional[torch.Tensor] = None,
                          increments: str = "gaussian") -> torch.Tensor:
    """``ys [T, N, D]`` by a loop of :func:`euler_step`, drawing the
    kernel's own increments when ``noise`` is None."""
    N, D = y0.shape
    tsc = time_table(t0s, dts).to(y0.device)
    keys = seed_keys(seed)
    rows = torch.arange(N, device=y0.device)
    ys, y = [], y0
    for t in range(num_steps):
        z = noise[t] if noise is not None else draw_increments(keys, rows, t, num_steps, D, increments)
        y = euler_step(y, tsc[t, 0], tsc[t, 1], tsc[t, 2], tsc[t, 3], z, params)
        ys.append(y)
    return torch.stack(ys)


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------
def pack_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's flat weight buffer (``bgo`` padded to 4 floats)."""
    D = KERNEL_DIM
    shapes = dict(wf0=(D, D), wf1=(D, D), wf2=(D, D), wg0=(D, D), wg1=(D, D),
                  wf0t=(2, D), wg0t=(2, D), bf0=(1, D), bf1=(1, D), bf2=(1, D),
                  bg0=(1, D), bg1=(1, D), wgo=(D, 1), bgo=(1, 1))
    parts = []
    for k in PARAM_ORDER:
        if tuple(params[k].shape) != shapes[k]:
            raise ValueError(f"rollout param {k} has shape {tuple(params[k].shape)}, "
                             f"the kernel takes {shapes[k]}")
        parts.append(params[k].reshape(-1).float())
    parts.append(params["bgo"].new_zeros(3, dtype=torch.float32))
    return torch.cat(parts).contiguous()


@functools.cache
def _library():
    from trajsde_tpu_torch.ops import build

    lib = build.load("sde_rollout")
    lib.sde_rollout_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.sde_rollout_launch.restype = ctypes.c_int
    lib.sde_rollout_weight_floats.argtypes = []
    lib.sde_rollout_weight_floats.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, y0 on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(y0, params, t0s, dts, seed, num_steps, noise, increments) -> torch.Tensor:
    N, D = y0.shape
    if D != KERNEL_DIM:
        raise ValueError(f"the rollout kernel is specialised to D={KERNEL_DIM}, got D={D}")
    if N >= 2 ** 31:
        raise ValueError(f"{N} rows exceed the kernel's int32 row count")
    dev = y0.device
    _check("y0", y0, (N, D), dev)
    if noise is not None:
        _check("noise", noise, (num_steps, N, D), dev)
        mode = 0
    elif increments in INCREMENTS:
        mode = INCREMENTS[increments]
    else:
        raise ValueError(f"unknown increments {increments!r} (rademacher | gaussian)")
    w = pack_params({k: v.to(dev) for k, v in params.items()})
    tsc = time_table(t0s, dts).to(dev)
    _check("time table", tsc, (num_steps, 4), dev)
    lib = _library()
    if w.numel() != lib.sde_rollout_weight_floats():
        raise RuntimeError("packed weight layout disagrees with the kernel's")
    ys = torch.empty((num_steps, N, D), device=dev, dtype=torch.float32)
    k1, k2 = seed_keys(seed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sde_rollout_launch(
            y0.data_ptr(), w.data_ptr(), tsc.data_ptr(),
            None if noise is None else noise.data_ptr(), ys.data_ptr(),
            N, num_steps, k1, k2, mode, stream,
        )
    if err != 0:
        raise RuntimeError(f"sde_rollout kernel launch failed: cudaError {err}")
    sde_rollout.launches += 1
    return ys


def sde_rollout(y0: torch.Tensor, params: Dict[str, torch.Tensor], t0s: torch.Tensor,
                dts: torch.Tensor, seed: int, num_steps: int,
                noise: Optional[torch.Tensor] = None,
                increments: str = "gaussian") -> torch.Tensor:
    """Run the rollout; returns ``ys [T, N, D]`` (post-step states).

    ``noise [T, N, D]`` gives explicit unit increments; otherwise they are
    drawn in the kernel (``'gaussian'`` Box-Muller or ``'rademacher'``
    +-1, one bit per lane) from ``seed``.  On CUDA the kernel runs on the
    current stream without synchronising and ``sde_rollout.launches``
    counts its launches; on the CPU the plain version runs.
    """
    if y0.device.type == "cuda":
        return _launch(y0, params, t0s, dts, seed, num_steps, noise, increments)
    if y0.device.type == "cpu":
        return sde_rollout_reference(y0, params, t0s, dts, seed, num_steps, noise, increments)
    raise ValueError(f"sde_rollout runs on cuda (kernel) or cpu (plain), not {y0.device}")


sde_rollout.launches = 0
