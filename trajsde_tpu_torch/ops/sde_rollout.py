"""Decoder rollout kernels K1 (forward) and K2 (reverse sweep): wrappers,
plain PyTorch versions, parameters, and the autograd Function over both.

Counterparts of ``trajsde_tpu/ops/pallas/sde_rollout.py::sde_rollout``
(K1) and ``_rollout_train_bwd`` / ``sde_rollout_train`` (K2, custom VJP).
On a CUDA tensor :func:`sde_rollout` launches the hand-written kernel in
``csrc/sde_rollout.cu`` and :func:`sde_rollout_bwd` the one in
``csrc/sde_rollout_bwd.cu`` (built by nvcc at first use, bound with
ctypes); on a CPU tensor they run :func:`sde_rollout_reference`, a loop of
:func:`euler_step`, and :func:`sde_rollout_bwd_reference`, its reverse
loop.  Nothing falls back from one to the other.  :class:`SDERolloutFn`
differentiates the packed weight buffer of :func:`pack_params`, so
gradients reach each ``nn.Linear`` through autograd.

In-kernel noise is a counter-based hash keyed by (seed, global row, step,
word), so the draws do not depend on the tiling; the plain version
reproduces the same 32-bit integers with int64 tensor ops, which holds
the kernel's generator to it value for value.  The TPU's on-core PRNG
bits cannot be reproduced: against JAX the generator is compared by
statistics.

A seed is a host integer (or the 0-d int64 host tensor of
:func:`seed_tensor`), from which the host derives the generator's two keys
and passes them as kernel arguments; or it is the keys themselves, the
int32 [2] tensor of :func:`rollout_keys` on the rows' device, which K1
and K2 read from memory.  A CUDA graph replays the arguments it captured,
so the chained train step (``train/loop.py``) writes each update's keys
into one such tensor before its replay.  Both forms draw the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from trajsde_tpu_torch.ops import counted

# the 14 rollout weights in the kernels' packed layout (csrc/rollout_common.cuh)
PARAM_ORDER = ("wf0", "wf1", "wf2", "wg0", "wg1", "wf0t", "wg0t",
               "bf0", "bf1", "bf2", "bg0", "bg1", "wgo", "bgo")
KERNEL_DIM = 64
INCREMENTS = {"rademacher": 1, "gaussian": 2}
_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def rollout_params_from_module(step, detach: bool = True) -> Dict[str, torch.Tensor]:
    """Split an ``SDEStep``'s weights into the kernel layout (matrices
    [in, out], biases [1, out]): ``dense0`` columns ``[:D]`` multiply y,
    columns ``D`` / ``D+1`` multiply sin t / cos t.  ``detach=False``
    keeps the slices in the autograd graph (training)."""
    f, g = step.f_func, step.g_func
    if f.num_layers != 2:
        raise NotImplementedError(
            f"the rollout kernel hardcodes sde_layers=2 (decoder has {f.num_layers})"
        )
    D = f.dense1.weight.shape[0]
    cut = (lambda x: x.detach()) if detach else (lambda x: x)  # noqa: E731
    t = lambda lin: cut(lin.weight).t()  # noqa: E731
    b = lambda lin: cut(lin.bias)[None]  # noqa: E731
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
# counter-based generator (must match csrc/rollout_common.cuh bit for bit)
# --------------------------------------------------------------------------
def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def mix_seed(seed: int, counter: int) -> int:
    """splitmix64-mix (seed, counter) into one well-distributed 31-bit seed."""
    x = (((seed & 0xFFFFFFFF) << 32) | (counter & 0xFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x & 0x7FFFFFFF


def seed_keys(seed: int):
    """The two 32-bit keys the generator derives from a seed."""
    k1 = _fmix32_int(int(seed) & _M32)
    return k1, _fmix32_int(k1 ^ 0x9E3779B9)


def is_rollout_keys(seed) -> bool:
    """Whether ``seed`` is the keys form of :func:`rollout_keys`."""
    return isinstance(seed, torch.Tensor) and seed.dtype == torch.int32 and \
        tuple(seed.shape) == (2,)


def key_words(seed: int):
    """:func:`seed_keys` of ``seed`` as two int32 values (their bit
    patterns)."""
    return [k - (1 << 32) if k >> 31 else k for k in seed_keys(seed)]


def rollout_keys(seed: int, device=None) -> torch.Tensor:
    """:func:`key_words` of ``seed`` as an int32 [2] tensor on ``device``,
    the form in which K1 and K2 read the keys from memory."""
    return torch.tensor(key_words(seed), dtype=torch.int32, device=device)


def _host_keys(seed):
    """The two keys of a seed in either form, as host integers."""
    if is_rollout_keys(seed):
        return tuple(int(k) & _M32 for k in seed.tolist())
    return seed_keys(seed)


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
    keys = _host_keys(seed)
    rows = torch.arange(N, device=y0.device)
    ys, y = [], y0
    for t in range(num_steps):
        z = noise[t] if noise is not None else draw_increments(keys, rows, t, num_steps, D, increments)
        y = euler_step(y, tsc[t, 0], tsc[t, 1], tsc[t, 2], tsc[t, 3], z, params)
        ys.append(y)
    return torch.stack(ys)


def sde_rollout_bwd_reference(y0, ys, ct, params, t0s, dts, seed, num_steps: int,
                              noise: Optional[torch.Tensor] = None,
                              increments: str = "gaussian"):
    """The reverse sweep of :func:`sde_rollout_reference` in the kernel's
    arithmetic: ``(dy0 [N, D], {name: grad})`` for the cotangent ``ct``
    of ``ys``.  Each step recomputes its activations from the pre-step
    state (``y0`` or ``ys[t-1]``) and redraws its increments."""
    N, D = y0.shape
    tsc = time_table(t0s, dts).to(y0.device)
    keys = _host_keys(seed)
    rows = torch.arange(N, device=y0.device)
    p = params
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    lam = torch.zeros_like(y0)
    for t in reversed(range(num_steps)):
        s, c, dt, sdt = tsc[t, 0], tsc[t, 1], tsc[t, 2], tsc[t, 3]
        y = y0 if t == 0 else ys[t - 1]
        lam = lam + ct[t]
        z = noise[t] if noise is not None else draw_increments(keys, rows, t, num_steps, D, increments)
        h1 = torch.tanh(y @ p["wf0"] + (s * p["wf0t"][0] + c * p["wf0t"][1]) + p["bf0"][0])
        h2 = torch.tanh(h1 @ p["wf1"] + p["bf1"][0])
        hg1 = torch.tanh(y @ p["wg0"] + (s * p["wg0t"][0] + c * p["wg0t"][1]) + p["bg0"][0])
        hg2 = torch.tanh(hg1 @ p["wg1"] + p["bg1"][0])
        g = torch.sigmoid(hg2 @ p["wgo"] + p["bgo"][0])                      # [N, 1]
        d_f = lam * dt
        d_a2 = (d_f @ p["wf2"].T) * (1.0 - h2 * h2)
        d_a1 = (d_a2 @ p["wf1"].T) * (1.0 - h1 * h1)
        d_o = sdt * (lam * z).sum(-1, keepdim=True) * g * (1.0 - g)           # [N, 1]
        d_ag2 = (d_o @ p["wgo"].T) * (1.0 - hg2 * hg2)
        d_ag1 = (d_ag2 @ p["wg1"].T) * (1.0 - hg1 * hg1)
        for w, b, x, d in (("wf2", "bf2", h2, d_f), ("wf1", "bf1", h1, d_a2),
                           ("wf0", "bf0", y, d_a1), ("wgo", "bgo", hg2, d_o),
                           ("wg1", "bg1", hg1, d_ag2), ("wg0", "bg0", y, d_ag1)):
            grads[w] = grads[w] + x.T @ d
            grads[b] = grads[b] + d.sum(0, keepdim=True)
        for wt, d in (("wf0t", d_a1), ("wg0t", d_ag1)):
            cs = d.sum(0)
            grads[wt] = grads[wt] + torch.stack([s * cs, c * cs])
        lam = lam + d_a1 @ p["wf0"].T + d_ag1 @ p["wg0"].T
    return lam, grads


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
def _shapes(D: int):
    return dict(wf0=(D, D), wf1=(D, D), wf2=(D, D), wg0=(D, D), wg1=(D, D),
                wf0t=(2, D), wg0t=(2, D), bf0=(1, D), bf1=(1, D), bf2=(1, D),
                bg0=(1, D), bg1=(1, D), wgo=(D, 1), bgo=(1, 1))


def pack_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernels' flat weight buffer (``bgo`` padded to 4 floats), built
    with differentiable ops: gradients of the buffer reach ``params``."""
    shapes = _shapes(params["wf0"].shape[0])
    parts = []
    for k in PARAM_ORDER:
        if tuple(params[k].shape) != shapes[k]:
            raise ValueError(f"rollout param {k} has shape {tuple(params[k].shape)}, "
                             f"the kernel takes {shapes[k]}")
        parts.append(params[k].reshape(-1))
    parts.append(params["bgo"].new_zeros(3))
    return torch.cat(parts)


def unpack_params(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """Views of a packed buffer as the named weights (inverse of
    :func:`pack_params`)."""
    out, at = {}, 0
    for k, shape in _shapes(dim).items():
        n = shape[0] * shape[1]
        out[k] = w[at: at + n].view(shape)
        at += n
    if at + 3 != w.numel():
        raise ValueError(f"packed rollout buffer has {w.numel()} floats, D={dim} needs {at + 3}")
    return out


@functools.cache
def _library():
    from trajsde_tpu_torch.ops import build

    lib = build.load("sde_rollout")
    lib.sde_rollout_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sde_rollout_launch.restype = ctypes.c_int
    lib.sde_rollout_weight_floats.argtypes = []
    lib.sde_rollout_weight_floats.restype = ctypes.c_int
    return lib


def configure_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the ctypes signatures of a library built from a K2 source (a
    source older than the trailing keys pointer ignores the null passed for
    it)."""
    lib.sde_rollout_bwd_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sde_rollout_bwd_launch.restype = ctypes.c_int
    lib.sde_rollout_bwd_weight_floats.argtypes = []
    lib.sde_rollout_bwd_weight_floats.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library():
    from trajsde_tpu_torch.ops import build

    return configure_bwd(build.load("sde_rollout_bwd"))


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, y0 on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _common_checks(y0, w, t0s, dts, num_steps, noise, increments, weight_floats):
    """Checks shared by both launches -> (mode, time table)."""
    N, D = y0.shape
    if D != KERNEL_DIM:
        raise ValueError(f"the rollout kernels are specialised to D={KERNEL_DIM}, got D={D}")
    if N >= 2 ** 31:
        raise ValueError(f"{N} rows exceed the kernels' int32 row count")
    dev = y0.device
    _check("y0", y0, (N, D), dev)
    _check("w", w, (weight_floats,), dev)
    if noise is not None:
        _check("noise", noise, (num_steps, N, D), dev)
        mode = 0
    elif increments in INCREMENTS:
        mode = INCREMENTS[increments]
    else:
        raise ValueError(f"unknown increments {increments!r} (rademacher | gaussian)")
    tsc = time_table(t0s, dts).to(dev)
    _check("time table", tsc, (num_steps, 4), dev)
    return mode, tsc


def _key_args(seed, device):
    """(k1, k2, keys pointer) of a launch: the host's keys and a null
    pointer, or zeros and the address of a :func:`rollout_keys` tensor."""
    if not is_rollout_keys(seed):
        return (*seed_keys(seed), None)
    if seed.device != device or not seed.is_contiguous():
        raise ValueError(f"the rollout keys must be contiguous on {device}, got {seed.device}")
    return 0, 0, seed.data_ptr()


def _launch(y0, w, t0s, dts, seed, num_steps, noise, increments) -> torch.Tensor:
    lib = _library()
    mode, tsc = _common_checks(y0, w, t0s, dts, num_steps, noise, increments,
                               lib.sde_rollout_weight_floats())
    N, D = y0.shape
    ys = torch.empty((num_steps, N, D), device=y0.device, dtype=torch.float32)
    k1, k2, keys = _key_args(seed, y0.device)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        err = lib.sde_rollout_launch(
            y0.data_ptr(), w.data_ptr(), tsc.data_ptr(),
            None if noise is None else noise.data_ptr(), ys.data_ptr(),
            N, num_steps, k1, k2, mode, stream, keys,
        )
    if err != 0:
        raise RuntimeError(f"sde_rollout kernel launch failed: cudaError {err}")
    sde_rollout.launches += 1
    return ys


def seed_tensor(seed) -> torch.Tensor:
    """The rollout seed as :func:`rollout_op` takes it: a 0-d int64 tensor
    on the host (a Python int is wrapped).  As a tensor it is an input of
    an exported program, not a constant baked into it."""
    if isinstance(seed, torch.Tensor):
        if seed.dim() != 0 or seed.dtype != torch.int64 or seed.device.type != "cpu":
            raise ValueError(f"the rollout seed must be a 0-d int64 tensor on the host, got "
                             f"shape {tuple(seed.shape)} {seed.dtype} on {seed.device}")
        return seed
    return torch.tensor(int(seed), dtype=torch.int64)


@torch.library.custom_op("trajsde::sde_rollout", mutates_args=())
def rollout_op(y0: torch.Tensor, w: torch.Tensor, t0s: torch.Tensor, dts: torch.Tensor,
               seed: torch.Tensor, num_steps: int, noise: Optional[torch.Tensor],
               increments: str) -> torch.Tensor:
    """``trajsde::sde_rollout``, the registered op over K1: ``ys [T, N, D]``
    from the packed weights ``w`` and the host seed tensor of
    :func:`seed_tensor`.  On a CUDA tensor it launches K1 (counted in
    ``sde_rollout.launches``), on a CPU tensor it runs the plain version;
    ``torch.export`` records it as one opaque call."""
    s = int(seed_tensor(seed))
    if y0.device.type == "cuda":
        return _launch(y0, w, t0s, dts, s, num_steps, noise, increments)
    if y0.device.type == "cpu":
        return sde_rollout_reference(y0, unpack_params(w, y0.shape[1]), t0s, dts, s, num_steps,
                                     noise, increments)
    raise ValueError(f"sde_rollout runs on cuda (kernel) or cpu (plain), not {y0.device}")


@rollout_op.register_fake
def _rollout_fake(y0, w, t0s, dts, seed, num_steps, noise, increments):
    return y0.new_empty((num_steps,) + tuple(y0.shape))


def sde_rollout(y0: torch.Tensor, params: Dict[str, torch.Tensor], t0s: torch.Tensor,
                dts: torch.Tensor, seed, num_steps: int,
                noise: Optional[torch.Tensor] = None,
                increments: str = "gaussian") -> torch.Tensor:
    """Run the rollout; returns ``ys [T, N, D]`` (post-step states).

    ``noise [T, N, D]`` gives explicit unit increments; otherwise they are
    drawn in the kernel (``'gaussian'`` Box-Muller or ``'rademacher'``
    +-1, one bit per lane) from ``seed``, an int or a 0-d int64 host
    tensor, or the keys of :func:`rollout_keys` on ``y0``'s device.  On
    CUDA the kernel runs on the current stream without synchronising and
    ``sde_rollout.launches`` counts its launches; on the CPU the plain
    version runs.  Both go through :func:`rollout_op`, the keys form
    (which no exported program takes) around it.
    """
    w = pack_params({k: v.to(y0.device) for k, v in params.items()})
    return sde_rollout_packed(y0, w, t0s, dts, seed, num_steps, noise, increments)


counted(sde_rollout, "launches")


def sde_rollout_packed(y0: torch.Tensor, w: torch.Tensor, t0s: torch.Tensor, dts: torch.Tensor,
                       seed, num_steps: int, noise: Optional[torch.Tensor] = None,
                       increments: str = "gaussian") -> torch.Tensor:
    """:func:`sde_rollout` on the packed buffer ``w`` of :func:`pack_params`
    (K1's launches count on ``sde_rollout.launches``)."""
    # checked here: on a meta tensor the op would run its fake and return
    if y0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sde_rollout runs on cuda (kernel) or cpu (plain), not {y0.device}")
    if is_rollout_keys(seed):
        if y0.device.type == "cuda":
            return _launch(y0, w, t0s, dts, seed, num_steps, noise, increments)
        return sde_rollout_reference(y0, unpack_params(w, y0.shape[1]), t0s, dts, seed,
                                     num_steps, noise, increments)
    return rollout_op(y0, w, t0s, dts, seed_tensor(seed), num_steps, noise, increments)


BWD_TILE_ROWS = 32  # K2's row tile (ROWS in csrc/sde_rollout_bwd.cu)


def launch_bwd(lib: ctypes.CDLL, y0, ys, ct, w, t0s, dts, seed, num_steps, noise, increments):
    """Launch K2 from ``lib`` (the package's build or another build of its
    source configured by :func:`configure_bwd`) on the current stream and
    return ``(dy0, dw)``; counts nothing."""
    mode, tsc = _common_checks(y0, w, t0s, dts, num_steps, noise, increments,
                               lib.sde_rollout_bwd_weight_floats())
    N, D = y0.shape
    _check("ys", ys, (num_steps, N, D), y0.device)
    _check("ct", ct, (num_steps, N, D), y0.device)
    # one block per SM walks the row tiles; each adds its weight gradients
    # to its own f64 row after every tile, and a second kernel sums the rows
    # in block order
    sms = torch.cuda.get_device_properties(y0.device).multi_processor_count
    grid = min(-(-N // BWD_TILE_ROWS), sms)
    partial = torch.empty((grid, w.numel()), device=y0.device, dtype=torch.float64)
    dy0 = torch.empty_like(y0)
    dw = torch.empty_like(w)
    k1, k2, keys = _key_args(seed, y0.device)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        err = lib.sde_rollout_bwd_launch(
            y0.data_ptr(), ys.data_ptr(), ct.data_ptr(), w.data_ptr(), tsc.data_ptr(),
            None if noise is None else noise.data_ptr(), dy0.data_ptr(), dw.data_ptr(),
            partial.data_ptr(), N, num_steps, k1, k2, mode, grid, stream, keys,
        )
    if err != 0:
        raise RuntimeError(f"sde_rollout_bwd kernel launch failed: cudaError {err}")
    return dy0, dw


def sde_rollout_bwd(y0: torch.Tensor, ys: torch.Tensor, ct: torch.Tensor, w: torch.Tensor,
                    t0s: torch.Tensor, dts: torch.Tensor, seed, num_steps: int,
                    noise: Optional[torch.Tensor] = None, increments: str = "gaussian"):
    """The reverse sweep: ``(dy0 [N, D], dw)`` (``dw`` packed like ``w``)
    for the cotangent ``ct [T, N, D]`` of the forward's ``ys``, with the
    forward's own ``seed`` (either form)/``increments`` or ``noise``.

    On CUDA kernel K2 runs on the current stream without synchronising and
    ``sde_rollout_bwd.launches`` counts its launches; its weight gradients
    are summed in a fixed order, so they are the same run after run.  On
    the CPU the plain version runs.
    """
    if y0.device.type == "cuda":
        out = launch_bwd(_bwd_library(), y0, ys, ct, w, t0s, dts, seed, num_steps, noise,
                         increments)
        sde_rollout_bwd.launches += 1
        return out
    if y0.device.type == "cpu":
        dy0, grads = sde_rollout_bwd_reference(y0, ys, ct, unpack_params(w, y0.shape[1]), t0s,
                                               dts, seed, num_steps, noise, increments)
        return dy0, pack_params(grads)
    raise ValueError(f"sde_rollout_bwd runs on cuda (kernel) or cpu (plain), not {y0.device}")


counted(sde_rollout_bwd, "launches")


class SDERolloutFn(torch.autograd.Function):
    """``ys = rollout(y0, w)`` with K1 forward and K2 backward (the port of
    ``sde_rollout_train``'s custom VJP).

    ``apply(y0, w, t0s, dts, seed, num_steps, noise, increments)``; only
    ``y0`` and the packed weights ``w`` get gradients: ``t0s``, ``dts``
    and explicit ``noise`` are constants, as in the JAX package.  A
    :func:`rollout_keys` seed is read by both kernels from memory, so its
    value at the backward must still be the forward's.
    """

    @staticmethod
    def forward(ctx, y0, w, t0s, dts, seed, num_steps, noise, increments):
        ys = sde_rollout_packed(y0, w, t0s, dts, seed, num_steps, noise, increments)
        ctx.save_for_backward(y0, w, ys, t0s, dts, noise)
        ctx.seed, ctx.num_steps, ctx.increments = seed, num_steps, increments
        return ys

    @staticmethod
    def backward(ctx, ct):
        y0, w, ys, t0s, dts, noise = ctx.saved_tensors
        # the decoder's [B, F, A, Tf, D] layout hands ct over as a permuted
        # view; the kernel reads [T, N, D] rows, so it is copied once here
        dy0, dw = sde_rollout_bwd(y0, ys, ct.contiguous(), w, t0s, dts, ctx.seed,
                                  ctx.num_steps, noise, ctx.increments)
        return dy0, dw, None, None, None, None, None, None
