"""SDE integration: fixed-grid Euler-Maruyama, its latent-KL form, and
adaptive step doubling (``trajsde_tpu/ops/sdeint.py``).

* drift is the posterior ``f``; the OU prior ``h`` enters only the KL path;
* diffusion ``g`` is evaluated at the segment start (Euler), and may be one
  magnitude per row (``[..., 1]``) or full (``[..., D]``);
* ``y1 = y0 + f(t0, y0) dt + g(t0, y0) sqrt(dt) eps``.

The fixed-grid functions take their unit normals as ``eps [T, ...]`` or
draw them from ``generator`` in one ``torch.randn``.  The adaptive solver
draws its noise from a :class:`~trajsde_tpu_torch.ops.brownian.BrownianTree`
whose nodes are pinned or drawn from ``generator`` the same way.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from trajsde_tpu_torch.ops.brownian import BrownianTree

F32 = torch.float32
Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# the step controller (JAX's defaults, which no caller changes): PI gains in
# Söderlind form for an order-1 method, the safety factor and the clip of
# the step's growth
K_I, K_P = 0.7 / 2.0, 0.4 / 2.0
SAFETY, MIN_FACTOR, MAX_FACTOR = 0.9, 0.2, 1.4


def _unit_normals(eps, generator, steps: int, y0: torch.Tensor) -> torch.Tensor:
    if eps is None:
        return torch.randn((steps,) + tuple(y0.shape), generator=generator, device=y0.device,
                           dtype=y0.dtype)
    if tuple(eps.shape) != (steps,) + tuple(y0.shape):
        raise ValueError(f"eps {tuple(eps.shape)}: expected {(steps,) + tuple(y0.shape)}")
    return eps.to(y0.dtype)


def euler_maruyama(f: Fn, g: Fn, y0: torch.Tensor, ts: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate ``dy = f dt + g dW`` on the grid ``ts [T+1]``, one step per
    segment.  Returns ``ys [T, ...]`` (the states after each step) and
    ``gs [T, ...]`` (each step's diffusion, as ``g`` returns it)."""
    T = ts.shape[0] - 1
    eps = _unit_normals(eps, generator, T, y0)
    y, ys, gs = y0, [], []
    for i in range(T):
        t0, dt = ts[i], ts[i + 1] - ts[i]
        drift, diff = f(t0, y), g(t0, y)
        y = y + drift * dt + diff * (torch.sqrt(dt) * eps[i])
        ys.append(y)
        gs.append(diff)
    return torch.stack(ys), torch.stack(gs)


def euler_maruyama_logqp(f: Fn, g: Fn, h: Fn, y0: torch.Tensor, ts: torch.Tensor,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent-SDE integration with the KL path penalty between the posterior
    (drift ``f``) and the prior (drift ``h``) under the shared diffusion
    ``g``: ``dKL = |(f - h) / g|^2 / 2 dt``.  Returns ``ys [T, ..., D]`` and
    the terminal KL per row, ``kl [...]``."""
    T = ts.shape[0] - 1
    eps = _unit_normals(eps, generator, T, y0)
    y, ys = y0, []
    kl = torch.zeros(y0.shape[:-1], dtype=y0.dtype, device=y0.device)
    for i in range(T):
        t0, dt = ts[i], ts[i + 1] - ts[i]
        drift, diff = f(t0, y), g(t0, y)
        u = (drift - h(t0, y)) / torch.clamp_min(diff.abs(), 1e-6)
        kl = kl + 0.5 * torch.sum(u * u, dim=-1) * dt
        y = y + drift * dt + diff * (torch.sqrt(dt) * eps[i])
        ys.append(y)
    return torch.stack(ys), kl


def _scalar(x, device) -> torch.Tensor:
    """``x`` (a Python number or a 0-d tensor) as a 0-d f32 tensor on
    ``device``, made there (a Python number is filled in, not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return torch.full((), float(x), dtype=F32, device=device)


def sdeint_adaptive(
    f: Fn,
    g: Fn,
    y0: torch.Tensor,
    ts: torch.Tensor,
    *,
    dt0,
    rtol: float = 1e-3,
    atol: float = 1e-3,
    dt_min=1e-4,
    max_steps: int = 128,
    depth: int = 12,
    nodes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Adaptive Euler-Maruyama with step-doubling error control.

    Each iteration takes one full step and two half steps from ``(t, y)``,
    the noise from one Brownian tree on ``[ts[0], ts[-1]]`` (``nodes``
    ``[2**depth, *y0.shape]``, or drawn from ``generator``).  The error is
    one rtol/atol-weighted RMS over the whole batch, so every row shares the
    steps; it is taken without gradient, and a PI controller (k_i 0.35,
    k_p 0.2, safety 0.9, the factor clipped to [0.2, 1.4]) sizes the next
    step.  A step is accepted if its error is
    at most 1 or it is at the floor ``dt_min``, which is clamped to two leaf
    widths; a step that would leave a final sliver below the floor is
    stretched to the end.  The loop runs ``max_steps`` iterations; a
    rejected or finished iteration is a no-op.  ``t``, ``dt``, the PI
    memory and the counters stay 0-d tensors on ``y0``'s device: the loop
    never reads a value back to the host.  The state is carried in f32.

    Returns ``ys [T, *y0.shape]`` at ``ts[1:]``, linearly interpolated
    within the accepted step that crosses each point (a point past the last
    reached time holds the final state), and ``stats``: ``n_accepted``,
    ``n_rejected``, ``final_dt`` and ``converged`` (False if ``max_steps``
    ran out before ``ts[-1]``).
    """
    dev = y0.device
    ts = torch.as_tensor(ts, dtype=F32, device=dev)
    t_start, t_end = ts[0], ts[-1]
    out_ts = ts[1:]
    T = out_ts.shape[0]
    lead = (T,) + (1,) * y0.dim()
    tree = BrownianTree(t_start, t_end, y0.shape, depth=depth, nodes=nodes, generator=generator)
    # a half step below one leaf would see a zero increment: floor at two leaves
    dt_min = torch.maximum(_scalar(dt_min, dev), 2.0 * (t_end - t_start) / (2 ** depth))

    def error_rms(y_full, y_half):
        tol = atol + rtol * torch.maximum(y_full.abs(), y_half.abs())
        e = (y_full - y_half) / tol
        return torch.sqrt(torch.mean(e * e))

    t = t_start.clone()
    y = y0.to(F32)
    dt = _scalar(dt0, dev)
    prev_err = torch.ones((), dtype=F32, device=dev)
    ys = y.unsqueeze(0).expand((T,) + tuple(y.shape))
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    n_rej = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        active = t < t_end
        step = torch.maximum(dt, dt_min)
        t0 = t
        t1 = torch.where(t_end - (t0 + step) < dt_min, t_end, t0 + step)
        tm = 0.5 * (t0 + t1)

        f0, g0 = f(t0, y), g(t0, y)
        w0, wm, w1 = tree(t0), tree(tm), tree(t1)
        y_full = y + f0 * (t1 - t0) + g0 * (w1 - w0)
        y_mid = y + f0 * (tm - t0) + g0 * (wm - w0)
        y_half = y_mid + f(tm, y_mid) * (t1 - tm) + g(tm, y_mid) * (w1 - wm)

        with torch.no_grad():
            err = torch.clamp_min(error_rms(y_full, y_half), 1e-10)
            factor = torch.clamp(SAFETY * err ** (-(K_I + K_P)) * prev_err ** K_P,
                                 MIN_FACTOR, MAX_FACTOR)
            dt_new = torch.maximum(step * factor, dt_min)
            accept = active & ((err <= 1.0) | (step <= dt_min))
            hit = accept & (out_ts > t0) & (out_ts <= t1)
            w = torch.where(t1 > t0, (out_ts - t0) / torch.clamp_min(t1 - t0, 1e-12), 0.0)
        interp = y.unsqueeze(0) * (1.0 - w).reshape(lead) + y_half.unsqueeze(0) * w.reshape(lead)
        ys = torch.where(hit.reshape(lead), interp, ys)
        t = torch.where(accept, t1, t0)
        y = torch.where(accept, y_half, y)
        dt = torch.where(active, dt_new, dt)
        prev_err = torch.where(accept, err, prev_err)
        n_acc = n_acc + accept.to(torch.int32)
        n_rej = n_rej + (active & ~accept).to(torch.int32)

    ys = torch.where((out_ts > t).reshape(lead), y.unsqueeze(0), ys)
    stats = dict(n_accepted=n_acc, n_rejected=n_rej, final_dt=dt, converged=t >= t_end)
    return ys, stats


def ou_moments(y0, theta: float, mu: float, sigma: float, t):
    """Mean and variance of the Ornstein-Uhlenbeck process
    ``dy = theta (mu - y) dt + sigma dW`` at ``t`` (a test oracle)."""
    t = torch.as_tensor(t, dtype=F32)
    mean = mu + (y0 - mu) * torch.exp(-theta * t)
    var = sigma ** 2 * (1.0 - torch.exp(-2.0 * theta * t)) / (2.0 * theta)
    return mean, var
