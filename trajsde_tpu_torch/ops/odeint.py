"""Fixed-grid ODE integration and the datasets' time grids
(``trajsde_tpu/ops/odeint.py``)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def odeint_euler(f: Fn, y0: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Explicit Euler over the grid ``ts [T+1]``: the states at ``ts[1:]``."""
    y, ys = y0, []
    for i in range(ts.shape[0] - 1):
        t0, dt = ts[i], ts[i + 1] - ts[i]
        y = y + f(t0, y) * dt
        ys.append(y)
    return torch.stack(ys)


def odeint_rk4(f: Fn, y0: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Classic fourth-order Runge-Kutta over the grid ``ts [T+1]``."""
    y, ys = y0, []
    for i in range(ts.shape[0] - 1):
        t0, dt = ts[i], ts[i + 1] - ts[i]
        k1 = f(t0, y)
        k2 = f(t0 + dt / 2, y + dt * k1 / 2)
        k3 = f(t0 + dt / 2, y + dt * k2 / 2)
        k4 = f(t0 + dt, y + dt * k3)
        y = y + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6
        ys.append(y)
    return torch.stack(ys)


def get_timesteps(dataset: str) -> torch.Tensor:
    """A dataset's observation times in f32: Argoverse, reference step 19
    at 10 Hz over [-2, 3] s; nuScenes, reference step 4 at 2 Hz over
    [-2, 6] s; the reference step is set to exactly 0.

    The reference's quirk stays: the ``+1/res`` shift puts Argoverse's step
    19 on 0, but nuScenes' index 3 is already 0, so pinning index 4 gives a
    second 0 (a zero-length segment) and then a 1 s jump.  The trained
    reference weights bake this grid in."""
    if dataset == "Argoverse":
        ref_step, past_t, future_t, res = 19, 2, 3, 10
    elif dataset == "nuScenes":
        ref_step, past_t, future_t, res = 4, 2, 6, 2
    else:
        raise ValueError(dataset)
    ts = torch.from_numpy(np.arange(0, past_t + future_t, 1.0 / res, dtype=np.float32))
    ts = ts - past_t + 1.0 / res
    ts[ref_step] = 0.0
    return ts
