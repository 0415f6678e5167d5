"""K1's products in 3xTF32, emulated on the CPU.

Kernel K1 (``trajsde_tpu_torch/csrc/sde_rollout.cu``) runs the five 64x64
products of each Euler-Maruyama step on the tensor cores
(``csrc/mma_tf32.cuh``): ``y @ wf0``, ``y @ wg0``, ``h1 @ wf1``,
``hg1 @ wg1`` and ``h2 @ wf2``.  Each f32 operand x is split into
big = rna_tf32(x) and small = rna_tf32(x - big) (the weights once per
block); per k-step of 8 the TF32 products small * big and big * small are
summed on the tensor cores into one fresh fragment and big * big into
another, two k-steps each, and the two are added to an f32 sum on the CUDA
cores, the small terms first (``mma3x2_apart``).  Each tensor-core step is
modelled as an H100's tensor cores were measured to sum
(``scripts/probe_mma_rounding_torch.py``: each addend cut toward zero 2
bits below the f32 ulp of the largest, the sum rounded toward zero).  The
bias and time-feature terms, the ``tanh``s, the diffusion output
``hg2 @ wgo`` and the update stay in f32.

Here the plain rollout (``sde_rollout_reference``, unedited) runs under
:class:`KernelProducts`, a ``TorchFunctionMode`` that routes exactly those
five products through one of ``MODES``:

* ``3xtf32``: the kernel's arithmetic as above;
* ``3xtf32-mixed``: the three products of a k-step in one fresh fragment,
  as K4 sums them (``mma3x2``);
* ``1xtf32``: one TF32 product (big * big) summed in f32.

With N = 64 rows, T = 60 steps, D = 64, weights, y0 and explicit
increments made with numpy as ``tests/test_torch_sde_rollout_tf32.py``
makes them, and the decoder's time grid, ``ys`` is held against the same
rollout in f64, as max|x - f64| / max|f64|; the limit is 2x the f32 plain
version's distance.  ``3xtf32`` meets it (1.10x the plain distance) and
``1xtf32`` does not (about 7,700x); ``3xtf32-mixed`` would meet it too
(1.02x, printed by the script below, not tested), so K1 sums apart, as K2
does, through the same helpers.

    PYTHONPATH=. python tests/test_torch_sde_rollout_fwd_tf32.py   # the distances, each mode
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from _torch_helpers import torch_threads
from scripts.probe_mma_rounding_torch import mm_3xtf32, rna_tf32
from trajsde_tpu_torch.models.sde import decoder_time_grid
from trajsde_tpu_torch.ops import sde_rollout as K

N, T, D = 64, 60, 64
ROUTED = ("wf0", "wf1", "wf2", "wg0", "wg1")
MODES = {
    "3xtf32": lambda x, w: mm_3xtf32(x, w, False, apart=True),
    "3xtf32-mixed": lambda x, w: mm_3xtf32(x, w, False),
    "1xtf32": lambda x, w: rna_tf32(x) @ rna_tf32(w),
    "f32": lambda x, w: x @ w,
}
KEPT = "3xtf32"
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class KernelProducts(TorchFunctionMode):
    """Routes ``x @ w`` for the five 64x64 weights through ``mode``;
    ``calls`` records the routed weights' names in order."""

    def __init__(self, params, mode: str):
        super().__init__()
        self.params, self.mode, self.calls = params, mode, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS and not kwargs and len(args) == 2:
            a, b = args
            for name in ROUTED:
                if b is self.params[name]:
                    self.calls.append(name)
                    return MODES[self.mode](a.contiguous(), b.contiguous())
        return func(*args, **kwargs)


def _case(seed: int = 0):
    """y0, explicit noise, params, t0s, dts."""
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((r.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    p = dict(wf0=f(D, D, sc=0.3), wf0t=f(2, D, sc=0.3), bf0=f(1, D, sc=0.1),
             wf1=f(D, D, sc=0.3), bf1=f(1, D, sc=0.1), wf2=f(D, D, sc=0.3), bf2=f(1, D, sc=0.1),
             wg0=f(D, D, sc=0.3), wg0t=f(2, D, sc=0.3), bg0=f(1, D, sc=0.1),
             wg1=f(D, D, sc=0.3), bg1=f(1, D, sc=0.1), wgo=f(D, 1, sc=0.3), bgo=f(1, 1, sc=0.1))
    y0, noise = f(N, D, sc=0.5), f(T, N, D)
    t0s, dts = decoder_time_grid(T, 6.0)
    return y0, noise, p, t0s, dts


def routed_rollout(mode: str, calls: list | None = None) -> torch.Tensor:
    """``ys`` of the plain rollout with the five products routed."""
    y0, noise, p, t0s, dts = _case()
    kp = KernelProducts(p, mode)
    with torch_threads(2), kp:
        ys = K.sde_rollout_reference(y0, p, t0s, dts, 0, T, noise)
    if calls is not None:
        calls.extend(kp.calls)
    return ys


@functools.lru_cache(maxsize=None)
def _oracle() -> torch.Tensor:
    """The rollout in f64."""
    y0, noise, p, t0s, dts = _case()
    return K.sde_rollout_reference(y0.double(), {k: v.double() for k, v in p.items()}, t0s,
                                   dts, 0, T, noise.double())


@functools.lru_cache(maxsize=None)
def distance(run: str) -> float:
    """max|ys - f64| / max|f64| of the plain version (``plain``) or a mode."""
    if run == "plain":
        y0, noise, p, t0s, dts = _case()
        ys = K.sde_rollout_reference(y0, p, t0s, dts, 0, T, noise)
    else:
        ys = routed_rollout(run)
    o = _oracle()
    return ((ys.double() - o).abs().max() / o.abs().max()).item()


def within_the_f64_criterion(run: str) -> bool:
    """``ys`` within 2x the f32 plain version's distance from f64."""
    return distance(run) <= 2.0 * distance("plain")


def test_routing_reaches_exactly_the_five_products():
    """Per step y @ wf0, h1 @ wf1, h2 @ wf2, y @ wg0 and hg1 @ wg1, and
    nothing else (hg2 @ wgo stays out); with f32 products the routed
    rollout is the plain one bit for bit."""
    calls = []
    got = routed_rollout("f32", calls)
    assert calls == ["wf0", "wf1", "wf2", "wg0", "wg1"] * T
    y0, noise, p, t0s, dts = _case()
    assert torch.equal(got, K.sde_rollout_reference(y0, p, t0s, dts, 0, T, noise))


def test_3xtf32_rollout_is_within_the_f64_criterion():
    assert within_the_f64_criterion(KEPT), (distance(KEPT), distance("plain"))


def test_1xtf32_rollout_breaks_the_f64_criterion():
    """The criterion tells the kernel's arithmetic from one TF32 product
    per term (2^-11 of each operand)."""
    assert not within_the_f64_criterion("1xtf32"), (distance("1xtf32"), distance("plain"))


if __name__ == "__main__":
    limit = 2.0 * distance("plain")
    print(f"N {N}, T {T}, D {D}: max|ys - f64| / max|f64|; limit {limit:.3e}")
    for run in ("plain", "3xtf32", "3xtf32-mixed", "1xtf32"):
        v = distance(run)
        print(f"  {run:13s} {v:.3e} ({v / distance('plain'):.2f}x plain)")
