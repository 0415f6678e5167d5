"""K2's products in 3xTF32, emulated on the CPU.

Kernel K2 (``trajsde_tpu_torch/csrc/sde_rollout_bwd.cu``) runs all 14
products of the rollout's reverse sweep on the tensor cores
(``csrc/mma_tf32.cuh``): the 4 recomputed forward products (``y @ wf0``,
``h1 @ wf1``, ``y @ wg0``, ``hg1 @ wg1``), the 5 input gradients
(``dY @ W.T``) and the 5 weight gradients (``x.T @ dY``) of wf0, wf1, wf2,
wg0 and wg1.  Each f32 operand x is split into big = rna_tf32(x) and
small = rna_tf32(x - big); per k-step of 8 the TF32 products small * big
and big * small are summed on the tensor cores into one fresh fragment and
big * big into another, two k-steps each, and the two are added to an f32
sum on the CUDA cores, the small terms first (``mma3x2_apart``).  A row
product's sum runs over its 64 columns.  A weight gradient is summed per
block: each block walks 32-row tiles, and for every tile and step adds the
fragments of ``x_tile.T @ dY_tile`` (two, over 32 rows) to its own f32
accumulator, which goes into an f64 sum after each tile; the blocks' sums
are added in f64 in block order.
The diffusion output ``hg2 @ wgo``, its outer product ``dO @ wgo.T`` and
``hg2.T @ dO`` stay on the CUDA cores.

Here the plain reverse sweep (``sde_rollout_bwd_reference``, unedited)
runs under :class:`KernelProducts`, a ``TorchFunctionMode`` that routes
those 14 products through one of ``MODES``:

* ``3xtf32``: the kernel's arithmetic as above, each tensor-core step
  modelled as an H100's tensor cores were measured to sum
  (``scripts/probe_mma_rounding_torch.py``: each addend cut toward zero 2
  bits below the f32 ulp of the largest, the sum rounded toward zero);
* ``3xtf32-mixed``: the three products of a k-step in one fresh fragment,
  as K4 sums them (``mma3x2``);
* ``3xtf32-chained``: one accumulator carried through the tensor cores:
  over a row product's 8 k-steps, and over every tile and step of a block
  for a weight gradient;
* ``1xtf32``: one TF32 product (big * big) summed in f32;
* ``exact``: no TF32 at all: each k-step's products of the f32 operands
  summed exactly and added to the fragment rounded to nearest, as a tensor
  core that took f32 and rounded to nearest would, so only the order of
  the sums differs from the plain version.
* ``f64tc``: the products on the FP64 tensor cores (``csrc/mma_f64.cuh``):
  the f32 operands widened exactly, the products of two k-steps summed in
  f64 in a fresh fragment, rounded to nearest f32 once and added to the
  f32 sum in K2's order.  It differs from ``exact``, which rounds the
  fragment to f32 after each k-step;
* ``f64tc-lambda``: K2's arithmetic: ``f64tc``, and lambda carried in f64.
  Lambda's two input gradients (``dA1 @ wf0.T``, ``dAG1 @ wg0.T``) come
  back as exact f64 products, which the sweep adds to lambda, so lambda
  turns f64 after the first step, as K2 adds their fragments to it as the
  f64 mma's C; ``lambda * dt`` and ``lambda * z`` take lambda rounded to
  f32, as K2's dF and lambda . z do;
* ``f64tc-grads``: ``f64tc`` for the 10 gradient products and ``3xtf32``
  for the 4 recomputed forward products.

The input gradients of lambda's update are returned as products and added
to lambda by the sweep, where the kernel adds their fragments to lambda
one by one.  With one block per tile (N = 64 rows, two 32-row tiles),
T = 60 steps, D = 64, weights, inputs, cotangent and explicit increments
made with numpy as ``tests/test_torch_sde_rollout_bwd.py`` makes them, and
the decoder's time grid, every leaf (dy0 and the 14 weight gradients) is
held against the same sweep in f64, as max|x - f64| / max|f64|, and the
limit is 2x the f32 plain version's distance on the leaf, or 2x the median
of its distances over the 15 leaves where that is larger.  The floor is
there because the plain version lands unusually near f64 on bg1 (4.8e-7
against about 1e-6 on the others): ``exact`` is 3.0x it there, so no
arithmetic that sums in another order meets 2x the leaf's own distance.
``3xtf32`` (at most 1.8x the limit's base) and ``exact`` meet the limit;
``3xtf32-mixed`` (up to 2.7x, on wf2, wg0, wg0t, bg0 and bg1),
``3xtf32-chained`` and ``1xtf32`` do not.  So K2 sums its products apart,
where K4 sums them mixed.

With bgo and bg1 summed in K2's order in f32, ``f64tc-grads`` misses the
limit at seeds 20, 24 and 27 (wg0 3.2x, dy0 3.0x, bgo 4.2x): the 3xTF32
forward recompute alone keeps K2 past the bar, so K2 runs all 14 products
on the FP64 tensor cores.  ``f64tc`` meets the limit at seeds 0 and 20-27
but misses it at seed 11 on bgo (2.8x, 3.1x with ``ys`` from K1): bgo
sums sqrt(dt) (lambda . z) g (1 - g) over every row and step, terms that
cancel, so lambda's own f32 rounding over the 60 steps reaches it.  On an
H100 the kernel with those products read bgo at 7.6x the plain distance
(its bar 4x) at one of the sixteen inputs of
``scripts/check_rollout_bwd_f64_inputs_torch.py`` (seed 25, ``ys`` from
K1).  ``f64tc-lambda`` meets the limit at seeds 0 and 1-30, with ``ys``
from the f32 plain forward and from K1's 3xTF32 forward
(``_case(seed, "k1")``, emulated as
``tests/test_torch_sde_rollout_fwd_tf32.py`` does), so K2 carries lambda
in f64.  :func:`check_inputs` runs the f64 modes on the check script's
own inputs (2,048 rows, its generator and increments).

K2's bias gradients bgo and bg1 are column sums that it keeps per thread:
each lane adds its rows' terms over a tile's 60 steps in an f32 register,
the row lanes and the two m-tile warps are added in f32, and only the
tile's sum goes into f64 (:func:`kernel_bias_sums`).  The runs
``3xtf32+f32-sums`` and ``3xtf32+f64-sums`` take the ``3xtf32`` sweep and
sum its bgo and bg1 in that order, with the accumulators in f32 (the
kernel) and in f64.  Over seeds 0 and 20-27, f64 moves bgo and bg1 by at
most 0.2 of the criterion's base; it changes one verdict, at seed 25,
where bgo reads 2.18 times the base with f32 sums and 1.98 with f64.  At
seeds 20 and 27 both stay past the bar (4.1 and 5.2 times the base on
bgo) and other leaves miss it too (bg0 4.7 at seed 20), where exact
products in the same order meet it: K2's products, not its f32 bias sums,
put it past.

    # each leaf, each mode; then the seed sweeps (default 20-27)
    PYTHONPATH=. python tests/test_torch_sde_rollout_tf32.py [SEED ...]
    # the f64 modes on the check script's inputs (minutes a seed)
    PYTHONPATH=. python tests/test_torch_sde_rollout_tf32.py --check-inputs 25
"""
from __future__ import annotations

import functools
import statistics

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from scripts.probe_mma_rounding_torch import STEPS_PER_FRAGMENT, mm_3xtf32, rna_tf32
from trajsde_tpu_torch.models.sde import decoder_time_grid
from trajsde_tpu_torch.ops import sde_rollout as K

N, T, D = 64, 60, 64
ROWS = K.BWD_TILE_ROWS
ROUTED = ("wf0", "wf1", "wf2", "wg0", "wg1")
# the sweep's weight-gradient products in its order, wgo's (hg2.T @ dO) left out
WGRAD_ORDER = ("wf2", "wf1", "wf0", "wg1", "wg0")
# FP64 tensor cores: all 14 products (K2's), or the 10 gradient products
# with the 4 recomputed forward products left in 3xtf32; their bgo and bg1
# are summed in K2's order with f32 accumulators (kernel_bias_sums)
F64_MODES = ("f64tc", "f64tc-lambda", "f64tc-grads")
MODES = ("3xtf32", "3xtf32-mixed", "3xtf32-chained", "1xtf32", "exact", *F64_MODES)
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
# the sweep's bias column sums (``d.sum(0, keepdim=True)``) in its order per step
BIAS_ORDER = ("bf2", "bf1", "bf0", "bgo", "bg1", "bg0")
# the two that K2 sums in its own order (kernel_bias_sums)
KERNEL_SUMMED = ("bgo", "bg1")
# 3xtf32 with bgo and bg1 summed in K2's order, the accumulators in f32 or f64
SUM_RUNS = {"3xtf32+f32-sums": torch.float32, "3xtf32+f64-sums": torch.float64}
# lambda's two input gradients (dA1 wf0^T, dAG1 wg0^T), which f64tc-lambda
# adds to an f64 lambda unrounded
LAMBDA_PRODUCTS = ("wf0", "wg0")


def _product(mode: str, a: torch.Tensor, b: torch.Tensor, acc=None,
             kind: str = "forward") -> torch.Tensor:
    """acc + a @ b in the mode's arithmetic (f32 in, f32 out) for a product
    of ``kind`` (forward, input-grad or weight-grad); ``f32`` is the plain
    f32 product."""
    if mode == "f64tc-grads":
        mode = "3xtf32" if kind == "forward" else "f64tc"
    if mode == "f64tc-lambda":
        mode = "f64tc"
    if mode == "f32":
        return a @ b if acc is None else acc + a @ b
    if mode == "1xtf32":
        p = rna_tf32(a.contiguous()) @ rna_tf32(b.contiguous())
        return p if acc is None else acc + p
    if mode == "exact":
        acc = torch.zeros((a.shape[0], b.shape[1])) if acc is None else acc
        for k0 in range(0, a.shape[1], 8 * STEPS_PER_FRAGMENT):
            c = torch.zeros_like(acc)
            for k in range(k0, k0 + 8 * STEPS_PER_FRAGMENT, 8):
                c = (c.double() + a[:, k:k + 8].double() @ b[k:k + 8].double()).float()
            acc = acc + c
        return acc
    if mode == "f64tc":
        acc = torch.zeros((a.shape[0], b.shape[1])) if acc is None else acc
        for k0 in range(0, a.shape[1], 8 * STEPS_PER_FRAGMENT):
            k = slice(k0, k0 + 8 * STEPS_PER_FRAGMENT)
            acc = acc + (a[:, k].double() @ b[k].double()).float()
        return acc
    return mm_3xtf32(a.contiguous(), b.contiguous(), mode == "3xtf32-chained", acc,
                     apart=mode == "3xtf32")


class KernelProducts(TorchFunctionMode):
    """Routes the sweep's 14 products through ``mode``.  ``calls`` records
    each routed product as (kind, weight); ``blocks[w][b]`` is block b's
    weight-gradient accumulator (one block per 32-row tile)."""

    def __init__(self, params, mode: str, rows: int):
        super().__init__()
        self.params, self.mode, self.calls = params, mode, []
        self.blocks = {w: [torch.zeros((D, D)) for _ in range(-(-rows // ROWS))] for w in ROUTED}
        self._wgrads = 0
        self.bias_terms = {b: [] for b in KERNEL_SUMMED}   # each step's dO, dAG2
        self._biases = 0

    def _weight(self, b: torch.Tensor):
        """(kind, name) when b is a routed weight (forward) or its transpose."""
        for name in ROUTED:
            w = self.params[name]
            if b is w:
                return "forward", name
            if b._base is w and b.shape == w.shape[::-1] and b.stride() == w.stride()[::-1]:
                return "input-grad", name
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.mul, torch.Tensor.__mul__) and self.mode == "f64tc-lambda" \
                and args[0].dtype == torch.float64:
            # lambda dt and lambda * z: from lambda rounded to f32
            return func(args[0].float(), *args[1:])
        if func is torch.Tensor.sum and args[1:] == (0,) and kwargs == {"keepdim": True}:
            name = BIAS_ORDER[self._biases % len(BIAS_ORDER)]
            self._biases += 1
            if name in self.bias_terms:
                self.bias_terms[name].append(args[0])
            return func(*args, **kwargs)
        if func not in _MATMULS or kwargs or len(args) != 2:
            return func(*args, **kwargs)
        a, b = args
        routed = self._weight(b)
        if routed is not None:
            self.calls.append(routed)
            if self.mode == "f64tc-lambda" and routed[0] == "input-grad" \
                    and routed[1] in LAMBDA_PRODUCTS:
                return a.double() @ b.double()
            return _product(self.mode, a, b, kind=routed[0])
        if a.dim() == 2 and a.shape[0] == D and b.dim() == 2 and b.shape == (a.shape[1], D) \
                and a.stride() == (1, D):
            # x.T @ dY: one block per tile, its fragments added to the block's sum
            name = WGRAD_ORDER[self._wgrads % len(WGRAD_ORDER)]
            self._wgrads += 1
            self.calls.append(("weight-grad", name))
            for i, acc in enumerate(self.blocks[name]):
                rows = slice(ROWS * i, ROWS * (i + 1))
                self.blocks[name][i] = _product(self.mode, a[:, rows], b[rows], acc,
                                                kind="weight-grad")
            return a @ b
        return func(*args, **kwargs)

    def weight_grads(self) -> dict:
        """The routed weight gradients: the blocks' sums added in f64 in
        block order (the kernel adds each tile's to its block's f64 sum)."""
        out = {}
        for name, accs in self.blocks.items():
            s = torch.zeros((D, D), dtype=torch.float64)
            for acc in accs:
                s = s + acc.double()
            out[name] = s.float()
        return out


def _butterfly(x: torch.Tensor, offsets) -> torch.Tensor:
    """``x += shfl_xor(x, off)`` over the row lanes g (the last axis, 8
    long) for each ``off`` in turn, as g ^ off; lane 0's value."""
    g = torch.arange(8)
    for off in offsets:
        x = x + x[..., g ^ off]
    return x[..., 0]


def kernel_bias_sums(terms: dict, acc: torch.dtype) -> dict:
    """bgo [1, 1] and bg1 [1, D] summed in K2's order from each step's dO
    [N, 1] and dAG2 [N, D] (``terms``, in the sweep's step order, t = T - 1
    first).  A warp holds 16 rows of a 32-row tile, row 16 mt + 8 h + g on
    row lane g.  bgo: each lane adds its rows' pair dO[g] + dO[g + 8] to
    its accumulator every step, then the 8 row lanes reduce by shuffles
    (lanes g ^ 1, g ^ 2, g ^ 4).  bg1: every step ``colsum`` adds each
    column's rows g and g + 8 and reduces the 8 row lanes in f32 (g ^ 4,
    g ^ 2, g ^ 1), and the lane adds that to its accumulator.  After the
    tile's T steps the m-tile 0 warp adds the m-tile 1 warp's sum to its
    own, and the tile's value goes into an f64 sum; the tiles (one block
    each) are added in f64 in order.  ``acc`` is the type of the
    accumulators, the shuffles over them and the m-tile exchange; the
    kernel's pair and ``colsum`` stay f32 either way, as do the terms."""
    out = {}
    for name, steps in terms.items():
        x = torch.stack(steps)                                    # [T, N, C] f32
        pad = -x.shape[1] % ROWS
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        x = x.reshape(x.shape[0], -1, 2, 2, 8, x.shape[-1])      # [T, tile, mt, h, g, C]
        x = x.movedim(-1, -2)                                     # [T, tile, mt, h, C, g]
        if name == "bgo":
            a = x[:, :, :, 0].to(acc) + x[:, :, :, 1].to(acc)   # the lane's pair each step
            lane = torch.zeros_like(a[0])
            for step in a:
                lane = lane + step
            warp = _butterfly(lane, (1, 2, 4))
        else:
            cs = _butterfly(x[:, :, :, 0] + x[:, :, :, 1], (4, 2, 1))   # colsum, f32
            warp = torch.zeros(cs.shape[1:], dtype=acc)
            for step in cs:
                warp = warp + step.to(acc)
        tile = (warp[:, 0] + warp[:, 1]).double()                 # [tile, C]
        total = torch.zeros(tile.shape[1:], dtype=torch.float64)
        for v in tile:
            total = total + v
        out[name] = total.float()[None]
    return out


def _case(seed: int = 0, ys_from: str = "plain"):
    """y0, ys, ct, explicit noise, params, t0s, dts; ``ys`` is the f32
    plain forward, or with ``ys_from="k1"`` K1's 3xTF32 forward as
    ``tests/test_torch_sde_rollout_fwd_tf32.py`` emulates it (the states
    that K2 reads in training)."""
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((r.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    p = dict(wf0=f(D, D, sc=0.3), wf0t=f(2, D, sc=0.3), bf0=f(1, D, sc=0.1),
             wf1=f(D, D, sc=0.3), bf1=f(1, D, sc=0.1), wf2=f(D, D, sc=0.3), bf2=f(1, D, sc=0.1),
             wg0=f(D, D, sc=0.3), wg0t=f(2, D, sc=0.3), bg0=f(1, D, sc=0.1),
             wg1=f(D, D, sc=0.3), bg1=f(1, D, sc=0.1), wgo=f(D, 1, sc=0.3), bgo=f(1, 1, sc=0.1))
    y0, noise, ct = f(N, D, sc=0.5), f(T, N, D), f(T, N, D)
    t0s, dts = decoder_time_grid(T, 6.0)
    if ys_from == "k1":
        from test_torch_sde_rollout_fwd_tf32 import KernelProducts as K1Products

        with K1Products(p, "3xtf32"):
            ys = K.sde_rollout_reference(y0, p, t0s, dts, 0, T, noise)
    else:
        ys = K.sde_rollout_reference(y0, p, t0s, dts, 0, T, noise)
    return y0, ys, ct, noise, p, t0s, dts


def _sum_runs(mode: str) -> dict:
    """The runs that sum bgo and bg1 in K2's order, and their accumulators:
    ``SUM_RUNS`` for 3xtf32, and an f64 mode itself in f32, as K2 sums."""
    return SUM_RUNS if mode == "3xtf32" else {mode: torch.float32}


def routed_bwd(mode: str, calls: list | None = None, seed: int = 0, sums: dict | None = None,
               ys_from: str = "plain"):
    """(dy0, grads) of the plain sweep with the 14 products routed; with
    ``sums``, also {run of ``_sum_runs(mode)``: grads with bgo and bg1
    summed in K2's order}."""
    y0, ys, ct, noise, p, t0s, dts = _case(seed, ys_from)
    kp = KernelProducts(p, mode, N)
    with kp:
        dy0, grads = K.sde_rollout_bwd_reference(y0, ys, ct, p, t0s, dts, 0, T, noise)
    dy0 = dy0.float()   # f64tc-lambda's lambda is f64, as K2's
    if calls is not None:
        calls.extend(kp.calls)
    grads = {**grads, **kp.weight_grads()}
    if sums is not None:
        for run, acc in _sum_runs(mode).items():
            sums[run] = dy0, {**grads, **kernel_bias_sums(kp.bias_terms, acc)}
    return dy0, grads


@functools.lru_cache(maxsize=None)
def _oracle_and_plain(seed: int, ys_from: str = "plain"):
    y0, ys, ct, noise, p, t0s, dts = _case(seed, ys_from)
    oracle = K.sde_rollout_bwd_reference(y0.double(), ys.double(), ct.double(),
                                         {k: v.double() for k, v in p.items()}, t0s, dts, 0, T,
                                         noise.double())
    return oracle, K.sde_rollout_bwd_reference(y0, ys, ct, p, t0s, dts, 0, T, noise)


@functools.lru_cache(maxsize=None)
def _routed_runs(seed: int, mode: str, ys_from: str = "plain") -> dict:
    """{mode: (dy0, grads)}, and for 3xtf32 each of ``SUM_RUNS`` too; an
    f64 mode's bgo and bg1 are summed in K2's order in f32."""
    sums = {} if mode in ("3xtf32", *F64_MODES) else None
    runs = {mode: routed_bwd(mode, seed=seed, sums=sums, ys_from=ys_from)}
    return {**runs, **(sums or {})}


def distances(seed: int = 0, modes: tuple = MODES, ys_from: str = "plain") -> dict:
    """leaf -> {plain, each of ``modes`` and, with 3xtf32, each of
    ``SUM_RUNS``}: max|x - f64| / max|f64|, on ``_case(seed, ys_from)``."""
    oracle, plain = _oracle_and_plain(seed, ys_from)
    runs = {"plain": plain}
    for mode in modes:
        runs.update(_routed_runs(seed, mode, ys_from))
    return _leaves(oracle, runs)


def _leaves(oracle, runs: dict) -> dict:
    """leaf -> {run: max|x - f64| / max|f64|} for runs {name: (dy0, grads)}."""
    leaves = {}
    for name in ("dy0", *K.PARAM_ORDER):
        o = oracle[0] if name == "dy0" else oracle[1][name]
        leaves[name] = {}
        for run, (dy0, grads) in runs.items():
            x = dy0 if name == "dy0" else grads[name]
            leaves[name][run] = ((x.double() - o).abs().max() / o.abs().max()).item()
    return leaves


def within_the_f64_criterion(leaves: dict, run: str, floor: bool = True) -> bool:
    """Every leaf within 2x the plain version's distance, floored at the
    median of the plain distances (``floor=False``: the leaf's own)."""
    median = statistics.median(v["plain"] for v in leaves.values()) if floor else 0.0
    return all(v[run] <= 2.0 * max(v["plain"], median) for v in leaves.values())


def test_routing_reaches_exactly_the_fourteen_products_and_keeps_the_forward():
    """Per step: the 4 recomputed products, then the input gradients of wf2,
    wf1 and wg1, the 5 weight gradients, and lambda's two input gradients;
    wgo's three products stay out.  With f32 products the mode gives the
    plain sweep's answer."""
    calls = []
    routed_bwd("3xtf32", calls)
    step = ([("forward", w) for w in ("wf0", "wf1", "wg0", "wg1")]
            + [("input-grad", w) for w in ("wf2", "wf1", "wg1")]
            + [("weight-grad", w) for w in WGRAD_ORDER]
            + [("input-grad", w) for w in ("wf0", "wg0")])
    assert calls == step * T
    y0, ys, ct, noise, p, t0s, dts = _case()
    plain = K.sde_rollout_bwd_reference(y0, ys, ct, p, t0s, dts, 0, T, noise)
    kp = KernelProducts(p, "f32", N)
    with kp:
        got = K.sde_rollout_bwd_reference(y0, ys, ct, p, t0s, dts, 0, T, noise)
    assert torch.equal(got[0], plain[0])
    for k in K.PARAM_ORDER:
        if k not in ROUTED:
            assert torch.equal(got[1][k], plain[1][k]), k
    for k, g in kp.weight_grads().items():   # the same sums over rows, in other groups
        assert ((g - plain[1][k]).abs().max() / plain[1][k].abs().max()).item() < 1e-5, k
    # each step's dO and dAG2 captured once; summed in K2's order, the plain sums
    assert [len(v) for v in kp.bias_terms.values()] == [T] * len(KERNEL_SUMMED)
    for k, g in kernel_bias_sums(kp.bias_terms, torch.float64).items():
        assert ((g - plain[1][k]).abs().max() / plain[1][k].abs().max()).item() < 1e-5, k


def test_3xtf32_reverse_sweep_is_within_the_f64_criterion():
    leaves = distances()
    assert within_the_f64_criterion(leaves, "3xtf32"), leaves


def test_exact_products_need_the_floor():
    """Exact products summed in the kernel's order meet the limit, and miss
    2x the plain version's own distance on some leaf: the floor."""
    leaves = distances()
    assert within_the_f64_criterion(leaves, "exact"), leaves
    assert not within_the_f64_criterion(leaves, "exact", floor=False), leaves


@pytest.mark.parametrize("mode", ["3xtf32-mixed", "3xtf32-chained", "1xtf32"])
def test_other_arithmetic_breaks_the_f64_criterion(mode):
    """The criterion tells the kernel's arithmetic from one TF32 product
    (2^-11 per operand) and from one tensor-core accumulator carried over a
    whole sum (its sums cut and rounded toward zero, over and over)."""
    leaves = distances()
    assert not within_the_f64_criterion(leaves, mode), leaves


def _ratios(leaves: dict, run: str) -> dict:
    """leaf -> the run's distance over the criterion's base (2 is the bar)."""
    median = statistics.median(v["plain"] for v in leaves.values())
    return {name: v[run] / max(v["plain"], median) for name, v in leaves.items()}


@pytest.mark.parametrize("seed", [0, 20, 27])
def test_k2_bias_accumulators_in_f64_move_bgo_and_bg1_little(seed):
    """bgo and bg1 summed in K2's order (per lane over a tile's steps, the
    row lanes by shuffles, the two m-tiles, then f64 per tile): at these
    seeds f64 accumulators instead of f32 move each reading by at most a
    quarter of the criterion's base and change no verdict."""
    leaves = distances(seed, ("3xtf32",))
    f32, f64 = _ratios(leaves, "3xtf32+f32-sums"), _ratios(leaves, "3xtf32+f64-sums")
    for name in KERNEL_SUMMED:
        assert abs(f64[name] - f32[name]) <= 0.25, (name, f32[name], f64[name])
    assert (within_the_f64_criterion(leaves, "3xtf32+f32-sums")
            == within_the_f64_criterion(leaves, "3xtf32+f64-sums")
            == within_the_f64_criterion(leaves, "3xtf32")), leaves


@pytest.mark.parametrize("seed", [20, 27])
def test_k2_misses_the_f64_criterion_by_its_products_not_its_bias_sums(seed):
    """At seeds where the 3xTF32 sweep misses the criterion on bgo, summing
    bgo and bg1 in f64 leaves both past the bar; exact products summed in
    the kernel's order meet it on every leaf.  So the f32 accumulators of
    K2's bias sums are not what puts it past the bar: its products are."""
    leaves = distances(seed, ("3xtf32", "exact"))
    f64 = _ratios(leaves, "3xtf32+f64-sums")
    assert all(f64[name] > 2.0 for name in KERNEL_SUMMED), f64
    assert not within_the_f64_criterion(leaves, "3xtf32+f64-sums"), leaves
    assert within_the_f64_criterion(leaves, "exact"), leaves



@pytest.mark.parametrize("seed", [0, 20, 27])
def test_k2_f64_products_meet_the_f64_criterion(seed):
    """K2's routing: the 14 products on the FP64 tensor cores, bgo and bg1
    summed in K2's order in f32, within the limit on every leaf."""
    leaves = distances(seed, ("f64tc",))
    assert within_the_f64_criterion(leaves, "f64tc"), leaves


@pytest.mark.parametrize("seed", [20, 27])
def test_f64_gradient_products_alone_miss_the_f64_criterion(seed):
    """The cheaper routing, f64 for the 10 gradient products and 3xTF32 for
    the 4 recomputed forward products, misses the limit here: so K2 takes
    f64 for all 14."""
    leaves = distances(seed, ("f64tc-grads",))
    assert not within_the_f64_criterion(leaves, "f64tc-grads"), leaves

@pytest.mark.parametrize("seed", [0, 20, 27])
def test_k2_f64_lambda_meets_the_f64_criterion(seed):
    """K2's arithmetic: the 14 products on the FP64 tensor cores and lambda
    carried in f64 (its two input gradients added unrounded, read rounded
    to f32), bgo and bg1 summed in K2's order in f32: within the limit on
    every leaf, with ys from the f32 plain forward and from K1's 3xTF32
    forward (the states K2 reads in training)."""
    for ys_from in ("plain", "k1"):
        leaves = distances(seed, ("f64tc-lambda",), ys_from)
        assert within_the_f64_criterion(leaves, "f64tc-lambda"), (ys_from, leaves)


@pytest.mark.parametrize("ys_from", ["plain", "k1"])
def test_f32_lambda_puts_bgo_past_the_f64_criterion(ys_from):
    """At seed 11 f64 products with lambda kept in f32 put bgo past the bar,
    and lambda carried in f64 brings every leaf within it.  bgo sums
    sqrt(dt) (lambda . z) g (1 - g) over every row and step, terms that
    cancel, so lambda's own f32 rounding over the 60 steps reaches it."""
    leaves = distances(11, ("f64tc", "f64tc-lambda"), ys_from)
    assert _ratios(leaves, "f64tc")["bgo"] > 2.0, leaves
    assert within_the_f64_criterion(leaves, "f64tc-lambda"), leaves


def check_inputs(seed: int, rows: int = 2048, modes: tuple = ("f64tc", "f64tc-lambda")) -> dict:
    """ys source -> the leaves of :func:`distances` on the inputs of
    ``scripts/check_rollout_bwd_f64_inputs_torch.py`` and of the ``gpu``
    test of K2 against f64 at ``seed``: ``rows`` x 60 steps, weights, y0
    and the cotangent from a ``torch.Generator``, increments regenerated
    (gaussian, key 42), ``ys`` from the f32 plain forward and from the
    emulated 3xTF32 K1; each mode's bgo and bg1 summed in K2's order in
    f32.  A few minutes a source at 2,048 rows."""
    from test_torch_sde_rollout_fwd_tf32 import KernelProducts as K1Products
    from trajsde_tpu_torch.models.sde import SDEStep

    gen = torch.Generator().manual_seed(seed)
    step = SDEStep(D)
    for prm in step.parameters():
        prm.data = torch.randn(prm.shape, generator=gen) * 0.2
    p = {k: v.contiguous() for k, v in K.rollout_params_from_module(step).items()}
    t0s, dts = decoder_time_grid(T, 6.0)
    y0 = torch.randn((rows, D), generator=gen)
    ct = torch.randn((T, rows, D), generator=gen)
    ys = {"plain": K.sde_rollout_reference(y0, p, t0s, dts, 42, T)}
    with K1Products(p, "3xtf32"):
        ys["k1"] = K.sde_rollout_reference(y0, p, t0s, dts, 42, T)
    out = {}
    for source, y in ys.items():
        oracle = K.sde_rollout_bwd_reference(y0.double(), y.double(), ct.double(),
                                             {k: v.double() for k, v in p.items()}, t0s, dts,
                                             42, T)
        runs = {"plain": K.sde_rollout_bwd_reference(y0, y, ct, p, t0s, dts, 42, T)}
        for mode in modes:
            kp = KernelProducts(p, mode, rows)
            with kp:
                dy0, grads = K.sde_rollout_bwd_reference(y0, y, ct, p, t0s, dts, 42, T)
            runs[mode] = dy0.float(), {**grads, **kp.weight_grads(),
                                       **kernel_bias_sums(kp.bias_terms, torch.float32)}
        out[source] = _leaves(oracle, runs)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="K2's arithmetic emulated: each leaf's distance "
                                 "from f64, then the seed sweeps")
    ap.add_argument("seeds", type=int, nargs="*", default=list(range(20, 28)))
    ap.add_argument("--check-inputs", type=int, nargs="+", default=[], metavar="SEED",
                    help="only the f64 modes on the check script's inputs (2,048 rows)")
    args = ap.parse_args()
    for seed in args.check_inputs:
        for source, leaves in check_inputs(seed).items():
            median = statistics.median(v["plain"] for v in leaves.values())
            print(f"check inputs, seed {seed}, ys from {source}: plain bgo "
                  f"{leaves['bgo']['plain']:.3e}, median {median:.3e}; " + "; ".join(
                      f"{m} bgo {leaves['bgo'][m]:.3e}, ratios " + " ".join(
                          f"{k} {v:.2f}" for k, v in _ratios(leaves, m).items())
                      for m in ("f64tc", "f64tc-lambda")), flush=True)
    if args.check_inputs:
        raise SystemExit(0)
    runs = ("plain", *MODES, *SUM_RUNS)
    leaves = distances()
    print(f"N {N}, T {T}, D {D}, {ROWS}-row tiles: max|x - f64| / max|f64| "
          f"({', '.join(runs)}); within the criterion: "
          + ", ".join(f"{m} {within_the_f64_criterion(leaves, m)}" for m in (*MODES, *SUM_RUNS)))
    for name, v in leaves.items():
        print(f"  {name:5s} " + " ".join(f"{v[m]:.3e}" for m in runs))
    # the seed sweep: bgo and bg1 over the criterion's base, summed in the
    # plain order, then in K2's with f32 and with f64 accumulators
    seeds = args.seeds
    for seed in seeds:
        leaves = distances(seed, ("3xtf32",))
        r = {run: _ratios(leaves, run) for run in ("3xtf32", *SUM_RUNS)}
        worst = {run: max(x, key=x.get) for run, x in r.items()}
        print(f"seed {seed}: " + "; ".join(
            f"{run} bgo {x['bgo']:.2f} bg1 {x['bg1']:.2f} worst {worst[run]} "
            f"{x[worst[run]]:.2f}" for run, x in r.items()))
    # the f64 modes over seed 0 and the sweep, ys from the plain forward and
    # from the emulated K1: each mode's worst leaf over the criterion's base
    for seed in (0, *seeds):
        for source in ("plain", "k1"):
            leaves = distances(seed, F64_MODES, source)
            r = {m: _ratios(leaves, m) for m in F64_MODES}
            print(f"seed {seed}, ys from {source}: " + "; ".join(
                f"{m} {within_the_f64_criterion(leaves, m)}, bgo {x['bgo']:.2f}, worst "
                f"{max(x, key=x.get)} {max(x.values()):.2f}" for m, x in r.items()), flush=True)
