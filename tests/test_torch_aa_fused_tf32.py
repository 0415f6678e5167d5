"""K4's backward products in 3xTF32, emulated on the CPU.

Kernel K4 (``trajsde_tpu_torch/csrc/aa_fused_bwd.cu``) runs the input and
weight gradients of the pair chain's three products (``a0 @ w1``,
``a1 @ wagg``, ``nbr @ wkv`` in ``ops/aa_fused.py``) on the tensor cores
(``csrc/mma_tf32.cuh``): each f32 operand x is split into
big = rna_tf32(x) and small = rna_tf32(x - big); per k-step of 8 the three
TF32 products small * big, big * small and big * big are summed on the
tensor cores, two k-steps into one fresh fragment, which is added to the
running f32 sum on the CUDA cores.  Its weight gradients are summed in f32
over a receiver group's pairs, then in f64 over groups.  Its forward
recompute stays in f32.

Here the plain chain (``fused_pair_attention_reference``, unedited) gets
stand-ins for ``w1``, ``wagg`` and ``wkv`` whose ``__torch_function__``
routes ``x @ w`` through :class:`TF32Product`: the exact f32 product
forward, and ``dY W^T`` and ``X^T dY`` backward by one of ``PRODUCTS``:

* ``3xtf32``: the kernel's arithmetic as above.  Each tensor-core step is
  modelled as an H100's tensor cores were measured to sum
  (``scripts/probe_mma_rounding_torch.py``): the exact products of TF32
  values and C, each cut toward zero 2 bits below the f32 ulp of the
  largest, summed, and the sum rounded toward zero to f32.  The input
  gradient of ``a0 @ w1`` runs over
  ``dz1 = [dz | dz]`` and w1 (K = 128), where the kernel folds w1's two
  halves first (K = 64).
* ``3xtf32-chained``: the same, but one accumulator carried through the
  tensor cores over all k-steps (a group's 384 pairs for a weight
  gradient), as a first build of the kernel did; it failed the f64 test on
  an H100.
* ``1xtf32``: one TF32 product (big * big), summed in f32.
* ``3xtf32-recompute``: ``3xtf32``, with the forward (K4's recompute,
  which is K3's arithmetic) also in 3xTF32: two k-steps per fresh
  fragment, the small terms and big * big apart (``mma3x2_apart``), and
  ``a0 @ w1`` taken with w1's two column halves folded into one [2D, D]
  weight, returned beside zeros (the chain then adds b1 per half, where the
  kernel adds the folded b1 once: one f32 rounding apart), and the head
  logits in K3's order (``_torch_helpers.kernel_head_logits``).

At (B, T, Aq, Ak) = (2, 3, 9, 48), D 64, at the flagship's 8 heads and
the HiVT baseline's 4, with a keep mask, the gradients are held against
the plain backward in f64 by the criterion of
``tests/test_torch_cuda.py::test_aa_fused_bwd_kernel_within_the_f64_gradient``,
as a fraction of max|f64| per leaf: the leaves behind a ReLU's derivative
(wu .. lna0b) within 2e-3; dq and the others no more than 2x the f32 plain
version's distance plus 1e-7.  ``3xtf32`` and ``3xtf32-recompute`` meet
it; ``3xtf32-chained`` and ``1xtf32`` do not.

    PYTHONPATH=. python tests/test_torch_aa_fused_tf32.py   # every leaf's distance, each mode
"""
from __future__ import annotations

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from scripts import probe_mma_rounding_torch as probe
from _torch_helpers import kernel_head_logits, packed_aa_weights, torch_threads
from scripts.probe_mma_rounding_torch import mm_3xtf32, mma_step, rna_tf32, rz_f32, split
from trajsde_tpu_torch.ops import aa_fused as K3

SHAPE, D, P_DROP = (2, 3, 9, 48), 64, 0.1
GROUP_PAIRS = 8 * SHAPE[3]            # K4's receiver group: 8 receivers with all senders
ROUTED = ("w1", "wagg", "wkv")
BEHIND_RELU = K3.W_ORDER[:K3.W_ORDER.index("wagg")]


def _per_group(mm, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x^T dy [M, N] over pairs: ``mm`` in f32 within each receiver group
    (the last one padded with zero pairs), then f64 over the groups."""
    total = torch.zeros((x.shape[1], dy.shape[1]), dtype=torch.float64)
    for p0 in range(0, x.shape[0], GROUP_PAIRS):
        xg, yg = x[p0:p0 + GROUP_PAIRS], dy[p0:p0 + GROUP_PAIRS]
        pad = (-xg.shape[0]) % 32                   # K4's chunk of 32 pairs
        xg = torch.cat([xg, xg.new_zeros((pad, xg.shape[1]))])
        yg = torch.cat([yg, yg.new_zeros((pad, yg.shape[1]))])
        total += mm(xg.t(), yg).double()
    return total.float()


PRODUCTS = {  # mode -> (input gradient dy w^T, weight gradient x^T dy)
    "3xtf32": (lambda dy, w: mm_3xtf32(dy, w.t(), False),
               lambda x, dy: _per_group(functools.partial(mm_3xtf32, chained=False), x, dy)),
    "3xtf32-chained": (lambda dy, w: mm_3xtf32(dy, w.t(), True),
                       lambda x, dy: _per_group(functools.partial(mm_3xtf32, chained=True),
                                                x, dy)),
    "1xtf32": (lambda dy, w: rna_tf32(dy) @ rna_tf32(w).t(),
               lambda x, dy: _per_group(lambda a, b: rna_tf32(a) @ rna_tf32(b), x, dy)),
}
PRODUCTS["3xtf32-recompute"] = PRODUCTS["3xtf32"]


def _forward(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """``x @ w`` in f32, or as K3 and K4's recompute take it for
    ``3xtf32-recompute`` (w1 [2D, 2D] folded, its product beside zeros)."""
    if mode != "3xtf32-recompute":
        return x @ w
    if w.shape == (2 * D, 2 * D):
        y = mm_3xtf32(x, w[:, :D] + w[:, D:], False, apart=True)
        return torch.cat([y, torch.zeros_like(y)], 1)
    return mm_3xtf32(x, w, False, apart=True)


class TF32Product(torch.autograd.Function):
    """``x @ w``: the f32 product forward (or :func:`_forward`'s); backward
    ``dY w^T`` and ``x^T dY`` by ``PRODUCTS[mode]``."""

    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        return _forward(x, w, mode)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        input_grad, weight_grad = PRODUCTS[ctx.mode]
        return input_grad(dy, w), weight_grad(x, dy), None


class Routed:
    """Stands in for a weight of the plain chain: ``x @ self`` runs through
    :class:`TF32Product`; any other use raises."""

    def __init__(self, w: torch.Tensor, mode: str, calls: list):
        self.w, self.mode, self.calls = w, mode, calls

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__") and not kwargs \
                and len(args) == 2 and isinstance(args[1], cls) \
                and isinstance(args[0], torch.Tensor):
            x, r = args
            r.calls.append(tuple(x.shape))
            return TF32Product.apply(x, r.w, r.mode)
        raise TypeError(f"a routed weight is used only as the right operand of @, not in {func}")


def _case(dense: bool, H: int, seed: int = 7):
    """Inputs of one backward: q, u, the mask (a receiver with no sender),
    the keep mask, the weights and a cotangent, from numpy."""
    r = np.random.default_rng(seed)
    B, T, Aq, Ak = SHAPE
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    q = f32(r.standard_normal((B, T, Aq, D)))
    u = f32(5.0 * r.standard_normal((B, T, Aq, Ak, 4)))
    mask = r.uniform(size=(B, T, Aq, Ak)) < 0.6
    mask[0, 0, 0] = False
    keep = f32(r.uniform(size=(B, T, Aq, Ak, H)) >= P_DROP)
    g = f32(r.standard_normal((B, T, Aq, D)))
    return q, u, f32(mask), keep, packed_aa_weights(r, dense), g


def routed_bwd(q, u, mask, keep, ws, g, mode: str, calls: list, H: int = 8):
    """(dq, dws) of the plain chain with w1, wagg and wkv routed; for
    ``3xtf32-recompute`` also the head logits in K3's order."""
    logits = (mock.patch.object(K3, "_head_logits", kernel_head_logits)
              if mode == "3xtf32-recompute" else contextlib.nullcontext())
    with torch.enable_grad(), logits:
        qd = q.clone().requires_grad_()
        wd = [w.clone().requires_grad_() for w in ws]
        chain = [Routed(w, mode, calls) if k in ROUTED else w for k, w in zip(K3.W_ORDER, wd)]
        out = K3.fused_pair_attention_reference(qd, u, mask, keep, chain, H, P_DROP)
        grads = torch.autograd.grad(out, [qd, *wd], g)
    return grads[0], tuple(grads[1:])


@functools.lru_cache(maxsize=None)
def distances(dense: bool, H: int = 8) -> dict:
    """leaf -> {plain, and each mode of PRODUCTS}: max|x - f64| / max|f64|."""
    q, u, mask, keep, ws, g = _case(dense, H)
    with torch_threads(2):
        oracle = K3.fused_pair_attention_bwd_reference(
            q.double(), u.double(), mask.double(), keep.double(), [w.double() for w in ws],
            g.double(), H, P_DROP)
        runs = {"plain": K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H,
                                                               P_DROP)}
        for mode in PRODUCTS:
            runs[mode] = routed_bwd(q, u, mask, keep, ws, g, mode, [], H)
    leaves = {}
    for i, name in enumerate(("dq", *K3.W_ORDER)):
        o = oracle[0] if i == 0 else oracle[1][i - 1]
        leaves[name] = {}
        for run, (dq, dws) in runs.items():
            x = dq if i == 0 else dws[i - 1]
            leaves[name][run] = ((x.double() - o).abs().max() / o.abs().max()).item()
    return leaves


def within_the_f64_criterion(leaves: dict, run: str) -> bool:
    return all(v[run] < 2e-3 if name in BEHIND_RELU else v[run] <= 2.0 * v["plain"] + 1e-7
               for name, v in leaves.items())


def test_rna_rounds_to_nearest_ties_away_and_clears_13_bits():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's spacing above 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3, -7.5e4], dtype=torch.float32)
    got = rna_tf32(x)
    assert got[:5].tolist() == [one, one + ulp, -(one + ulp), one, one + 2 * ulp]
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert bool(((got - x).abs() <= x.abs() * 2.0 ** -11).all())


def test_split_recombines_within_2_to_minus_22():
    r = np.random.default_rng(3)
    x = torch.from_numpy((r.standard_normal(200_000) * 10.0 ** r.uniform(-6, 6, 200_000))
                         .astype(np.float32))
    big, small = split(x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    err = ((big.double() + small.double()) - x.double()).abs() / x.double().abs()
    assert err.max().item() <= 2.0 ** -22


def test_emulated_product_is_f32_accurate_and_rounds_toward_zero():
    """The kernel's 3xTF32 product of two random f32 matrices: within a few
    f32 roundings of f64; a tensor-core step rounds toward zero."""
    r = np.random.default_rng(5)
    a = torch.from_numpy(r.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((128, 32)).astype(np.float32))
    exact = a.double() @ b.double()
    err = (mm_3xtf32(a, b, False).double() - exact).abs().max() / exact.abs().max()
    assert err.item() < 2e-6
    assert ((rna_tf32(a) @ rna_tf32(b)).double() - exact).abs().max() / exact.abs().max() > 1e-4
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30)], dtype=torch.float64)
    assert rz_f32(x).tolist() == [1.0, -1.0]


def test_emulated_step_sums_as_the_probe_measured_the_tensor_cores():
    """``mma_step`` gives, on the rounding probe's 128 cases and on random TF32
    tiles, what the probe's model (which an H100 matched on every case)
    gives."""
    a, b, c, _ = probe.cases()
    got = mma_step(torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(b))
    assert got.double().numpy().tolist() == probe.model(a, b, c).tolist()
    r = np.random.default_rng(11)
    a = rna_tf32(torch.from_numpy((r.standard_normal((16, 8)) * 10.0 ** r.uniform(-3, 3, (16, 8)))
                                  .astype(np.float32)))
    b = rna_tf32(torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32)))
    c = torch.from_numpy(r.standard_normal((16, 8)).astype(np.float32))
    got = mma_step(c, a, b)
    assert got.double().numpy().tolist() == probe.model(a.numpy(), b.numpy(), c.numpy()).tolist()


def test_routing_reaches_exactly_the_three_products_and_keeps_the_forward():
    H = 8
    q, u, mask, keep, ws, g = _case(dense=True, H=H)
    calls = []
    chain = [Routed(w, "3xtf32", calls) if k in ROUTED else w for k, w in zip(K3.W_ORDER, ws)]
    got = K3.fused_pair_attention_reference(q, u, mask, keep, chain, H, P_DROP)
    pairs = int(np.prod(SHAPE))
    assert calls == [(pairs, 2 * D), (pairs, D), (pairs, D)]
    assert torch.equal(got, K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, P_DROP))


# (dense weights, heads): the flagship's 8 heads, then the baseline's 4
CASES = [pytest.param(dense, h, id=("dense" if dense else "block-diagonal")
                      + ("" if h == 8 else f"-{h}-heads"))
         for h in (8, 4) for dense in (False, True)]


@pytest.mark.parametrize("dense,H", CASES)
def test_3xtf32_backward_is_within_the_f64_criterion(dense, H):
    leaves = distances(dense, H)
    assert within_the_f64_criterion(leaves, "3xtf32"), leaves


@pytest.mark.parametrize("dense,H", CASES)
def test_3xtf32_backward_with_the_recompute_on_the_tensor_cores_is_within_the_f64_criterion(
        dense, H):
    """K4 with its recompute (F2-F4) in K3's 3xTF32 arithmetic, w1 folded:
    the logits, LayerNorm statistics and activations its backward reads
    are K3's, and the gradients still meet the f64 criterion."""
    leaves = distances(dense, H)
    assert within_the_f64_criterion(leaves, "3xtf32-recompute"), leaves


@pytest.mark.parametrize("mode", ["3xtf32-chained", "1xtf32"])
@pytest.mark.parametrize("dense,H", CASES)
def test_other_arithmetic_breaks_the_f64_criterion(dense, H, mode):
    """The criterion tells the kernel's arithmetic from one TF32 product
    (2^-11 per operand) and from one tensor-core accumulator carried over
    a whole sum (its sums cut and rounded toward zero, over and over)."""
    leaves = distances(dense, H)
    assert not within_the_f64_criterion(leaves, mode), leaves


if __name__ == "__main__":
    runs = ("plain", *PRODUCTS)
    for dense, H in (c.values for c in CASES):
        leaves = distances(dense, H)
        print(f"{'dense' if dense else 'block-diagonal'} weights, {SHAPE} D {D} H {H}, keep "
              f"p={P_DROP}: max|x - f64| / max|f64| ({', '.join(runs)}); within the criterion: "
              + ", ".join(f"{m} {within_the_f64_criterion(leaves, m)}" for m in PRODUCTS))
        for name, v in leaves.items():
            print(f"  {name:6s} " + " ".join(f"{v[m]:.3e}" for m in runs))
