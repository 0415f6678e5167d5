"""K3's forward products in 3xTF32, emulated on the CPU.

Kernel K3 (``trajsde_tpu_torch/csrc/aa_fused.cu``) runs the pair chain's
three products on the tensor cores (``csrc/mma_tf32.cuh``):
``a0 @ w1`` with w1's two column halves folded into one [2D, D] weight
(``w1f = w1[:, :D] + w1[:, D:]``, ``b1f = b1[:D] + b1[D:]``, so the
product is ``a0 @ w1f + b1f``, K = 128), ``a1 @ wagg`` (K = 64) and
``nbr @ wkv`` (K = 64).  Each f32 operand x is split into
big = rna_tf32(x) and small = rna_tf32(x - big); per k-step of 8 the TF32
products small * big and big * small are summed on the tensor cores into
one fresh fragment and big * big into another, two k-steps each, and the
two are added to an f32 sum on the CUDA cores, the small terms first
(``mma3x2_apart``).  Each tensor-core step is modelled as an H100's tensor
cores were measured to sum (``scripts/probe_mma_rounding_torch.py``: each
addend cut toward zero 2 bits below the f32 ulp of the largest, the sum
rounded toward zero).  The first layer, the LayerNorms, the head dot
products and the softmax stay in f32.  The head dot products are taken
in the kernel's order (``aa_common.cuh``'s ``head_logit``, modelled by
``_torch_helpers.kernel_head_logits``): per lane of 4 columns a product
and three FMAs, the lanes of a head summed by a butterfly (2 lanes at 8
heads, 4 at 4: (l0 + l1) + (l2 + l3)), then times 1/sqrt(hd).

Here the plain chain (``fused_pair_attention_reference``, unedited) gets
stand-ins for ``w1``, ``wagg`` and ``wkv`` whose ``__torch_function__``
routes ``x @ w`` through one of ``MODES``; the stand-in for ``w1`` computes
``a0 @ w1f`` and returns it beside zeros, and ``b1`` is handed over as
``[b1f | 0]``, so the chain's ``z1[:, :D] + z1[:, D:]`` is the kernel's
``a0 @ w1f + b1f``:

* ``3xtf32``: the kernel's arithmetic as above;
* ``3xtf32-mixed``: the three products of a k-step in one fresh fragment
  (``mma3x2``);
* ``1xtf32``: one TF32 product (big * big), summed in f32;
* ``f32-folded``: f32 products of the folded weight, no TF32.

At (B, T, Aq, Ak) = (2, 3, 9, 48), D 64, at the flagship's 8 heads and
the HiVT baseline's 4, for the model's block-diagonal w1 and a dense one,
with and without a keep mask, ``out`` is held against the plain chain in
f64, per head, as max|x - f64| over the head's columns / max|f64| over
all of ``out``.  The limit is 2x the f32 plain version's distance on the
head, floored at the median of its distances over the heads (as K2's
test floors its leaves).  ``3xtf32`` meets it; ``1xtf32`` does not.

    PYTHONPATH=. python tests/test_torch_aa_fused_fwd_tf32.py   # every head's distance, each mode
"""
from __future__ import annotations

import functools
import statistics
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_helpers import kernel_head_logits, packed_aa_weights, torch_threads
from scripts.probe_mma_rounding_torch import mm_3xtf32, rna_tf32
from trajsde_tpu_torch.ops import aa_fused as K3

SHAPE, D, P_DROP = (2, 3, 9, 48), 64, 0.1
ROUTED = ("w1", "wagg", "wkv")
MODES = {
    "3xtf32": lambda x, w: mm_3xtf32(x, w, False, apart=True),
    "3xtf32-mixed": lambda x, w: mm_3xtf32(x, w, False),
    "1xtf32": lambda x, w: rna_tf32(x) @ rna_tf32(w),
    "f32-folded": lambda x, w: x @ w,
}


class Routed:
    """Stands in for a weight of the plain chain: ``x @ self`` is
    ``MODES[mode](x, w)``, beside zeros as wide as ``pad``; any other use
    raises."""

    def __init__(self, w: torch.Tensor, mode: str, pad: int, calls: list):
        self.w, self.mode, self.pad, self.calls = w, mode, pad, calls

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__") and not kwargs \
                and len(args) == 2 and isinstance(args[1], cls) \
                and isinstance(args[0], torch.Tensor):
            x, r = args
            r.calls.append((tuple(x.shape), tuple(r.w.shape)))
            y = MODES[r.mode](x, r.w)
            return torch.cat([y, y.new_zeros((y.shape[0], r.pad))], 1) if r.pad else y
        raise TypeError(f"a routed weight is used only as the right operand of @, not in {func}")


def _case(dense: bool, with_keep: bool, H: int, seed: int = 7):
    """Inputs of one forward: q, u, the mask (a receiver with no sender),
    the keep mask or None and the weights, from numpy."""
    r = np.random.default_rng(seed)
    B, T, Aq, Ak = SHAPE
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    q = f32(r.standard_normal((B, T, Aq, D)))
    u = f32(5.0 * r.standard_normal((B, T, Aq, Ak, 4)))
    mask = r.uniform(size=(B, T, Aq, Ak)) < 0.6
    mask[0, 0, 0] = False
    keep = f32(r.uniform(size=(B, T, Aq, Ak, H)) >= P_DROP)
    return q, u, f32(mask), keep if with_keep else None, packed_aa_weights(r, dense)


def routed_chain(ws, mode: str, calls: list) -> list:
    """The 14 weights with w1, wagg and wkv routed through ``MODES[mode]``,
    w1 folded (and b1 handed over as ``[b1f | 0]``)."""
    w = dict(zip(K3.W_ORDER, ws))
    w1f, b1f = w["w1"][:, :D] + w["w1"][:, D:], w["b1"][:, :D] + w["b1"][:, D:]
    w["b1"] = torch.cat([b1f, torch.zeros_like(b1f)], 1)
    w["w1"] = Routed(w1f, mode, D, calls)
    w["wagg"] = Routed(w["wagg"], mode, 0, calls)
    w["wkv"] = Routed(w["wkv"], mode, 0, calls)
    return [w[k] for k in K3.W_ORDER]


def per_head(x: torch.Tensor, oracle: torch.Tensor, H: int) -> list:
    """max|x - f64| over each head's columns / max|f64| over all of out."""
    err = (x.double() - oracle).abs().reshape(-1, H, D // H)
    return (err.amax(dim=(0, 2)) / oracle.abs().max()).tolist()


@functools.lru_cache(maxsize=None)
def distances(dense: bool, with_keep: bool, H: int = 8) -> dict:
    """run -> per-head distances from f64, for plain and each mode (the
    modes with the head logits in the kernel's order)."""
    q, u, mask, keep, ws = _case(dense, with_keep, H)
    p = P_DROP if with_keep else 0.0
    d = lambda x: None if x is None else x.double()  # noqa: E731
    with torch_threads(2):
        oracle = K3.fused_pair_attention_reference(d(q), d(u), d(mask), d(keep),
                                                   [w.double() for w in ws], H, p)
        runs = {"plain": K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p)}
        with mock.patch.object(K3, "_head_logits", kernel_head_logits):
            for mode in MODES:
                runs[mode] = K3.fused_pair_attention_reference(q, u, mask, keep,
                                                               routed_chain(ws, mode, []), H, p)
    return {run: per_head(x, oracle, H) for run, x in runs.items()}


def limits(dist: dict) -> list:
    """2x the plain distance per head, floored at its median over heads."""
    median = statistics.median(dist["plain"])
    return [2.0 * max(v, median) for v in dist["plain"]]


def within_the_limit(dist: dict, run: str) -> bool:
    return all(x <= lim for x, lim in zip(dist[run], limits(dist)))


# (dense w1, keep, heads): the flagship's 8 heads, then the baseline's 4
CASES = [pytest.param(dense, keep, h, id=f"{'dense' if dense else 'block-diagonal'}-"
                      f"{'keep' if keep else 'no-keep'}" + ("" if h == 8 else f"-{h}-heads"))
         for h in (8, 4) for dense in (False, True) for keep in (False, True)]


def test_routing_reaches_the_three_products_with_w1_folded_and_keeps_the_function():
    """The stand-ins see a0 @ w1f [2D, D], a1 @ wagg and nbr @ wkv; in f32
    the folded chain agrees with the plain one to f32 rounding, and for
    the model's block-diagonal w1 the fold adds zeros only, so its weight
    is exact."""
    H = 8
    q, u, mask, keep, ws = _case(dense=False, with_keep=True, H=H)
    calls = []
    chain = routed_chain(ws, "f32-folded", calls)
    got = K3.fused_pair_attention_reference(q, u, mask, keep, chain, H, P_DROP)
    pairs = int(np.prod(SHAPE))
    assert calls == [((pairs, 2 * D), (2 * D, D)), ((pairs, D), (D, D)), ((pairs, D), (D, 2 * D))]
    w1 = ws[K3.W_ORDER.index("w1")]
    assert torch.equal(w1[:, :D] + w1[:, D:], torch.cat([w1[:D, :D], w1[D:, D:]]))
    want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, P_DROP)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5


@pytest.mark.parametrize("H", [8, 4])
def test_kernel_order_head_logits_are_the_plain_ones_to_f32_rounding(H):
    """The model of head_logit's order gives the plain logits to within a
    few f32 roundings of a head's |q| |k|."""
    r = np.random.default_rng(9)
    qh = torch.from_numpy(r.standard_normal((50, 1, H, D // H)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((50, 7, H, D // H)).astype(np.float32))
    got, want = kernel_head_logits(qh, k), K3._head_logits(qh, k)
    bound = (qh.abs() * k.abs()).sum(-1) * (1.0 / (D // H) ** 0.5) * 4 * 2.0 ** -24 * (D // H)
    assert got.shape == want.shape == (50, 7, H)
    assert bool(((got - want).abs() <= bound).all())
    assert not torch.equal(got, want)   # another order: some logits differ in their last bits


@pytest.mark.parametrize("dense,with_keep,H", CASES)
def test_3xtf32_forward_is_within_twice_the_plain_distance_from_f64(dense, with_keep, H):
    dist = distances(dense, with_keep, H)
    assert within_the_limit(dist, "3xtf32"), dist


@pytest.mark.parametrize("dense,with_keep,H", CASES)
def test_one_tf32_product_breaks_the_limit(dense, with_keep, H):
    """The limit tells the kernel's arithmetic from one TF32 product
    (2^-11 per operand)."""
    dist = distances(dense, with_keep, H)
    assert not within_the_limit(dist, "1xtf32"), dist


if __name__ == "__main__":
    for dense, with_keep, H in (c.values for c in CASES):
        dist = distances(dense, with_keep, H)
        print(f"{'dense' if dense else 'block-diagonal'} w1, keep {with_keep}, {SHAPE} D {D} "
              f"H {H}: per head max|x - f64| / max|f64|; limit "
              + " ".join(f"{v:.2e}" for v in limits(dist)) + "; within: "
              + ", ".join(f"{m} {within_the_limit(dist, m)}" for m in MODES))
        for run, v in dist.items():
            print(f"  {run:12s} " + " ".join(f"{x:.2e}" for x in v)
                  + f"  (worst / limit {max(x / lim for x, lim in zip(v, limits(dist))):.2f})")
