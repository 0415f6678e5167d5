"""K5's arithmetic, emulated on the CPU.

Kernel K5 (``trajsde_tpu_torch/csrc/aa_attention.cu``) runs K3's chain
(``csrc/aa_fused.cu``) with two prologues: q = ``center . wq + bq`` in f32
FMAs, and the pair features u, each product and sum rounded on its own,
so that u has the plain version's bits.  Its three chain products,
``a0 @ w1f`` (w1 folded, K = 128), ``a1 @ wagg`` and ``nbr @ wkv``, run on
the tensor cores in 3xTF32 with the small terms summed apart
(``mma3x2_apart``), and its head logits in ``head_logit``'s order: K3's
arithmetic, which ``tests/test_torch_aa_fused_fwd_tf32.py`` models.

Here the plain op (``aa_attention_reference``, unedited) gets that file's
stand-ins for ``w1``, ``wagg`` and ``wkv``, which route the three products
through its ``MODES``, and the head logits in the kernel's order
(``_torch_helpers.kernel_head_logits``); q is the plain version's f32
product and u its own.  At (B, T, Aq, Ak) = (2, 3, 9, 48), D 64, at the
flagship's 8 heads and the HiVT baseline's 4, for the model's own packed
weights (a seeded ``AAEncoder``: block-diagonal wu and w1) and random ones
(every block filled in), ``out`` is held against the plain op in f64, per
head, as max|x - f64| over the head's columns / max|f64| over all of
``out``.  The limit is 2x the f32 plain version's distance on the head,
floored at its median over the heads.  ``3xtf32`` meets it; ``1xtf32``
(one TF32 product per term) does not.

    PYTHONPATH=. python tests/test_torch_aa_attention_tf32.py   # every head's distance, each mode
"""
from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_helpers import kernel_head_logits, packed_aa_weights, torch_threads
from test_torch_aa_fused_fwd_tf32 import MODES, limits, per_head, routed_chain, within_the_limit
from trajsde_tpu_torch.models.local_encoder import AAEncoder
from trajsde_tpu_torch.ops import aa_attention as K5
from trajsde_tpu_torch.ops import aa_fused as K3

SHAPE, D = (2, 3, 9, 48), 64
RUNS = ("3xtf32", "1xtf32")


def _inputs(r: np.random.Generator):
    """``test_aa_kernel.py``'s input scales at ``SHAPE`` (sender j near
    receiver j mod Aq), every 7th receiver without a sender."""
    B, T, Aq, Ak = SHAPE
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    center = r.standard_normal((B, T, Aq, D))
    x_k = r.standard_normal((B, T, Ak, 2))
    pos_q = np.float32(20.0) * r.standard_normal((B, T, Aq, 2)).astype(np.float32)
    pos_k = pos_q[:, :, np.arange(Ak) % Aq] + 5.0 * r.standard_normal((B, T, Ak, 2))
    ang = r.uniform(-np.pi, np.pi, size=(B, Aq))
    rot = np.stack([np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)], axis=-1)
    mask = r.uniform(size=(B, T, Aq, Ak)) > 0.4
    mask[:, :, ::7] = False
    return (f32(center), f32(x_k), f32(pos_q), f32(pos_k), f32(rot), torch.from_numpy(mask))


def _packed(weights: str, H: int, r: np.random.Generator) -> dict:
    """The packed weights with wq / bq: the model's (a seeded ``AAEncoder``'s
    own initialisation) or random ones with every block filled in."""
    if weights == "model":
        torch.manual_seed(H)
        return {k: v.contiguous() for k, v in
                K3.pack_aa_params(AAEncoder(21, D, H, fused=True)).items()}
    packed = dict(zip(K3.W_ORDER, packed_aa_weights(r, dense=True)))
    packed["wq"] = torch.from_numpy((r.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32))
    packed["bq"] = torch.from_numpy((0.2 * r.standard_normal((1, D))).astype(np.float32))
    return packed


def _case(weights: str, H: int, seed: int = 7):
    r = np.random.default_rng(seed)
    args = _inputs(r)
    return args, _packed(weights, H, r)


def routed(packed: dict, mode: str, calls: list) -> dict:
    """``packed`` with w1, wagg and wkv routed through ``MODES[mode]`` (w1
    folded, b1 handed over as ``[b1f | 0]``), wq and bq as they are."""
    chain = routed_chain([packed[k] for k in K3.W_ORDER], mode, calls)
    return dict(zip(K3.W_ORDER, chain), wq=packed["wq"], bq=packed["bq"])


@functools.lru_cache(maxsize=None)
def distances(weights: str, H: int) -> dict:
    """run -> per-head distances from f64, for plain and each of ``RUNS``
    (those with the head logits in the kernel's order)."""
    args, packed = _case(weights, H)
    d64 = tuple(a if a.dtype == torch.bool else a.double() for a in args)
    with torch_threads(2):
        oracle = K5.aa_attention_reference(*d64, {k: v.double() for k, v in packed.items()}, H)
        runs = {"plain": K5.aa_attention_reference(*args, packed, H)}
        with mock.patch.object(K3, "_head_logits", kernel_head_logits):
            for mode in RUNS:
                runs[mode] = K5.aa_attention_reference(*args, routed(packed, mode, []), H)
    return {run: per_head(x, oracle, H) for run, x in runs.items()}


CASES = [pytest.param(w, h, id=f"{w}-{h}-heads") for h in (8, 4) for w in ("model", "random")]


def test_the_pair_features_are_each_product_and_sum_rounded_on_its_own():
    """u of the plain op is the kernel's: r0 x0 + r2 x1 with both products
    and the sum each rounded to f32 (__fmul_rn, __fadd_rn), bit for bit."""
    center, x_k, pos_q, pos_k, rot, _ = _inputs(np.random.default_rng(3))
    u = K3.build_pair_features(x_k, pos_k[:, :, None] - pos_q[:, :, :, None], rot).numpy()
    x, pq, pk, r = (a.numpy() for a in (x_k, pos_q, pos_k, rot))
    r = r[:, None, :, None, :]                               # [B, 1, Aq, 1, 4]
    e = pk[:, :, None] - pq[:, :, :, None]                   # f32 differences
    xk = x[:, :, None]
    want = np.stack([r[..., 0] * xk[..., 0] + r[..., 2] * xk[..., 1],
                     r[..., 1] * xk[..., 0] + r[..., 3] * xk[..., 1],
                     r[..., 0] * e[..., 0] + r[..., 2] * e[..., 1],
                     r[..., 1] * e[..., 0] + r[..., 3] * e[..., 1]], axis=-1)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(u, want)


def test_routing_reaches_k5s_three_products_and_keeps_the_function():
    """The stand-ins see a0 @ w1f [2D, D], a1 @ wagg and nbr @ wkv of every
    pair; in f32 the routed op agrees with the plain one to f32 rounding;
    q's product is not routed."""
    H = 8
    args, packed = _case("random", H)
    calls = []
    got = K5.aa_attention_reference(*args, routed(packed, "f32-folded", calls), H)
    pairs = int(np.prod(SHAPE))
    assert calls == [((pairs, 2 * D), (2 * D, D)), ((pairs, D), (D, D)), ((pairs, D), (D, 2 * D))]
    want = K5.aa_attention_reference(*args, packed, H)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5
    assert (got[:, :, ::7] == 0).all()


@pytest.mark.parametrize("weights,H", CASES)
def test_3xtf32_k5_is_within_twice_the_plain_distance_from_f64(weights, H):
    dist = distances(weights, H)
    assert within_the_limit(dist, "3xtf32"), dist


@pytest.mark.parametrize("weights,H", CASES)
def test_one_tf32_product_breaks_k5s_limit(weights, H):
    """The limit tells K5's arithmetic from one TF32 product per term."""
    dist = distances(weights, H)
    assert not within_the_limit(dist, "1xtf32"), dist


if __name__ == "__main__":
    assert set(RUNS) <= set(MODES)
    for weights, H in (c.values for c in CASES):
        dist = distances(weights, H)
        print(f"{weights} weights, {SHAPE} D {D} H {H}: per head max|x - f64| / max|f64|; limit "
              + " ".join(f"{v:.2e}" for v in limits(dist)) + "; within: "
              + ", ".join(f"{m} {within_the_limit(dist, m)}" for m in RUNS))
        for run, v in dist.items():
            print(f"  {run:8s} " + " ".join(f"{x:.2e}" for x in v)
                  + f"  (worst / limit {max(x / lim for x, lim in zip(v, limits(dist))):.2f})")
