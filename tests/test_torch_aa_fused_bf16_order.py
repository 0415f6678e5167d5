"""K3b's per-element order of arithmetic, in its register layout, against
the order of the arithmetic that K4b's recompute takes.

K3b (``trajsde_tpu_torch/csrc/aa_fused_bf16.cu``) carries each 16-row
m-tile of pairs through the chain in ``mma.sync`` C fragments: lane (g, t)
holds rows g and g + 8 at columns 8j + 2t, 2t + 1 of each n-tile j.  K4b
(``aa_fused_bwd_bf16.cu``) recomputes the chain through ``aa_common.cuh``'s
epilogues, which hold a row as 4 columns in each of 16 lanes, and
``mma_bf16.cuh``'s ``mma_xwt_bf16``.  Every logit K3b's softmax takes must
be the one K4b recomputes, bit for bit, so K3b keeps each element's order:

* ``ln_row_t`` (``row_sum16``): a group's partial (x0 + x1) + (x2 + x3),
  or the FMA chain of its squares (under ``ln_mm`` their bf16 roundings
  summed), then the butterfly over the 16 groups (xor 8, 4, 2, 1);
* ``head_logit`` / ``head_sum``: q0 k0 then FMAs in column order per group,
  the groups of a head in pairs (xor 1, then xor 2 at 4 heads);
* F2, ``[a0 | a0] . [w1[:, :D]; w1[:, D:]]`` over K = 4D: per 32-deep k
  block two k-steps into a fresh fragment, added in k order; K3b builds
  its A fragments from a0's C fragments and its B fragments by ldmatrix.

Each case runs a numpy model, in f32 (an exact FMA; the tensor cores' sum
by ``scripts/probe_mma_rounding_torch.py``'s ``mma_step``), of both orders
on seeded rows and holds them bit-equal; a planted case builds K3b's tree
in another order and must differ.  No model is built.
"""
from pathlib import Path
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.probe_mma_rounding_torch import mma_step  # noqa: E402

F32 = np.float32
D = 64
EPS = F32(1e-5)
INV_D = F32(1.0 / D)
LANES = 4   # t of a quad


def fma32(a, b, c):
    """fmaf: a b + c rounded once to f32 (to nearest, ties to even)."""
    a, b, c = (np.asarray(x, F32).astype(np.float64) for x in (a, b, c))
    p = a * b                                  # exact in f64
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)            # s + err = p + c exactly
    r = s.astype(F32)
    r64 = r.astype(np.float64)
    lo = np.where(r64 > s, np.nextafter(r, F32(-np.inf)), r)
    hi = np.where(r64 > s, r, np.nextafter(r, F32(np.inf)))
    # s rounds wrongly only when it lies exactly halfway between two f32
    # values and the exact sum does not
    mid = (s - lo.astype(np.float64)) == (hi.astype(np.float64) - s)
    return np.where(mid & (err > 0), hi, np.where(mid & (err < 0), lo, r)).astype(F32)


def bf16r(x):
    """x rounded to the nearest bf16 (ties to even), as an f32."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


# --------------------------------------------------------------------------
# LayerNorm
# --------------------------------------------------------------------------
def butterfly16(v):
    """row_sum16 on [rows, 16] lane values: xor 8, 4, 2, 1."""
    idx = np.arange(16)
    for off in (8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    assert (v == v[:, :1]).all()
    return v[:, 0]


def ln_parent(x, scale, bias, stats16):
    """ln_row_t<true> on rows x [rows, 64], each row in 16 lanes of 4
    columns -> (mean, inv, y) before the ReLU."""
    xl = x.reshape(-1, 16, 4)
    r = bf16r if stats16 else (lambda a: a)
    part = (r(xl[..., 0]) + r(xl[..., 1])) + (r(xl[..., 2]) + r(xl[..., 3]))
    mean = butterfly16(part) * INV_D
    xc = xl - mean[:, None, None]
    ss = np.zeros(xl.shape[:2], F32)
    for j in range(4):
        ss = ss + bf16r(xc[..., j] * xc[..., j]) if stats16 else fma32(xc[..., j], xc[..., j], ss)
    inv = F32(1.0) / np.sqrt(butterfly16(ss) * INV_D + EPS)
    y = bf16r(fma32(xc * inv[:, None, None], scale.reshape(16, 4), bias.reshape(16, 4)))
    return mean, inv, y.reshape(x.shape)


def c_layout(x):
    """[rows, 64] -> [rows, t, j, e]: column 8j + 2t + e, as lane (g, t)
    holds n-tile j of a C fragment."""
    return x.reshape(-1, 8, LANES, 2).transpose(0, 2, 1, 3)


def tree(p, planted=False):
    """The tree over the 16 groups from p [rows, t, k], the group of n-tile
    j = 2k + (t & 1) finished on lane t: n-tiles j ^ 4 (k ^ 2), then j ^ 2
    (k ^ 1) in registers, then lanes t ^ 1 (j ^ 1) and t ^ 2 by shuffles.
    planted: n-tiles j ^ 2 first, then j ^ 4 (another tree)."""
    if planted:
        s = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    else:
        s = (p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3])
    s = s + s[:, [1, 0, 3, 2]]
    s = s + s[:, [2, 3, 0, 1]]
    assert (s == s[:, :1]).all()
    return s[:, 0]


def group_tree(pp, planted=False):
    """aa_fused_bf16.cu's group_tree on [rows, t, j] lane halves: each lane
    finishes the groups of n-tiles j = 2k + (t & 1), its half plus the
    other lane's, then :func:`tree`."""
    p = np.stack([np.stack([pp[:, t, 2 * k + (t & 1)] + pp[:, t ^ 1, 2 * k + (t & 1)]
                            for k in range(4)], -1) for t in range(LANES)], 1)
    return tree(p, planted)


def var_tree(xc, stats16, planted=False):
    """aa_fused_bf16.cu's var_tree on centred values [rows, t, j, e]: the
    lane that finishes a group is the one group_tree gives it; the even
    lane holds its columns 0, 1, the odd lane 2, 3.  stats16: the four bf16
    squares as ((b0 + b1) + b2) + b3, with no 0 + b0 first (ln_row_t's
    start); else the FMA chain from 0."""
    ss = np.empty(xc.shape[:3], F32)   # [rows, t, j]: the group finished on lane t
    for t in range(LANES):
        ev, od = t & ~1, t | 1
        for j in range(8):
            x0, x1 = xc[:, ev, j, 0], xc[:, ev, j, 1]
            x2, x3 = xc[:, od, j, 0], xc[:, od, j, 1]
            if stats16:
                s = bf16r(x0 * x0) + bf16r(x1 * x1)
                s = s + bf16r(x2 * x2)
                s = s + bf16r(x3 * x3)
            else:
                s = fma32(x3, x3, fma32(x2, x2, fma32(x1, x1, fma32(x0, x0, F32(0.0)))))
            ss[:, t, j] = s
    p = np.stack([ss[:, t, (t & 1)::2] for t in range(LANES)], 1)   # [rows, t, k]
    return tree(p, planted)


def ln_kernel(x, scale, bias, stats16, planted=False):
    """K3b's LayerNorm of rows x [rows, 64] in the C layout -> (mean, inv, y)."""
    xl = c_layout(x)
    r = bf16r if stats16 else (lambda a: a)
    pp = r(xl[..., 0]) + r(xl[..., 1])
    mean = group_tree(pp, planted) * INV_D
    xc = xl - mean[:, None, None, None]
    inv = F32(1.0) / np.sqrt(var_tree(xc, stats16, planted) * INV_D + EPS)
    sl, bl = c_layout(scale[None])[0], c_layout(bias[None])[0]
    y = bf16r(fma32(xc * inv[:, None, None, None], sl, bl))
    return mean, inv, y.transpose(0, 2, 1, 3).reshape(x.shape)


def _rows(seed, n=256):
    """Rows of many magnitudes, half of them with elements of many
    magnitudes too (so that a row's bf16-rounded sums need rounding)."""
    rng = np.random.default_rng(seed)
    scale = rng.lognormal(0.0, 1.5, size=(n, 1))
    x = rng.standard_normal((n, D)) * scale + rng.standard_normal((n, 1)) * scale
    x[n // 2:] *= np.exp(3.0 * rng.standard_normal((n - n // 2, D)))
    return (x.astype(F32), (1.0 + 0.2 * rng.standard_normal(D)).astype(F32),
            (0.2 * rng.standard_normal(D)).astype(F32))


@pytest.mark.parametrize("stats16", [True, False])
def test_layernorm_in_the_c_layout_is_ln_row_t_bit_for_bit(stats16):
    for seed in range(3):
        x, scale, bias = _rows(seed)
        want = ln_parent(x, scale, bias, stats16)
        got = ln_kernel(x, scale, bias, stats16)
        for name, a, b in zip(("mean", "inv", "y"), got, want):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (seed, name)


@pytest.mark.parametrize("stats16", [True, False])
def test_a_layernorm_tree_in_another_order_is_caught(stats16):
    x, scale, bias = _rows(11)
    want = ln_parent(x, scale, bias, stats16)
    got = ln_kernel(x, scale, bias, stats16, planted=True)
    assert not np.array_equal(got[0], want[0]) or not np.array_equal(got[1], want[1])


# --------------------------------------------------------------------------
# head logits
# --------------------------------------------------------------------------
SCALES = {8: F32(0.35355339059327373), 4: F32(0.25)}


def logits_parent(q, k, heads):
    """head_logit<H>: [rows, 64] q and k -> [rows, H]."""
    ql, kl = q.reshape(-1, 16, 4), k.reshape(-1, 16, 4)
    part = ql[..., 0] * kl[..., 0]
    for j in range(1, 4):
        part = fma32(ql[..., j], kl[..., j], part)
    if heads == 8:
        s = part[:, 0::2] + part[:, 1::2]
    else:
        s = (part[:, 0::4] + part[:, 1::4]) + (part[:, 2::4] + part[:, 3::4])
    return s * SCALES[heads]


def logits_kernel(q, k, heads, planted=False):
    """K3b's logits from C fragments: the even lane's q0 k0 + q1 k1 (an FMA)
    shuffled to the odd lane, which adds q2 k2 and q3 k3 by FMAs; the odd
    lanes' groups summed over t ^ 2, at 4 heads the two n-tiles' sums
    added.  planted: at 4 heads the groups paired (0, 2), (1, 3)."""
    ql, kl = c_layout(q), c_layout(k)
    gp = {}
    for t in (1, 3):
        part = fma32(ql[:, t - 1, :, 1], kl[:, t - 1, :, 1], ql[:, t - 1, :, 0] * kl[:, t - 1, :, 0])
        part = fma32(ql[:, t, :, 0], kl[:, t, :, 0], part)
        gp[t] = fma32(ql[:, t, :, 1], kl[:, t, :, 1], part)     # [rows, j]
    if heads == 8:
        s = gp[1] + gp[3]
    elif planted:
        s = (gp[1][:, 0::2] + gp[1][:, 1::2]) + (gp[3][:, 0::2] + gp[3][:, 1::2])
    else:
        s = (gp[1][:, 0::2] + gp[3][:, 0::2]) + (gp[1][:, 1::2] + gp[3][:, 1::2])
    return s * SCALES[heads]


@pytest.mark.parametrize("heads", [8, 4])
def test_head_logits_in_the_c_layout_are_head_logit_bit_for_bit(heads):
    rng = np.random.default_rng(heads)
    q = rng.standard_normal((512, D)).astype(F32)
    k = (rng.standard_normal((512, D)) * rng.lognormal(0.0, 1.0, (512, 1))).astype(F32)
    want, got = logits_parent(q, k, heads), logits_kernel(q, k, heads)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_head_groups_summed_in_another_order_are_caught():
    rng = np.random.default_rng(40)
    q = rng.standard_normal((512, D)).astype(F32)
    k = rng.standard_normal((512, D)).astype(F32)
    assert not np.array_equal(logits_kernel(q, k, 4, planted=True), logits_parent(q, k, 4))


# --------------------------------------------------------------------------
# F2's products over K = 4D
# --------------------------------------------------------------------------
def f2_parent(a0, wt):
    """mma_xwt_bf16 over [a0 | a0] [16, 4D] and W^T [8, 4D]: per 32-deep
    block two k-steps of 16 into a fresh fragment, added to acc in order."""
    a = torch.from_numpy(np.concatenate([a0, a0], 1))
    b = torch.from_numpy(wt).t()
    acc = torch.zeros((16, 8), dtype=torch.float32)
    for k0 in range(0, 4 * D, 32):
        c = mma_step(torch.zeros_like(acc), a[:, k0:k0 + 16], b[k0:k0 + 16])
        c = mma_step(c, a[:, k0 + 16:k0 + 32], b[k0 + 16:k0 + 32])
        acc = acc + c
    return acc.numpy()


def f2_kernel(a0, wt, planted=False):
    """mma_rows<8, 16, 7> for one n-tile: the A fragment of k-step s built
    from a0's C fragments (n-tiles 2s, 2s + 1 packed in pairs), k-step s of
    K = 4D taking a0's s & 7; B by ldmatrix.x4 (lane l addresses row l % 8
    of matrix l / 8 at depth 32 kb + 8 (l / 8); register i is matrix i's
    row lane / 4 at values 2 (lane % 4), + 1), registers 0, 1 k-step 0's
    and 2, 3 k-step 1's; each mma's operands read back from the lanes by
    the PTX fragment layout.  planted: the two k-steps' B swapped."""
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    a = np.zeros((16, 4 * D), F32)
    for s in range(16):
        sp = s & 7                    # KMASK
        for lane, (g, t) in enumerate(lanes):
            # lane's C fragment values of a0's n-tiles 2 sp, 2 sp + 1
            c0, c1 = 16 * sp + 2 * t, 16 * sp + 8 + 2 * t
            reg = [(a0[g, c0], a0[g, c0 + 1]), (a0[g + 8, c0], a0[g + 8, c0 + 1]),
                   (a0[g, c1], a0[g, c1 + 1]), (a0[g + 8, c1], a0[g + 8, c1 + 1])]
            # the A layout: reg0 (g, 2t..), reg1 (g + 8, 2t..), reg2 (g, 2t + 8..), reg3 (g + 8, ..)
            for r, (row, kk) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                           (g + 8, 2 * t + 8))):
                a[row, 16 * s + kk], a[row, 16 * s + kk + 1] = reg[r]
    b = np.zeros((4 * D, 8), F32)
    for kb in range(8):
        addr = [(lane & 7, 32 * kb + 8 * (lane >> 3)) for lane in range(32)]   # (row n, depth)
        regs = np.zeros((32, 4, 2), F32)
        for lane, (g, t) in enumerate(lanes):
            for i in range(4):
                n, k = addr[8 * i + g]
                regs[lane, i] = wt[n, k + 2 * t:k + 2 * t + 2]
        order = (2, 3, 0, 1) if planted else (0, 1, 2, 3)
        for h in range(2):
            b0, b1 = order[2 * h], order[2 * h + 1]
            for lane, (g, t) in enumerate(lanes):  # B layout: b0 (k 2t.., n g), b1 (k 2t + 8.., n g)
                k = 32 * kb + 16 * h
                b[k + 2 * t:k + 2 * t + 2, g] = regs[lane, b0]
                b[k + 2 * t + 8:k + 2 * t + 10, g] = regs[lane, b1]
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    acc = torch.zeros((16, 8), dtype=torch.float32)
    for k0 in range(0, 4 * D, 32):
        c = mma_step(torch.zeros_like(acc), at[:, k0:k0 + 16], bt[k0:k0 + 16])
        c = mma_step(c, at[:, k0 + 16:k0 + 32], bt[k0 + 16:k0 + 32])
        acc = acc + c
    return acc.numpy()


def _f2_case(seed):
    rng = np.random.default_rng(seed)
    a0 = bf16r(np.maximum(rng.standard_normal((16, 2 * D)), 0.0).astype(F32))
    wt = bf16r((rng.standard_normal((8, 4 * D)) / 16.0).astype(F32))
    return a0, wt


@pytest.mark.parametrize("seed", [0, 1])
def test_f2_from_registers_is_mma_xwt_bf16_bit_for_bit(seed):
    a0, wt = _f2_case(seed)
    assert np.array_equal(f2_kernel(a0, wt).view(np.uint32), f2_parent(a0, wt).view(np.uint32))


def test_f2_with_its_k_steps_swapped_is_caught():
    a0, wt = _f2_case(3)
    assert not np.array_equal(f2_kernel(a0, wt, planted=True), f2_parent(a0, wt))
