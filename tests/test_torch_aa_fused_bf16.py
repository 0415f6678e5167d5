"""The fused AA pair chain in bf16 (the plain versions of kernels K3b and
K4b) vs the JAX package's ``fused_pair_attention`` with
``FusedCfg(dtype="bfloat16")`` in interpret mode, on the CPU.

The JAX side is compiled with XLA's excess precision off
(``_torch_helpers.jit_exact``: otherwise XLA may skip a bf16 rounding).
Cases: (D, H) = (64, 8), (64, 4) and (16, 4); with and without a keep
mask; ``ln_mm`` on and off; the model's block-diagonal w1 and a random one.
B 2, T 3, Aq 5, Ak 6 (T * Aq = 15 rows: two forward tiles of 8), one
receiver without a sender.

Bars:
* forward, ``FWD_BAR``: max|port - JAX| <= 1e-3 of max|JAX|.  The port
  meets JAX within 2e-7 where no rounding lands on the other side of a
  tie, and within 5.3e-4 where one a0 element does (a summation order
  apart; the block-diagonal cases at D 64).  The port's f32 chain (2.8e-3
  to 7.8e-3) and the bf16 chain with the other ``ln_mm`` (2.1e-3 to
  6.4e-3) fail it, and each case asserts both.
* backward, relative L2 per leaf: ``dq`` within ``DQ_BAR`` = 2e-3 (the
  port 3e-7, or 3e-4 after such a tie; the f32 chain 5.7e-3 to 8.8e-3, so
  it fails this bar in every case, which is asserted); every other leaf
  but ``w1``, ``wagg``, ``wkv`` and ``bkv`` within ``LEAF_BAR`` = 1e-2 (the
  port 5e-4 to 7.6e-3: JAX rounds each cotangent of a bf16 value to bf16,
  the port keeps f32, as K4b does); ``bkv`` within ``BKV_BAR`` = 1e-4 (bf16
  does not reach it: 1e-7, 1.1e-5 after a tie).  ``w1``, ``wagg`` and
  ``wkv`` within 2x JAX's own spread between ``rows_bwd`` 8 and 15 (2.1e-3
  to 2.9e-3: JAX rounds each tile's gradient of a bf16-cast weight to bf16
  before the tiles are summed, which the port does not copy); the port's
  gap is printed beside the f32 chain's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.ops.pallas import aa_fused as jax_k3
from trajsde_tpu_torch.ops import aa_fused as K3

from _torch_helpers import jit_exact, t

torch.set_num_threads(1)
B, T, AQ, AK, P_DROP = 2, 3, 5, 6, 0.1
FWD_BAR = 1e-3
DQ_BAR, LEAF_BAR, BKV_BAR, SPREAD_FACTOR = 2e-3, 1e-2, 1e-4, 2.0
SPREAD_LEAVES = ("w1", "wagg", "wkv")
WIDTHS = ((64, 8), (64, 4), (16, 4))
FWD_CASES = [pytest.param(d, h, w, k, m, id=f"D{d}-H{h}-{w}-keep{int(k)}-lnmm{int(m)}")
             for d, h in WIDTHS for w in ("block", "random") for k in (False, True)
             for m in (True, False)]
# the backward at ln_mm on (the JAX encoders' default): keep on at every
# width, and off at the flagship's
BWD_CASES = [pytest.param(d, h, w, k, id=f"D{d}-H{h}-{w}-keep{int(k)}")
             for d, h, k in ((64, 8, True), (64, 8, False), (64, 4, True), (16, 4, True))
             for w in ("block", "random")]


def _weights(r, D, kind):
    """The 14 packed weights: matrices N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.04), other vectors N(0, 0.04); ``block`` zeroes wu's and
    w1's off-diagonal blocks, as the model's packing leaves them."""
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wkv=(D, 2 * D), bkv=(1, 2 * D))
    out = {}
    for k in K3.W_ORDER:
        x = r.standard_normal(shapes[k])
        x = x / np.sqrt(shapes[k][0]) if k[0] == "w" else 0.2 * x + float(k.endswith("s"))
        out[k] = x.astype(np.float32)
    if kind == "block":
        out["wu"][:2, D:] = out["wu"][2:, :D] = 0.0
        out["w1"][:D, D:] = out["w1"][D:, :D] = 0.0
    return tuple(out[k] for k in K3.W_ORDER)


def _inputs(D, H, kind, with_keep):
    r = np.random.default_rng(0)
    ws = _weights(r, D, kind)
    q = r.standard_normal((B, T, AQ, D)).astype(np.float32)
    u = (r.standard_normal((B, T, AQ, AK, 4)) * 3).astype(np.float32)
    mask = (r.uniform(size=(B, T, AQ, AK)) < 0.6).astype(np.float32)
    mask[1, 2, 4] = 0.0
    keep = (r.uniform(size=(B, T, AQ, AK, H)) >= P_DROP).astype(np.float32)
    g = r.standard_normal((B, T, AQ, D)).astype(np.float32)
    return q, u, mask, keep if with_keep else None, ws, g


@functools.lru_cache(maxsize=None)
def _jax_program(D, H, ln_mm, with_keep, rows_bwd):
    """The JAX op compiled once per configuration (weights and data are
    arguments): ``rows_bwd`` None -> the forward alone, else
    ``(out, (dq, dws))`` of its VJP at that backward tile."""
    cfg = jax_k3.FusedCfg(Aq=AQ, Ak=AK, D=D, H=H, rows_fwd=8, rows_bwd=rows_bwd or 8,
                          dropout_rate=P_DROP, dtype="bfloat16", interpret=True, ln_mm=ln_mm)

    def fwd(q, u, mask, keep, ws):
        return jax_k3.fused_pair_attention(cfg, q, u, mask, keep, ws)

    def vjp(q, u, mask, keep, ws, g):
        out, pull = jax.vjp(lambda a, b: fwd(a, u, mask, keep, b), q, ws)
        return out, pull(g)

    *example, g = _inputs(D, H, "random", with_keep)
    if rows_bwd is None:
        return jit_exact(fwd, *_jax_args(*example))
    return jit_exact(vjp, *_jax_args(*example), jnp.asarray(g))


def _jax_args(q, u, mask, keep, ws):
    return [jnp.asarray(q), jnp.asarray(u), jnp.asarray(mask),
            None if keep is None else jnp.asarray(keep), tuple(map(jnp.asarray, ws))]


def _jax(D, H, ln_mm, with_keep, rows_bwd, q, u, mask, keep, ws, g=None):
    args = _jax_args(q, u, mask, keep, ws)
    prog = _jax_program(D, H, ln_mm, with_keep, rows_bwd)
    if rows_bwd is None:
        return np.asarray(prog(*args))
    out, (dq, dws) = prog(*args, jnp.asarray(g))
    return np.asarray(out), dict(dq=np.asarray(dq),
                                 **{k: np.asarray(v) for k, v in zip(K3.W_ORDER, dws)})


def _port(q, u, mask, keep, ws, H, compute_dtype, ln_mm):
    return K3.fused_pair_attention(t(q), t(u), t(mask), None if keep is None else t(keep),
                                   tuple(map(t, ws)), H, P_DROP, compute_dtype, ln_mm).numpy()


def _dist(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("D,H,weights,with_keep,ln_mm", FWD_CASES)
def test_plain_bf16_chain_matches_jax_and_the_wrong_chains_do_not(D, H, weights, with_keep,
                                                                   ln_mm):
    q, u, mask, keep, ws, _ = _inputs(D, H, weights, with_keep)
    want = _jax(D, H, ln_mm, with_keep, None, q, u, mask, keep, ws)
    got = _port(q, u, mask, keep, ws, H, "bfloat16", ln_mm)
    assert np.all(got[1, 2, 4] == 0.0)          # no sender: exactly 0
    wrong = _dist(_port(q, u, mask, keep, ws, H, "bfloat16", not ln_mm), want)
    f32 = _dist(_port(q, u, mask, keep, ws, H, "float32", ln_mm), want)
    port = _dist(got, want)
    print(f"max|diff| / max|JAX|: port {port:.2e}, other ln_mm {wrong:.2e}, f32 {f32:.2e}")
    assert port <= FWD_BAR, port
    assert wrong > FWD_BAR and f32 > FWD_BAR, (wrong, f32)


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------
def _port_grads(q, u, mask, keep, ws, g, H, compute_dtype):
    dq, dws = K3.fused_pair_attention_bwd_reference(
        t(q), t(u), t(mask), None if keep is None else t(keep), tuple(map(t, ws)), t(g), H,
        P_DROP, compute_dtype, True)
    return dict(dq=dq.numpy(), **{k: v.numpy() for k, v in zip(K3.W_ORDER, dws)})


def _bar_failures(grads, want):
    """The leaves of ``grads`` outside the dq / leaf / bkv bars."""
    out = []
    for k, w in want.items():
        if k in SPREAD_LEAVES:
            continue
        bar = DQ_BAR if k == "dq" else BKV_BAR if k == "bkv" else LEAF_BAR
        if _rel_l2(grads[k], w) > bar:
            out.append(k)
    return out


@pytest.mark.parametrize("D,H,weights,with_keep", BWD_CASES)
def test_plain_bf16_backward_matches_jax(D, H, weights, with_keep):
    q, u, mask, keep, ws, g = _inputs(D, H, weights, with_keep)
    _, want = _jax(D, H, True, with_keep, 8, q, u, mask, keep, ws, g)
    _, other = _jax(D, H, True, with_keep, 15, q, u, mask, keep, ws, g)
    port = _port_grads(q, u, mask, keep, ws, g, H, "bfloat16")
    f32 = _port_grads(q, u, mask, keep, ws, g, H, "float32")
    assert not _bar_failures(port, want), {k: _rel_l2(port[k], want[k]) for k in want}
    assert "dq" in _bar_failures(f32, want)
    for k in SPREAD_LEAVES:
        spread = _rel_l2(other[k], want[k])
        gap = _rel_l2(port[k], want[k])
        print(f"{k}: JAX's spread over rows_bwd 8 / 15 {spread:.2e}, port {gap:.2e}, f32 chain "
              f"{_rel_l2(f32[k], want[k]):.2e}")
        assert gap <= SPREAD_FACTOR * spread, (k, gap, spread)


# --------------------------------------------------------------------------
# the op's wiring in bf16
# --------------------------------------------------------------------------
def test_bf16_autograd_path_is_the_plain_backward_and_counts_no_launch():
    """On the CPU ``FusedPairAttentionFn`` in bf16 runs the plain forward and
    the plain backward (K3b's and K4b's), bit for bit, and counts nothing."""
    D, H = 16, 4
    q, u, mask, keep, ws, g = _inputs(D, H, "random", True)
    tq = t(q).requires_grad_()
    tws = [t(w).requires_grad_() for w in ws]
    counts = (K3.fused_pair_attention.launches, K3.fused_pair_attention.bf16_launches,
              K3.fused_pair_attention_bwd.launches, K3.fused_pair_attention_bwd.bf16_launches)
    out = K3.fused_pair_attention(tq, t(u), t(mask), t(keep), tws, H, P_DROP, "bfloat16")
    assert type(out.grad_fn).__name__ == "FusedPairAttentionFnBackward"
    out.backward(t(g))
    assert torch.equal(out.detach(), K3.fused_pair_attention_reference(
        t(q), t(u), t(mask), t(keep), tuple(map(t, ws)), H, P_DROP, compute_dtype="bfloat16"))
    dq, dws = K3.fused_pair_attention_bwd_reference(t(q), t(u), t(mask), t(keep),
                                                    tuple(map(t, ws)), t(g), H, P_DROP,
                                                    "bfloat16")
    assert torch.equal(tq.grad, dq) and all(torch.equal(a.grad, b) for a, b in zip(tws, dws))
    assert counts == (K3.fused_pair_attention.launches, K3.fused_pair_attention.bf16_launches,
                      K3.fused_pair_attention_bwd.launches,
                      K3.fused_pair_attention_bwd.bf16_launches)


def test_f32_chain_ignores_ln_mm_and_other_dtypes_raise():
    """In f32 ``ln_mm`` is an order of summation: the plain chain is the
    same bits either way; a compute dtype other than f32 / bf16 raises."""
    q, u, mask, keep, ws, _ = _inputs(16, 4, "random", True)
    assert np.array_equal(_port(q, u, mask, keep, ws, 4, "float32", True),
                          _port(q, u, mask, keep, ws, 4, "float32", False))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _port(q, u, mask, keep, ws, 4, "float16", True)
