"""The ``aa_attention`` op (kernel K5's plain version, and K5b's in bf16)
and the packed AA weights vs the JAX package on the CPU.

The JAX side is ``trajsde_tpu/ops/pallas/aa_attention.py``: its
``aa_attention_reference`` and the Pallas op in interpret mode, as
``tests/test_aa_kernel.py`` runs them, on inputs made the same way from a
seeded numpy generator.  Tolerances: the packed weights are exact (the same
numbers moved); the op rtol 2e-4 / atol 2e-5, the JAX test's own (about
1e-6 is observed: the same f32 chain summed in another order); a receiver
with no sender gives exactly 0.

In bf16 the Pallas op (``compute_dtype="bfloat16"``, interpret mode) is
compiled with XLA's excess precision off (``_torch_helpers.jit_exact``:
otherwise XLA may skip a bf16 rounding) and the plain bf16 version is held
to it within ``BF16_BAR``: max|port - JAX| <= 2e-3 of max|JAX| and
mean|port - JAX| <= 2e-4 of mean|JAX|, at (D, H) = (64, 8), (64, 4) and
(16, 4), with the model's weights and random ones.  The port meets JAX
within 2.4e-7 / 6.8e-8 where no rounding lands on the other side of a
tie, and within 1.01e-3 / 2.0e-5 where some do (a summation order apart:
half the elements are JAX's bits).  Two wrong chains fail the mean bar by
15x or more in every case, which is asserted: the f32 chain (mean 3.2e-3
to 4.8e-3) and K3b's rounding points (``pair_chain``'s) behind the same q
projection (3.3e-3 to 4.1e-3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.models.embedding import MultipleInputEmbedding
from trajsde_tpu.models.layers import EdgeAttention
from trajsde_tpu.ops.pallas import aa_attention as jax_k5
from trajsde_tpu_torch.bridge import aa_packed_from_flax
from trajsde_tpu_torch.ops import aa_attention as K5
from trajsde_tpu_torch.ops import aa_fused as K3

from _torch_helpers import bf16_distance, jit_exact

torch.set_num_threads(1)
D, H = 64, 8
TOL = dict(rtol=2e-4, atol=2e-5)
BF16_BAR = (2e-3, 2e-4)
BF16_WIDTHS = ((64, 8), (64, 4), (16, 4))


def _inputs(rng, B=2, T=5, Aq=9, Ak=8, dim=D):
    """``test_aa_kernel.py``'s inputs (sender j sits near receiver j mod Aq),
    with every 7th receiver and (0, 0, 0) without a sender."""
    center = rng.normal(size=(B, T, Aq, dim)).astype(np.float32)
    x_k = rng.normal(size=(B, T, Ak, 2)).astype(np.float32)
    pos_q = rng.normal(scale=20, size=(B, T, Aq, 2)).astype(np.float32)
    pos_k = pos_q[:, :, np.arange(Ak) % Aq] + rng.normal(scale=5, size=(B, T, Ak, 2))
    ang = rng.uniform(-np.pi, np.pi, size=(B, Aq)).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([c, -s, s, c], axis=-1)
    mask = rng.uniform(size=(B, T, Aq, Ak)) > 0.4
    mask[:, :, ::7] = False
    mask[0, 0, 0] = False
    return center, x_k, pos_q, pos_k.astype(np.float32), rot, mask


def _linen_tree(heads=H, dim=D):
    """The linen ``MultipleInputEmbedding`` + ``EdgeAttention`` pair's params."""
    p_mie = MultipleInputEmbedding(dim).init(jax.random.key(3), [jnp.ones((1, 2)),
                                                                 jnp.ones((1, 2))])
    p_attn = EdgeAttention(dim, heads, dropout=0.0).init(
        jax.random.key(4), jnp.ones((1, dim)), jnp.ones((1, 1), bool),
        kv_pair=jnp.ones((1, 1, dim)))
    tree = {"nbr_embed": p_mie["params"], "attn": p_attn["params"]}
    return jax.tree.map(np.asarray, tree)


def _random_packed(rng, D=D):
    """Random packed weights with every block filled in (wu and w1 not
    block-diagonal), for JAX (jnp) and the port (torch)."""
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wq=(D, D), bq=(1, D),
                  wkv=(D, 2 * D), bkv=(1, 2 * D))
    ws = {k: (rng.standard_normal(s) * (s[0] ** -0.5 if k[0] == "w" else 0.3)
              + (1.0 if k.endswith("s") else 0.0)).astype(np.float32) for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in ws.items()},
            {k: torch.from_numpy(v) for k, v in ws.items()})


def _packed(weights, heads=H, dim=D, rng=None):
    if weights == "random":
        return _random_packed(rng or np.random.default_rng(11), dim)
    tree = _linen_tree(heads, dim)
    return jax_k5.pack_aa_params(tree), aa_packed_from_flax(tree)


def test_aa_packed_from_flax_matches_jax_exactly():
    tree = _linen_tree()
    want = jax_k5.pack_aa_params(tree)
    got = aa_packed_from_flax(tree)
    assert set(got) == set(want) == set(K3.W_ORDER) | {"wq", "bq"}
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    np.testing.assert_array_equal(got["w1"][:D, D:].numpy(), 0.0)  # block-diagonal


@pytest.mark.parametrize("jax_side", ["reference", "interpret"])
def test_aa_attention_reference_matches_jax(rng, jax_side):
    """``test_aa_kernel.py``'s shape (2, 5, 9, 8) and linen weights."""
    args = _inputs(rng)
    jpacked, tpacked = _packed("linen")
    jargs = tuple(jnp.asarray(a) for a in args)
    if jax_side == "reference":
        want = np.asarray(jax_k5.aa_attention_reference(*jargs, jpacked, H))
    else:
        want = np.asarray(jax_k5.aa_attention(*jargs, jpacked, num_heads=H, interpret=True))
    got = K5.aa_attention_reference(*(torch.from_numpy(a) for a in args), tpacked, H).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    mask = args[-1]
    empty = ~mask.any(-1)
    assert empty[0, 0, 0] and empty.sum() > 1
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("shape,weights", [((2, 5, 9, 8), "random"),
                                           ((1, 3, 6, 11), "linen"),
                                           ((2, 4, 12, 5), "random")])
def test_aa_attention_matches_jax_at_other_shapes(shape, weights):
    """Aq != Ak both ways and random weights with the off-diagonal blocks
    filled in, against the interpret-mode Pallas op (``t_chunk`` 3 does not
    divide T = 4 or 5: the JAX op shrinks it)."""
    args = _inputs(np.random.default_rng(sum(shape)), *shape)
    jpacked, tpacked = _packed(weights)
    want = np.asarray(jax_k5.aa_attention(*(jnp.asarray(a) for a in args), jpacked,
                                          num_heads=H, interpret=True))
    got = K5.aa_attention(*(torch.from_numpy(a) for a in args), tpacked, H).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, :, ::7] == 0).all()


@pytest.mark.parametrize("jax_side", ["reference", "interpret"])
@pytest.mark.parametrize("shape,weights", [((2, 5, 9, 8), "linen"), ((2, 4, 12, 5), "random")])
def test_aa_attention_matches_jax_at_the_baselines_4_heads(jax_side, shape, weights):
    """At the HiVT baseline's 4 heads (the kernel's other head count):
    ``test_aa_kernel.py``'s shape with linen weights built at 4 heads, and
    Aq > Ak with random weights, against JAX's reference and the
    interpret-mode Pallas op at ``num_heads=4``."""
    heads = 4
    args = _inputs(np.random.default_rng(sum(shape) + heads), *shape)
    jpacked, tpacked = _packed(weights, heads)
    jargs = tuple(jnp.asarray(a) for a in args)
    if jax_side == "reference":
        want = np.asarray(jax_k5.aa_attention_reference(*jargs, jpacked, heads))
    else:
        want = np.asarray(jax_k5.aa_attention(*jargs, jpacked, num_heads=heads, interpret=True))
    got = K5.aa_attention(*(torch.from_numpy(a) for a in args), tpacked, heads).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, :, ::7] == 0).all()
    assert not np.allclose(got, K5.aa_attention(*(torch.from_numpy(a) for a in args), tpacked,
                                                H).numpy(), **TOL)  # the head count matters


def test_aa_attention_on_cpu_launches_nothing_and_ignores_t_chunk(rng):
    args = tuple(torch.from_numpy(a) for a in _inputs(rng))
    _, packed = _packed("linen")
    before = K5.aa_attention.launches
    a = K5.aa_attention(*args, packed, H)
    b = K5.aa_attention(*args, packed, H, t_chunk=5)
    assert K5.aa_attention.launches == before
    assert torch.equal(a, b)
    assert a.shape == args[0].shape and a.dtype == torch.float32


def test_aa_attention_compute_dtype(rng):
    """bf16 runs (the plain K5b on the CPU), its output f32, and launches
    nothing; any other dtype is refused."""
    args = tuple(torch.from_numpy(a) for a in _inputs(rng))
    _, packed = _packed("linen")
    before = (K5.aa_attention.launches, K5.aa_attention.bf16_launches)
    got = K5.aa_attention(*args, packed, H, compute_dtype="bfloat16")
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert torch.equal(got, K5.aa_attention_reference(*args, packed, H, "bfloat16"))
    assert not torch.equal(got, K5.aa_attention(*args, packed, H))
    assert (K5.aa_attention.launches, K5.aa_attention.bf16_launches) == before
    with pytest.raises(ValueError, match="compute_dtype"):
        K5.aa_attention(*args, packed, H, compute_dtype="float16")


@functools.lru_cache(maxsize=None)
def _jax_bf16(dim, heads):
    """JAX's bf16 op in interpret mode, compiled once per width by
    ``jit_exact`` (the weights are arguments)."""
    def fn(center, x_k, pos_q, pos_k, rot, mask, packed):
        return jax_k5.aa_attention(center, x_k, pos_q, pos_k, rot, mask, packed,
                                   num_heads=heads, interpret=True, compute_dtype="bfloat16")

    args = [jnp.asarray(a) for a in _inputs(np.random.default_rng(0), dim=dim)]
    return jit_exact(fn, *args, _random_packed(np.random.default_rng(0), dim)[0])


def _k3b_points(args, packed, heads):
    """The wrong bf16 chain: K3b's rounding points (``pair_chain``'s), fed the
    f32 q projection and pair features of the same inputs."""
    center, x_k, pos_q, pos_k, rot, mask = args
    q = center @ packed["wq"] + packed["bq"][0]
    u = K3.build_pair_features(x_k, pos_k[:, :, None] - pos_q[:, :, :, None], rot)
    return K3.fused_pair_attention_reference(q, u, mask.float(), None, K3.weights_of(packed),
                                             heads, compute_dtype="bfloat16")


@pytest.mark.parametrize("weights", ["model", "random"])
@pytest.mark.parametrize("dim,heads", BF16_WIDTHS)
def test_plain_bf16_aa_attention_meets_jax_and_the_wrong_chains_do_not(dim, heads, weights):
    """The plain K5b against JAX's bf16 ``aa_attention`` in interpret mode
    within ``BF16_BAR``; the f32 chain and K3b's rounding points fail it."""
    rng = np.random.default_rng(dim + heads)
    args = _inputs(rng, dim=dim)
    jpacked, tpacked = _packed("linen" if weights == "model" else "random", heads, dim, rng)
    want = np.asarray(_jax_bf16(dim, heads)(*(jnp.asarray(a) for a in args), jpacked))
    targs = tuple(torch.from_numpy(a) for a in args)
    got = K5.aa_attention(*targs, tpacked, heads, compute_dtype="bfloat16")
    assert got.dtype == torch.float32
    assert (got[:, :, ::7] == 0).all()                     # no sender: exactly 0
    port = bf16_distance(got, want)
    f32 = bf16_distance(K5.aa_attention(*targs, tpacked, heads), want)
    k3b = bf16_distance(_k3b_points(targs, tpacked, heads), want)
    print(f"max / mean |diff| over max / mean |JAX|: port {port[0]:.2e} / {port[1]:.2e}, f32 "
          f"{f32[0]:.2e} / {f32[1]:.2e}, K3b's points {k3b[0]:.2e} / {k3b[1]:.2e}")
    assert port[0] <= BF16_BAR[0] and port[1] <= BF16_BAR[1], port
    for wrong in (f32, k3b):
        assert wrong[0] > BF16_BAR[0] or wrong[1] > BF16_BAR[1], wrong
