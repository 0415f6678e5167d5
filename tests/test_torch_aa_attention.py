"""The ``aa_attention`` op (kernel K5's plain version) and the packed AA
weights vs the JAX package on the CPU.

The JAX side is ``trajsde_tpu/ops/pallas/aa_attention.py``: its
``aa_attention_reference`` and the Pallas op in interpret mode, as
``tests/test_aa_kernel.py`` runs them, on inputs made the same way from a
seeded numpy generator.  Tolerances: the packed weights are exact (the same
numbers moved); the op rtol 2e-4 / atol 2e-5, the JAX test's own (about
1e-6 is observed: the same f32 chain summed in another order); a receiver
with no sender gives exactly 0.
"""
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

torch.set_num_threads(1)
D, H = 64, 8
TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(rng, B=2, T=5, Aq=9, Ak=8):
    """``test_aa_kernel.py``'s inputs (sender j sits near receiver j mod Aq),
    with every 7th receiver and (0, 0, 0) without a sender."""
    center = rng.normal(size=(B, T, Aq, D)).astype(np.float32)
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


def _linen_tree(heads=H):
    """The linen ``MultipleInputEmbedding`` + ``EdgeAttention`` pair's params."""
    p_mie = MultipleInputEmbedding(D).init(jax.random.key(3), [jnp.ones((1, 2)),
                                                               jnp.ones((1, 2))])
    p_attn = EdgeAttention(D, heads, dropout=0.0).init(
        jax.random.key(4), jnp.ones((1, D)), jnp.ones((1, 1), bool), kv_pair=jnp.ones((1, 1, D)))
    tree = {"nbr_embed": p_mie["params"], "attn": p_attn["params"]}
    return jax.tree.map(np.asarray, tree)


def _random_packed(rng):
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


def _packed(weights, heads=H):
    if weights == "random":
        return _random_packed(np.random.default_rng(11))
    tree = _linen_tree(heads)
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
    args = tuple(torch.from_numpy(a) for a in _inputs(rng))
    _, packed = _packed("linen")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        K5.aa_attention(*args, packed, H, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype"):
        K5.aa_attention(*args, packed, H, compute_dtype="float16")
