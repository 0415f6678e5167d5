"""The fused AA pair chain (kernel K3's plain version) and the port's
``encoder.fused: true`` path vs the JAX package on the CPU.

The JAX side runs as ``tests/test_aa_fused.py`` runs it: the Pallas op in
interpret mode; the plain K3 at the JAX tests' width (D 16, 4 heads) and
the kernels' own (D 64 at 8 and 4 heads).  Tolerances: the packed weights
are exact (the same numbers moved); ``build_pair_features`` 1e-6 (four
f32 products);
the plain K3 rtol 1e-5 / atol 1e-6 (the same f32 chain, summed in another
order); one ``AAEncoder`` 1e-5; the SDE encoder and the whole model 1e-4
(21 ODE-RNN and 60 rollout steps; LayerNorm statistics by matmul in the
JAX encoder's ``ln_mm`` mode).
"""
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.config import ExperimentConfig
from trajsde_tpu.models.local_encoder import AAEncoder as JaxAAEncoder
from trajsde_tpu.ops.pallas import aa_fused as jax_k3
from trajsde_tpu.ops.pallas.aa_attention import pack_aa_params as jax_pack_aa_params
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.models.local_encoder import AAEncoder
from trajsde_tpu_torch.ops import aa_fused as K3
from trajsde_tpu_torch.serving import make_serving_fn

from _torch_helpers import (FLAGSHIP, jax_build_model, jax_forward, model_pair, noise_for,
                            scene_pair, small_cfg, t)

torch.set_num_threads(1)
TOL_CHAIN = dict(rtol=1e-5, atol=1e-6)
TOL_LAYER = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)


def fused_cfg(cfg):
    out = copy.deepcopy(cfg)
    out["encoder"]["kwargs"]["fused"] = True
    return out


def _aa_inputs(r, B=2, T=3, Aq=5, Ak=4):
    """numpy AAEncoder inputs with one receiver that has no sender."""
    x_q = r.normal(0, 2, (B, T, Aq, 2)).astype(np.float32)
    x_k = r.normal(0, 2, (B, T, Ak, 2)).astype(np.float32)
    ang = r.uniform(-np.pi, np.pi, (B, Aq))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2).astype(np.float32)
    bos = r.uniform(size=(B, Aq, T)) < 0.2
    mask = r.uniform(size=(B, T, Aq, Ak)) < 0.6
    mask[0, 1, 2] = False
    edge = r.normal(0, 10, (B, T, Aq, Ak, 2)).astype(np.float32)
    return x_q, x_k, rot, bos, mask, edge


def _encoders(D=16, H=4, T=3, fused=True, seed=0):
    """(JAX AAEncoder, its params, the port's AAEncoder with the same weights)."""
    r = np.random.default_rng(seed)
    inputs = _aa_inputs(r, T=T)
    jenc = JaxAAEncoder(historical_steps=T, embed_dim=D, num_heads=H, fused=fused, rows_fwd=8)
    params = jenc.init(jax.random.key(seed), *map(jnp.asarray, inputs))["params"]
    tenc = AAEncoder(T, D, H, fused=fused)
    tenc.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jenc, params, tenc.eval(), inputs


def _random_ws(r, D=16):
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wkv=(D, 2 * D), bkv=(1, 2 * D))
    return tuple((r.standard_normal(shapes[k]) * (0.3 if k[0] == "w" else 1.0))
                 .astype(np.float32) for k in K3.W_ORDER)


# --------------------------------------------------------------------------
# packed parameters and pair features
# --------------------------------------------------------------------------
def test_w_order_matches_jax():
    assert K3.W_ORDER == jax_k3.W_ORDER
    assert K3.NEG == jax_k3.NEG


def test_pack_aa_params_matches_jax_exactly():
    _, params, tenc, _ = _encoders()
    want = jax_pack_aa_params(params)
    got = K3.pack_aa_params(tenc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(want["w1"][:16, 16:], 0.0)  # the JAX layout is block-diagonal


def test_pack_aa_params_keeps_the_graph_when_asked():
    _, _, tenc, _ = _encoders()
    assert not any(v.requires_grad for v in K3.pack_aa_params(tenc).values())
    packed = K3.pack_aa_params(tenc, detach=False)
    assert all(v.requires_grad for v in packed.values())
    sum(v.sum() for v in packed.values()).backward()
    for lin in (tenc.nbr_embed.in0_dense0, tenc.nbr_embed.in1_dense1, tenc.attn.lin_v):
        assert torch.equal(lin.weight.grad, torch.ones_like(lin.weight))


def test_build_pair_features_matches_jax():
    x_q, x_k, rot, _, _, edge = _aa_inputs(np.random.default_rng(1))
    want = jax_k3.build_pair_features(jnp.asarray(x_k), jnp.asarray(edge), jnp.asarray(rot))
    got = K3.build_pair_features(t(x_k), t(edge), t(rot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the plain K3
# --------------------------------------------------------------------------
# (weights, with_keep, D, H): the JAX tests' width (D 16, 4 heads), then
# the kernels' own, D 64 at the flagship's 8 heads and the baseline's 4
CHAIN_CASES = [pytest.param(w, k, d, h, id=f"{w}-{k}" + ("" if d == 16 else f"-D{d}-H{h}"))
               for d, h in ((16, 4), (64, 8), (64, 4))
               for w in ("model", "random") for k in (False, True)]


@pytest.mark.parametrize("weights,with_keep,D,H", CHAIN_CASES)
def test_plain_k3_matches_jax(weights, with_keep, D, H):
    """Aq != Ak, T*Aq = 15 rows padded to two tiles of 8 by JAX, one empty
    receiver; the model's block-diagonal weights and fully random ones."""
    B, T, Aq, Ak, p = 2, 3, 5, 4, 0.1
    r = np.random.default_rng(2)
    if weights == "model":
        _, params, _, _ = _encoders(D, H, T)
        packed = jax_pack_aa_params(params)
        ws = tuple(np.asarray(packed[k], np.float32) for k in K3.W_ORDER)
    else:
        ws = _random_ws(r, D)
    q = r.standard_normal((B, T, Aq, D)).astype(np.float32)
    u = (r.standard_normal((B, T, Aq, Ak, 4)) * 3).astype(np.float32)
    mask = (r.uniform(size=(B, T, Aq, Ak)) < 0.6).astype(np.float32)
    mask[1, 2, 4] = 0.0
    keep = (r.uniform(size=(B, T, Aq, Ak, H)) >= p).astype(np.float32) if with_keep else None
    cfg = jax_k3.FusedCfg(Aq=Aq, Ak=Ak, D=D, H=H, rows_fwd=8, rows_bwd=8, dropout_rate=p,
                          dtype="float32", interpret=True)
    jkeep = None if keep is None else jnp.asarray(keep)
    jws = tuple(map(jnp.asarray, ws))
    want = np.asarray(jax_k3.fused_pair_attention(cfg, jnp.asarray(q), jnp.asarray(u),
                                                  jnp.asarray(mask), jkeep, jws))
    want_ref = np.asarray(jax_k3.reference_pair_attention(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(mask), jkeep, jws, Ak=Ak, H=H,
        dropout_rate=p))
    got = K3.fused_pair_attention(t(q), t(u), t(mask), None if keep is None else t(keep),
                                  tuple(map(t, ws)), H, p).numpy()
    assert np.all(got[1, 2, 4] == 0.0)          # no sender: exactly 0, not NaN
    np.testing.assert_allclose(got, want, **TOL_CHAIN)
    np.testing.assert_allclose(got, want_ref, **TOL_CHAIN)


def test_plain_k3_on_cpu_counts_no_launch_and_is_differentiable():
    r = np.random.default_rng(3)
    ws = tuple(t(w).requires_grad_() for w in _random_ws(r))
    q = torch.randn((1, 2, 3, 16), requires_grad=True)
    u = torch.randn((1, 2, 3, 4, 4))
    mask = torch.ones((1, 2, 3, 4))
    before = K3.fused_pair_attention.launches
    K3.fused_pair_attention(q, u, mask, None, ws, 4).sum().backward()
    assert K3.fused_pair_attention.launches == before
    assert q.grad is not None and all(w.grad is not None for w in ws)


@pytest.mark.parametrize("with_stats", [False, True])
def test_registered_k3_op_on_cpu_is_the_plain_version(with_stats):
    """``trajsde::aa_fused_fwd`` on CPU tensors gives the plain chain's
    ``out`` bits and, with ``with_stats``, K3's statistics ``[2, R, H]``:
    each (receiver, head)'s largest unmasked logit (-inf for a receiver with
    no sender) and its sum of exp, at least 1 (the largest term) and at
    most Ak; without, an empty tensor."""
    B, T, Aq, Ak, H = 1, 2, 3, 4, 4
    r = np.random.default_rng(5)
    ws = tuple(map(t, _random_ws(r)))
    q, u = torch.randn((B, T, Aq, 16)), torch.randn((B, T, Aq, Ak, 4))
    mask = torch.from_numpy((r.uniform(size=(B, T, Aq, Ak)) < 0.6).astype(np.float32))
    mask[0, 1, 2] = 0.0
    out, stats = torch.ops.trajsde.aa_fused_fwd(q, u, mask, None, list(ws), H, 0.0, with_stats)
    assert torch.equal(out, K3.fused_pair_attention_reference(q, u, mask, None, ws, H))
    if not with_stats:
        assert stats.shape == (0,)
        return
    assert stats.shape == (2, B * T * Aq, H)
    empty = mask.reshape(-1, Ak).sum(-1) == 0
    assert bool(empty[5]) and (stats[0, empty] == -torch.inf).all()
    assert (stats[1, empty] == 0).all()
    assert ((stats[1, ~empty] >= 1) & (stats[1, ~empty] <= Ak)).all()
    assert torch.isfinite(stats[0, ~empty]).all()


# --------------------------------------------------------------------------
# the encoder layers
# --------------------------------------------------------------------------
@torch.no_grad()
def test_fused_aa_encoder_matches_jax_and_the_dense_path():
    jenc, params, tenc, inputs = _encoders()
    want = np.asarray(jenc.apply({"params": params}, *map(jnp.asarray, inputs)))
    targs = [t(a) for a in inputs]
    got = tenc(*targs).numpy()
    np.testing.assert_allclose(got, want, **TOL_LAYER)
    dense = AAEncoder(3, 16, 4)
    dense.load_state_dict(tenc.state_dict())
    np.testing.assert_allclose(got, dense.eval()(*targs).numpy(), **TOL_LAYER)


def test_fused_aa_encoder_train_mode_draws_keep_from_the_generator():
    """Training mode: the keep mask [B, T, Aq, Ak, H] is the caller's
    generator's first draw (``rand >= p``), the output dropout its next;
    gradients reach the pair-chain weights through the plain version."""
    _, _, tenc, inputs = _encoders()
    tenc.attn.rate = tenc.mlp.rate = 0.25
    targs = [t(a) for a in inputs]
    out = tenc.train()(*targs, generator=torch.Generator().manual_seed(5))

    g = torch.Generator().manual_seed(5)
    mask = targs[4]
    keep = (torch.rand(mask.shape + (4,), generator=g) >= 0.25).float()
    x_q_local = torch.einsum("btaj,baji->btai", targs[0], targs[2])
    center = tenc.center_embed(x_q_local)
    center = torch.where(targs[3].permute(0, 2, 1)[..., None],
                         tenc.bos_token[None, :, None, :], center)
    normed = tenc.norm1(center)
    u = K3.build_pair_features(targs[1], targs[5], targs[2])
    agg = K3.fused_pair_attention_reference(
        tenc.attn.lin_q(normed), u, mask.float(), keep,
        K3.weights_of(K3.pack_aa_params(tenc)), 4, 0.25)
    center = center + tenc.attn.update(normed, agg, g)
    want = center + tenc.mlp(tenc.norm2(center), g)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)

    out.sum().backward()
    assert tenc.nbr_embed.in1_dense0.weight.grad.abs().sum() > 0
    assert tenc.attn.lin_k.weight.grad.abs().sum() > 0


def test_fused_with_neighbor_cap_raises():
    with pytest.raises(NotImplementedError, match="dense pair chain"):
        AAEncoder(21, 64, 8, fused=True, neighbor_cap=24)
    assert AAEncoder(21, 64, 8, neighbor_cap=24).neighbor_cap == 24   # the dense path takes it
    kw = dict(FLAGSHIP["encoder"]["kwargs"], fused=True, neighbor_cap=24)
    with pytest.raises(NotImplementedError, match="dense pair chain"):
        tconfig.build("LocalEncoderSDESepPara2", kw)


def test_fused_and_dense_models_share_every_parameter():
    dense = tconfig.build_model(small_cfg(), device="cpu", seed=4).state_dict()
    fused = tconfig.build_model(fused_cfg(small_cfg()), device="cpu", seed=4).state_dict()
    assert list(dense) == list(fused)
    for k in dense:
        assert dense[k].shape == fused[k].shape and torch.equal(dense[k], fused[k]), k


def test_flagship_fused_is_the_flagship_with_the_fused_encoder():
    assert tconfig.FLAGSHIP_FUSED == fused_cfg(tconfig.FLAGSHIP)
    model = tconfig.build_model(tconfig.FLAGSHIP_FUSED, device="cpu")
    assert model.encoder.aa_encoder.fused
    assert not tconfig.build_model(tconfig.FLAGSHIP, device="cpu").encoder.aa_encoder.fused


# --------------------------------------------------------------------------
# the SDE encoder and the whole model
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = fused_cfg(small_cfg())
    js, ts = scene_pair(11, 2, 5, 6)
    jm, params, tm = model_pair(cfg, js)
    return dict(cfg=cfg, js=js, ts=ts, jm=jm, params=params, tm=tm)


@torch.no_grad()
def test_fused_sde_encoder_matches_jax(tiny):
    cfg, B, A = tiny["cfg"], 2, 5
    en, tw, _ = noise_for(cfg, B, A)
    want = jax.jit(lambda p, s: tiny["jm"].apply(
        p, s, method=lambda m, sc: m.encoder(sc, True, en, tw)))(tiny["params"], tiny["js"])
    got = tiny["tm"].encoder(tiny["ts"], sde_noise=t(en), twin_noise=t(tw))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_MODEL)


@torch.no_grad()
def test_fused_ood_forward_matches_jax(tiny):
    """As ``test_torch_model.py``'s OOD test: diffusion output biases pushed
    to -1e4 make both packages deterministic."""
    cfg = copy.deepcopy(tiny["cfg"])
    cfg["encoder"]["kwargs"]["eval_iter"] = 4
    jm, params, tm = model_pair(cfg, tiny["js"])
    params = flax.core.unfreeze(params)
    for path in (("encoder", "sde_rnn", "g_nus"), ("encoder", "sde_rnn", "g_argo"),
                 ("decoder", "sde_rollout", "g_func")):
        node = params["params"]
        for key in path:
            node = node[key]
        node["dense_out"]["bias"] = node["dense_out"]["bias"] - 1e4
    want = jax.jit(lambda p, s: jm.apply(p, s, ood=True, rngs={"sde": jax.random.key(4)}))(
        params, tiny["js"])
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    got = tm(tiny["ts"], ood=True, generator=torch.Generator().manual_seed(0))
    for k in ("loc", "pi", "stds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL_MODEL)


@pytest.mark.parametrize("size", ["tiny", "shipped"])
@torch.no_grad()
def test_whole_fused_model_matches_jax(size):
    if size == "tiny":  # flax init, bridged into the port
        cfg, B, A, L = fused_cfg(small_cfg()), 2, 5, 6
        js, ts = scene_pair(12, B, A, L)
        jm, params, tm = model_pair(cfg, js)
    else:  # the port's seeded init at the shipped widths, bridged back into flax
        cfg, B, A, L = copy.deepcopy(tconfig.FLAGSHIP_FUSED), 2, 4, 6
        js, ts = scene_pair(12, B, A, L)
        jm = jax_build_model(ExperimentConfig(cfg))
        tm = tconfig.build_model(cfg, device="cpu", seed=3)
        params = {"params": params_to_flax(tm.state_dict())}
    en, tw, de = noise_for(cfg, B, A)
    want = jax_forward(jm, params, js, en, tw, de)
    got = tm(ts, enc_noise=t(en), twin_noise=t(tw), dec_noise=t(de))
    for k in ("loc", "pi", "reg_mask", "y", "diff_in", "diff_out"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL_MODEL, err_msg=k)


@torch.no_grad()
def test_serving_fn_over_the_fused_model_matches_the_dense_forward(tiny):
    cfg, B, A = tiny["cfg"], 2, 5
    dense = tconfig.build_model(small_cfg(), device="cpu")
    dense.load_state_dict(tiny["tm"].state_dict())
    en, tw, de = (t(a) for a in noise_for(cfg, B, A))
    want = dense(tiny["ts"], enc_noise=en, twin_noise=tw, dec_noise=de)
    Tf, K, D = de.shape[0], de.shape[2], de.shape[-1]
    got = make_serving_fn(tiny["tm"], "cpu")(tiny["ts"], 0, noise=de.reshape(Tf, B * K * A, D),
                                              sde_noise=en, twin_noise=tw)
    for k in ("loc", "pi"):
        torch.testing.assert_close(got[k], want[k], **TOL_MODEL)
