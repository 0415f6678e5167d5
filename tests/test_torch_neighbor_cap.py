"""``neighbor_cap`` on the dense AA path vs the JAX package on the CPU.

The port's ``AAEncoder(neighbor_cap=K)`` gathers each receiver's K nearest
in-radius senders as ``trajsde_tpu/models/local_encoder.py`` does (the
lower index kept among equally far senders, as ``lax.top_k`` keeps it) and
sets ``aa_overflow_edges`` where JAX sows it.  Tolerances: one
``AAEncoder`` atol 2e-5, its gradients rtol 1e-4 / atol 1e-5 (as
``tests/test_attention_parity.py`` holds JAX's capped encoder to its dense
one); the encoders and the whole model 1e-4 (21 ODE-RNN and 60 rollout
steps in f32).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.config import ExperimentConfig
from trajsde_tpu.models.local_encoder import AAEncoder as JaxAAEncoder
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.models.local_encoder import AAEncoder, LocalEncoder

from _torch_helpers import (jax_build_model, jax_forward, noise_for, scene_pair,
                            small_baseline_cfg, small_cfg, t, torch_build_model)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LAYER = dict(atol=2e-5, rtol=0)
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
D, H, T = 16, 4, 3


def _inputs(seed, B=2, Aq=6, Ak=7, p=0.75):
    """numpy AAEncoder inputs: a random mask with one receiver that has no
    sender, and edge vectors in and beyond the radius."""
    r = np.random.default_rng(seed)
    x_q = r.normal(0, 2, (B, T, Aq, 2)).astype(np.float32)
    x_k = r.normal(0, 2, (B, T, Ak, 2)).astype(np.float32)
    ang = r.uniform(-np.pi, np.pi, (B, Aq))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2).astype(np.float32)
    bos = r.uniform(size=(B, Aq, T)) < 0.2
    mask = r.uniform(size=(B, T, Aq, Ak)) < p
    mask[0, 1, 2] = False
    edge = r.normal(0, 10, (B, T, Aq, Ak, 2)).astype(np.float32)
    return [x_q, x_k, rot, bos, mask, edge]


def _plant_ties(inputs, K):
    """In every row with more than K in-radius senders, move the sender at
    place K + 1 (by distance) to the distance of the one at place K, by a
    quarter turn of its edge vector (the same squares, so an exact tie in
    f32): which of the two the cap keeps is then the tie rule alone.
    Returns the number of rows tied."""
    mask, edge = inputs[4], inputs[5]
    d2 = (edge * edge).sum(-1)
    tied = 0
    for row in np.ndindex(mask.shape[:3]):
        senders = np.flatnonzero(mask[row])
        if len(senders) <= K:
            continue
        order = senders[np.argsort(d2[row][senders], kind="stable")]
        a, b = order[K - 1], order[K]
        edge[row + (b,)] = np.array([-edge[row + (a,)][1], edge[row + (a,)][0]], np.float32)
        tied += 1
    return tied


def _pair(inputs, cap, seed=0):
    """(JAX AAEncoder, its params, the port's AAEncoder with the same weights)."""
    jenc = JaxAAEncoder(historical_steps=T, embed_dim=D, num_heads=H, neighbor_cap=cap)
    params = jenc.init(jax.random.key(seed), *map(jnp.asarray, inputs))["params"]
    tenc = AAEncoder(T, D, H, neighbor_cap=cap).eval()
    tenc.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jenc, params, tenc


def _jax_run(jenc, params, inputs):
    """(output, sown aa_overflow_edges or None, parameter gradients of
    mean(out ** 2) as the port's state_dict)."""
    args = list(map(jnp.asarray, inputs))
    out, diags = jenc.apply({"params": params}, *args, mutable=["diagnostics"])
    sown = jax.tree.leaves(diags)
    loss = lambda p: jnp.mean(jenc.apply({"params": p}, *args) ** 2)  # noqa: E731
    grads = params_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    return np.asarray(out), (int(np.asarray(sown[0]).sum()) if sown else None), grads


def _port_run(tenc, inputs):
    tenc.zero_grad(set_to_none=True)
    out = tenc(*(t(a) for a in inputs))
    (out ** 2).mean().backward()
    return out.detach(), tenc.aa_overflow_edges, {n: p.grad for n, p in tenc.named_parameters()}


def _check_grads(got, want):
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(np.zeros_like(w) if g is None else g.numpy(), w.numpy(),
                                   **TOL_GRAD, err_msg=name)


def test_capped_aa_encoder_at_the_largest_degree_matches_jax_and_the_dense_path():
    inputs = _inputs(0, p=0.5)
    cap = int(inputs[4].sum(-1).max())
    assert 0 < cap < inputs[4].shape[-1]   # the cap shrinks the pair axis
    jenc, params, tenc = _pair(inputs, cap)
    want, sown, want_g = _jax_run(jenc, params, inputs)
    got, overflow, got_g = _port_run(tenc, inputs)
    np.testing.assert_allclose(got.numpy(), want, **TOL_LAYER)
    assert sown == 0 and overflow.ndim == 0 and int(overflow) == 0
    _check_grads(got_g, want_g)
    dense = AAEncoder(T, D, H).eval()
    dense.load_state_dict(tenc.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), dense(*(t(a) for a in inputs)).numpy(),
                                   **TOL_LAYER)
    assert dense.aa_overflow_edges is None


@pytest.mark.parametrize("cap", [2, 4])
def test_capped_aa_encoder_below_the_degree_with_planted_ties_matches_jax(cap):
    inputs = _inputs(1, p=0.9)
    tied = _plant_ties(inputs, cap)
    assert tied > 0
    jenc, params, tenc = _pair(inputs, cap, seed=1)
    want, sown, want_g = _jax_run(jenc, params, inputs)
    got, overflow, got_g = _port_run(tenc, inputs)
    deg = inputs[4].sum(-1)
    assert sown == int(overflow) == int(np.maximum(deg - cap, 0).sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL_LAYER)
    _check_grads(got_g, want_g)

    # the rule decides: with the senders in reverse order the other one of
    # each tied pair has the lower index and is kept, and the output moves
    # (the rest of the chain does not depend on the senders' order)
    rev = list(inputs)
    rev[1], rev[4], rev[5] = inputs[1][:, :, ::-1], inputs[4][..., ::-1], inputs[5][..., ::-1, :]
    with torch.no_grad():
        moved = tenc(*(t(a) for a in rev))
    assert (moved - got).abs().max() > 1e-3


def test_capped_aa_encoder_above_ak_is_the_dense_path():
    inputs = _inputs(2)
    capped = AAEncoder(T, D, H, neighbor_cap=7).eval()
    dense = AAEncoder(T, D, H).eval()
    dense.load_state_dict(capped.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(capped(*(t(a) for a in inputs)),
                                   dense(*(t(a) for a in inputs)), rtol=0, atol=0)
    assert capped.aa_overflow_edges is None


def test_the_overflow_count_stays_on_the_device_and_is_reset():
    """Each capped forward sets a 0-dim tensor (nothing reads it on the
    host); a forward whose key set fits the cap clears it."""
    inputs = _inputs(3, p=0.9)
    enc = AAEncoder(T, D, H, neighbor_cap=2).eval()
    with torch.no_grad():
        enc(*(t(a) for a in inputs))
        first = enc.aa_overflow_edges
        assert isinstance(first, torch.Tensor) and first.ndim == 0 and int(first) > 0
        enc(*(t(a) for a in _inputs(3, Ak=2)))
    assert enc.aa_overflow_edges is None


# ---------------------------------------------------------------------------
# both families' encoders and the whole flagship
# ---------------------------------------------------------------------------
def _capped(cfg, cap):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"]["kwargs"]["neighbor_cap"] = cap
    return cfg


def _model_pair(cfg, js, seed=0):
    """``model_pair`` without the ``diagnostics`` that a capped model sows
    at init."""
    jm = jax_build_model(ExperimentConfig(cfg))
    variables = jax.jit(jm.init)({"params": jax.random.key(seed), "sde": jax.random.key(1)}, js)
    params = {"params": variables["params"]}
    tm = torch_build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _sown(diags):
    leaves = jax.tree.leaves(diags)
    return int(sum(np.asarray(x).sum() for x in leaves)) if leaves else None


@pytest.mark.parametrize("cap", [2, 3])
@torch.no_grad()
def test_capped_sde_encoder_with_its_twin_row_matches_jax(cap):
    cfg, B, A = _capped(small_cfg(), cap), 2, 6
    js, ts = scene_pair(29, B, A, 6)   # in-radius degrees up to 5
    jm, params, tm = _model_pair(cfg, js)
    en, tw, _ = noise_for(cfg, B, A)
    want, diags = jax.jit(lambda p, s: jm.apply(
        p, s, method=lambda m, sc: m.encoder(sc, True, en, tw), mutable=["diagnostics"]))(
        params, js)
    got = tm.encoder(ts, sde_noise=t(en), twin_noise=t(tw))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_MODEL)
    overflow = int(tm.encoder.aa_encoder.aa_overflow_edges)
    assert overflow == _sown(diags) > 0


@pytest.mark.parametrize("cap", [2, 3])
@torch.no_grad()
def test_capped_baseline_local_encoder_matches_jax(cap):
    cfg, B, A = _capped(small_baseline_cfg(), cap), 2, 6
    js, ts = scene_pair(32, B, A, 6)   # in-radius degrees up to 5
    jm, params, tm = _model_pair(cfg, js)
    assert isinstance(tm.encoder, LocalEncoder)
    want, diags = jm.apply(params, js, method=lambda m, s: m.encoder(s, True),
                           mutable=["diagnostics"])
    got = tm.encoder(ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_MODEL)
    assert int(tm.encoder.aa_encoder.aa_overflow_edges) == _sown(diags) > 0


@torch.no_grad()
def test_whole_flagship_at_cap_24_matches_jax():
    """``FLAGSHIP_CAPPED`` (cap 24) at the shipped widths with 40 actors, so
    that some receivers have more than 24 in-radius senders: the port's
    seeded weights bridged into flax, pinned noise."""
    cfg, B, A, L = copy.deepcopy(tconfig.FLAGSHIP_CAPPED), 2, 40, 6
    js, ts = scene_pair(1, B, A, L)
    jm = jax_build_model(ExperimentConfig(cfg))
    tm = tconfig.build_model(cfg, device="cpu", seed=3)
    params = {"params": params_to_flax(tm.state_dict())}
    en, tw, de = noise_for(cfg, B, A)
    want = jax_forward(jm, params, js, en, tw, de)
    got = tm(ts, enc_noise=t(en), twin_noise=t(tw), dec_noise=t(de))
    for k in ("loc", "pi", "reg_mask", "y", "diff_in", "diff_out"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL_MODEL, err_msg=k)
    assert int(tm.encoder.aa_encoder.aa_overflow_edges) > 0


def test_flagship_capped_is_the_tpu_fast_yaml_in_f32():
    raw = tconfig.load_config(os.path.join(
        REPO, "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu_fast.yml"))
    for sec in ("encoder", "aggregator", "decoder"):
        assert raw[sec]["kwargs"]["dtype"] == "bfloat16"
        module = tconfig.build(raw[sec]["module_name"], raw[sec]["kwargs"])
        assert module.compute_dtype is torch.bfloat16
        raw[sec]["kwargs"]["dtype"] = "float32"
    assert tconfig.FLAGSHIP_CAPPED == raw
    model = tconfig.build_model(raw, device="cpu")
    assert model.encoder.aa_encoder.neighbor_cap == 24 and not model.encoder.aa_encoder.fused
