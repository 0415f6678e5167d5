"""``adaptive: true`` in the port's SDE encoder vs the JAX package on the CPU:
one adaptive ``SDEGRUStep`` segment (f32, bf16, gradients), the encoder's
``forward`` and ``forward_ood``, and the whole flagship forward; then the
config, serving and a train step of the port alone.

JAX's adaptive step draws its Brownian tree from ``make_rng('sde')``; the
tests record each tree's nodes inside the JAX program
(``capture_adaptive_nodes``) and pin them in the port (``nodes`` /
``sde_nodes``).  Weights are the port's seeded init bridged into flax (a
fixed-grid tree: both solver modes share it).

Tolerances: a segment in f32 within 1e-5 of max|JAX| (measured 3.6e-7 of
2.1); in bf16 within ``MODULE_BAR`` of ``tests/test_torch_bf16.py``
(8e-3 of max|JAX|, 5e-4 of mean|JAX|), which the port in f32 must fail;
gradients by ``check_leaves`` (2e-3 x leaf scale + 1e-6); the encoder,
``forward_ood`` and the whole model within rtol 1e-4 / atol 1e-4, as
``tests/test_torch_model.py``.  The whole encoder's gradients compile for
about 40 s in JAX, so that case is ``slow`` (JAX's own adaptive-encoder
gradient test is too); tier 1 holds the gradients at the segment.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.models import sde as jsde
from trajsde_tpu.models.sde_encoder import LocalEncoderSDESep as JaxEncoder
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.models import sde as tsde
from trajsde_tpu_torch.serving import make_serving_fn
from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

from _torch_helpers import (ExperimentConfig, bf16_distance, capture_adaptive_nodes,
                            check_bf16, check_leaves, jax_build_model, jit_exact, noise_for,
                            scene_pair, small_cfg, t, torch_build_model)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_BAR = (8e-3, 5e-4)
BF = jnp.bfloat16
B, A, L, D, H = 2, 5, 6, 16, 2
N = 6                                   # rows of the one-segment cases
SEGMENT_RTOL = 1e-3                     # the flagship YAML's rtol and atol


def adaptive_cfg(Tf=12, **kw):
    cfg = small_cfg(D=D, H=H, Tf=Tf)
    cfg["encoder"]["kwargs"].update(adaptive=True, **kw)
    return cfg


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# one segment
# ---------------------------------------------------------------------------
def _segment_inputs(bf16):
    r = np.random.default_rng(0)
    h, obs = (r.standard_normal((N, D)).astype(np.float32) for _ in range(2))
    if bf16:   # bf16 numbers, so both packages start from the same state
        h, obs = (np.asarray(jnp.asarray(a).astype(BF).astype(jnp.float32)) for a in (h, obs))
    nus, obs_mask = np.array([1, 0, 1, 0, 1, 1], bool), np.array([1, 1, 0, 1, 1, 0], bool)
    return h, obs, nus, obs_mask


def _segment_weights():
    """The port's seeded init of a step plus N(0, 0.1) on every leaf, so
    every bias shows (a state_dict)."""
    m = tconfig.init_weights(tsde.SDEGRUStep(D, 2), seed=0)
    r = np.random.default_rng(1)
    return {k: v + 0.1 * t(r.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in m.state_dict().items()}


def _jax_segment_bf16():
    """(outputs (h_next, g) of JAX's adaptive step in bf16 on one segment,
    the tree nodes it drew, the state_dict of its weights)."""
    h, obs, nus, obs_mask = _segment_inputs(True)
    jm = jsde.SDEGRUStep(D, 2, dtype=BF, adaptive=True, rtol=SEGMENT_RTOL, atol=SEGMENT_RTOL)
    cast = lambda a: jnp.asarray(a).astype(BF)  # noqa: E731
    args = ((cast(h), jnp.asarray(nus)), (cast(obs), jnp.asarray(obs_mask), np.float32(0.1),
                                         np.float32(0.1)))
    sd = _segment_weights()
    params = {"params": params_to_flax(sd)}
    fn = lambda p, a, k: jm.apply(p, *a, rngs={"sde": k})[1]  # noqa: E731
    key = jax.random.key(5)
    with capture_adaptive_nodes() as rec:
        out = jit_exact(fn, params, args, key)(params, args, key)
        out = [np.asarray(o.astype(jnp.float32)) for o in out]
    (nodes,) = rec.stacked()
    return out, nodes[0], sd


def _port_segment(sd, nodes, rtol, dtype, grad=False):
    h, obs, nus, obs_mask = _segment_inputs(dtype is not None)
    m = tsde.SDEGRUStep(D, 2, adaptive=True, dtype=dtype, rtol=rtol, atol=rtol)
    m.load_state_dict(sd)
    cd = torch.bfloat16 if dtype else torch.float32
    hh = t(h).to(cd).requires_grad_(grad)
    out = m(hh, t(nus), t(obs).to(cd), t(obs_mask), torch.tensor(0.1), torch.tensor(0.1),
            nodes=t(nodes))
    return out, m, hh


def test_segment_matches_jax_bf16_and_f32_fails_the_bar():
    want, nodes, sd = _jax_segment_bf16()
    with torch.no_grad():
        got, _, _ = _port_segment(sd, nodes, SEGMENT_RTOL, "bfloat16")
        f32, _, _ = _port_segment(sd, nodes, SEGMENT_RTOL, None)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        check_bf16(g, w, MODULE_BAR, f"segment.{k}")
    dists = [bf16_distance(g, w) for g, w in zip(f32, want)]
    assert any(d[0] > MODULE_BAR[0] or d[1] > MODULE_BAR[1] for d in dists), dists


@functools.lru_cache(maxsize=None)
def _jax_segment_grads():
    """JAX's adaptive step in f32 on one segment: ((loss, (h_next, g)),
    (d loss / d params, d loss / d h)) for loss = sum(h_next^2) + sum(g),
    the tree nodes it drew and the weights' state_dict."""
    h, obs, nus, obs_mask = _segment_inputs(False)
    jm = jsde.SDEGRUStep(D, 2, adaptive=True, rtol=SEGMENT_RTOL, atol=SEGMENT_RTOL)
    sd = _segment_weights()
    key = jax.random.key(5)

    def loss(p, hh):
        _, (h1, g) = jm.apply(p, (hh, jnp.asarray(nus)), (jnp.asarray(obs), jnp.asarray(obs_mask),
                              np.float32(0.1), np.float32(0.1)), rngs={"sde": key})
        return jnp.sum(h1 ** 2) + jnp.sum(g), (h1, g)

    with capture_adaptive_nodes() as rec:
        out = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            {"params": params_to_flax(sd)}, jnp.asarray(h))
        out = jax.tree.map(np.asarray, out)
    (nodes,) = rec.stacked()
    return out, nodes[0], sd


def test_segment_matches_jax_f32():
    ((_, want), _), nodes, sd = _jax_segment_grads()
    with torch.no_grad():
        got, _, _ = _port_segment(sd, nodes, SEGMENT_RTOL, None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_segment_gradients_match_jax():
    """d(sum(h_next^2) + sum(g)) / d(params, h) through the bounded
    step-doubling loop: the error and the controller carry no gradient."""
    ((val, _), (gp, gh)), nodes, sd = _jax_segment_grads()
    (h1, g), m, hh = _port_segment(sd, nodes, SEGMENT_RTOL, None, grad=True)
    total = (h1 ** 2).sum() + g.sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(val), rtol=1e-5)
    want = {k: t(v) for k, v in params_from_flax(gp).items()}
    want["h"] = t(gh)
    got = {k: p.grad for k, p in m.named_parameters()}
    got["h"] = hh.grad
    check_leaves(got, want)


# ---------------------------------------------------------------------------
# the encoder and the whole model
# ---------------------------------------------------------------------------
def _jax_parts(m, scene, tw, de):
    local, d_in, d_out, _, _ = m.encoder(scene, True, None, tw)
    glob = m.aggregator(scene, local, True)
    out = m.decoder(scene, local, glob, True, de)
    ood_local, ood_std = m.encoder.forward_ood(scene)
    return dict(local=local, diff_in=d_in, diff_out=d_out, loc=out["loc"], pi=out["pi"],
                ood_local=ood_local, ood_std=ood_std)


@pytest.fixture(scope="module")
def run():
    cfg = adaptive_cfg(eval_iter=4)
    js, ts = scene_pair(7, B, A, L)
    tm = torch_build_model(cfg, device="cpu", seed=3)
    jm = jax_build_model(ExperimentConfig(cfg))
    params = {"params": params_to_flax(tm.state_dict())}
    _, tw, de = noise_for(cfg, B, A)
    with capture_adaptive_nodes() as rec:
        want = jax.jit(lambda p, s, a, b, k: jm.apply(p, s, a, b, method=_jax_parts,
                                                      rngs={"sde": k}))(
            params, js, tw, de, jax.random.key(4))
        want = jax.tree.map(np.asarray, want)
    nodes, ood_nodes = rec.stacked()    # the forward's trace first, then forward_ood's
    return dict(cfg=cfg, js=js, ts=ts, tm=tm, jm=jm, params=params, tw=t(tw), de=t(de),
                nodes=t(nodes), ood_nodes=t(ood_nodes), want=want)


@torch.no_grad()
def test_encoder_forward_matches_jax(run):
    w = run["want"]
    assert run["nodes"].shape == (21, 256, B, A + 1, D)
    local, d_in, d_out, _, _ = run["tm"].encoder(run["ts"], twin_noise=run["tw"],
                                                 sde_nodes=run["nodes"])
    _close(local, w["local"])
    _close(d_in, w["diff_in"])
    _close(d_out, w["diff_out"])


@torch.no_grad()
def test_whole_flagship_forward_matches_jax(run):
    tm, w = run["tm"], run["want"]
    local = tm.encoder(run["ts"], twin_noise=run["tw"], sde_nodes=run["nodes"])[0]
    glob = tm.aggregator(run["ts"], local)
    out = tm.decoder(run["ts"], local, glob, sde_noise=run["de"])
    _close(out["loc"], w["loc"])
    _close(out["pi"], w["pi"])


@torch.no_grad()
def test_forward_ood_matches_jax(run):
    """The ensemble of 4 folded into the batch: one ODE-RNN run over 4B rows,
    member e's trees at rows [e * B, (e + 1) * B) of ``sde_nodes``."""
    w = run["want"]
    assert run["ood_nodes"].shape == (21, 256, 4 * B, A, D)
    local, std = run["tm"].encoder.forward_ood(run["ts"], sde_nodes=run["ood_nodes"])
    _close(local, w["ood_local"])
    _close(std, w["ood_std"])


@torch.no_grad()
def test_forward_ood_in_chunks_takes_its_rows_of_the_pinned_nodes():
    """``ood_chunk`` 2 of 4 members: chunk c runs members 2c and 2c + 1 on
    rows [2cB, (2c + 2)B) of ``sde_nodes``.  Each chunk takes its own steps
    (the error is over the rows run together), so the tolerances here are
    wide enough that every step is accepted at the controller's sizes, and
    the chunked run is then the unchunked one."""
    _, ts = scene_pair(9, B, A, L)
    kw = dict(eval_iter=4, rtol=1e3, atol=1e3)
    whole = torch_build_model(adaptive_cfg(**kw), device="cpu", seed=4).encoder
    chunked = torch_build_model(adaptive_cfg(ood_chunk=2, **kw), device="cpu", seed=4).encoder
    nodes = torch.randn((21, 256, 4 * B, A, D), generator=torch.Generator().manual_seed(5))
    for g, w in zip(chunked.forward_ood(ts, sde_nodes=nodes),
                    whole.forward_ood(ts, sde_nodes=nodes)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_encoder_gradients_match_jax(run):
    """The loss of ``tests/test_parity_fixes.py::test_sde_encoder_adaptive``
    through the whole adaptive encoder, every leaf by ``check_leaves``."""
    enc_cfg = dict(run["cfg"]["encoder"]["kwargs"], dropout=0.0)
    jenc = JaxEncoder(**{k: v for k, v in enc_cfg.items() if k != "parallel"})
    tenc = tconfig.build("LocalEncoderSDESep", enc_cfg)
    sd = {k[len("encoder."):]: v for k, v in run["tm"].state_dict().items()
          if k.startswith("encoder.")}
    tenc.load_state_dict(sd)
    p = {"params": params_to_flax(sd)}
    tw = run["tw"].numpy()

    def loss(params, k):
        out, d_in, d_out, _, _ = jenc.apply(params, run["js"], True, None, tw, rngs={"sde": k})
        return jnp.sum(out ** 2) + jnp.sum(d_in) + jnp.sum(d_out)

    with capture_adaptive_nodes() as rec:
        val, grads = jax.jit(jax.value_and_grad(loss))(p, jax.random.key(2))
        grads = jax.tree.map(np.asarray, grads)
    (nodes,) = rec.stacked()
    out, d_in, d_out, _, _ = tenc(run["ts"], twin_noise=run["tw"], sde_nodes=t(nodes))
    total = (out ** 2).sum() + d_in.sum() + d_out.sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(val), rtol=1e-5)
    want = {k: t(v) for k, v in params_from_flax(grads).items()}
    check_leaves({k: q.grad for k, q in tenc.named_parameters()}, want)


# ---------------------------------------------------------------------------
# the port alone: config, noise, serving, training
# ---------------------------------------------------------------------------
def test_config_builds_adaptive_honours_rtol_atol_and_loads_a_fixed_grid_state():
    kw = dict(tconfig.FLAGSHIP["encoder"]["kwargs"], adaptive=True, rtol=0.02, atol=0.005)
    enc = tconfig.build("LocalEncoderSDESepPara2", kw)
    assert enc.adaptive and enc.sde_rnn.adaptive
    assert (enc.sde_rnn.rtol, enc.sde_rnn.atol, enc.sde_rnn.adaptive_max_steps) == (0.02, 0.005, 8)
    fixed = tconfig.build("LocalEncoderSDESepPara2", tconfig.FLAGSHIP["encoder"]["kwargs"])
    assert list(fixed.state_dict()) == list(enc.state_dict())
    enc.load_state_dict(fixed.state_dict(), strict=True)
    # the decoder's solver knobs stay dropped: JAX's SDEDecoder never reads them
    dec = tconfig.build("SDEDecoder", dict(tconfig.FLAGSHIP["decoder"]["kwargs"], rtol=0.5,
                                           atol=0.5, min_stepsize=0.3))
    assert not hasattr(dec, "rtol") and not hasattr(dec, "min_stepsize")


def test_adaptive_refuses_sde_noise_and_fixed_grid_refuses_nodes():
    _, ts = scene_pair(1, 1, 3, 4)
    ada = torch_build_model(adaptive_cfg(), device="cpu").encoder
    fixed = torch_build_model(small_cfg(D=D, H=H), device="cpu").encoder
    with pytest.raises(NotImplementedError, match="sde_noise requires the fixed-grid path"):
        ada(ts, sde_noise=torch.zeros(21, 1, 4, D))
    with pytest.raises(ValueError, match="sde_nodes"):
        fixed(ts, sde_nodes=torch.zeros(21, 256, 1, 4, D))
    with pytest.raises(ValueError, match="sde_nodes"):
        fixed.forward_ood(ts, sde_nodes=torch.zeros(21, 256, 10, 3, D))


@torch.no_grad()
def test_generator_draws_each_segments_nodes_after_the_twin():
    """Twin noise first, then segment k's nodes in iteration order (eval
    mode: no dropout masks between them)."""
    _, ts = scene_pair(2, B, A, L)
    enc = torch_build_model(adaptive_cfg(), device="cpu", seed=1).encoder
    got = enc(ts, generator=torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(11)
    tw = torch.randn((B, 1, 21, 2), generator=gen)
    nodes = torch.stack([torch.randn((256, B, A + 1, D), generator=gen) for _ in range(21)])
    want = enc(ts, twin_noise=tw, sde_nodes=nodes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_served_and_trained_adaptive_model_on_the_cpu():
    """The kernel serving path (plain K1 on the CPU) and one train step:
    finite outputs, finite non-zero gradients on the three SDE nets."""
    cfg = adaptive_cfg(Tf=60)
    cfg["decoder"]["kwargs"]["fused"] = True
    _, ts = scene_pair(3, B, A, L)
    model = torch_build_model(cfg, device="cpu", seed=2)
    out = make_serving_fn(model, "cpu")(ts, 0, generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("loc", "pi"))
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=0)
    step = make_train_step(model, state.optimizer, state.scheduler, tconfig.build_losses(cfg),
                           torch.device("cpu"))
    before = copy.deepcopy(model.encoder.sde_rnn.state_dict())
    logs = step(ts, 0, 0)
    assert np.isfinite(float(logs["train/total"])) and logs["train/step_skipped"] == 0.0
    rnn = model.encoder.sde_rnn
    for net in (rnn.f_func, rnn.g_nus, rnn.g_argo):
        grads = [p.grad for p in net.parameters()]
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
        assert any(float(g.abs().max()) > 0 for g in grads)
    after = rnn.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
