"""The bf16 models (``dtype: bfloat16`` on the encoder, the aggregator and
the decoder, as ``configs/nusargo/*_tpu.yml`` set it) vs the JAX
package's on the CPU: the SDE encoder (``forward`` and ``forward_ood``),
each component fed the JAX model's own upstream outputs, the whole
``PredictionModelSDENet`` and the baseline ``PredictionModel``, and the
serving paths.  Weights are a flax init bridged into the port, noise is
pinned, and the JAX side is compiled with XLA's excess precision off
(``jit_exact``).

Bars (``tests/test_torch_bf16.py`` gives the measure): a component fed
JAX's upstream outputs, ``COMPONENT_BAR`` = (8e-3, 5e-4), as one module;
the whole model, ``MODEL_BAR`` = max 2e-2 of max|JAX| and mean 2e-3 of
mean|JAX|, room for a bf16 rounding that lands on the other side of a tie
early and is carried by the attention layers after it.  Here every output
meets JAX's bits but ``loc``'s f32 scale column (6e-8, an ``elu`` in
another order); the port in f32 sits 6.1e-3 to 2.1e-2 off in the mean
and fails the bar (planted-fault cases below).
"""
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.ops.pallas.sde_rollout import rollout_params_from_linen, sde_rollout as jax_rollout
from trajsde_tpu_torch import serving as tserving
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.serving import make_scan_fn, make_serving_fn

from _torch_helpers import (bf16_cfg, bf16_distance, check_bf16, jit_exact, model_pair,
                            noise_for, scene_pair, small_baseline_cfg, small_cfg, t,
                            torch_build_model)

torch.set_num_threads(1)
COMPONENT_BAR = (8e-3, 5e-4)
MODEL_BAR = (2e-2, 2e-3)
B, A, L, D, H, TF, K = 2, 5, 6, 32, 4, 12, 3


def _parts(m, scene, en, tw, de):
    """Every stage of the JAX SDE model's forward, each from its own
    upstream."""
    local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
    glob = m.aggregator(scene, local, True)
    out = m.decoder(scene, local, glob, True, de)
    out["y"] = m._rotated_y(scene)
    return dict(local=local, diff_in=d_in, diff_out=d_out, glob=glob,
                y0=m.decoder.fuse(scene, local, glob), out=out)


@pytest.fixture(scope="module")
def sde():
    cfg = bf16_cfg(small_cfg(D=D, H=H, Tf=TF, K=K))
    js, ts = scene_pair(1, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    en, tw, de = noise_for(cfg, B, A)
    fn = lambda p, s, a, b, c: jm.apply(p, s, a, b, c, method=_parts)  # noqa: E731
    want = jit_exact(fn, params, js, en, tw, de)(params, js, en, tw, de)
    f32 = torch_build_model(small_cfg(D=D, H=H, Tf=TF, K=K), device="cpu")
    f32.load_state_dict(tm.state_dict())
    return dict(cfg=cfg, js=js, ts=ts, jm=jm, params=params, tm=tm, f32=f32,
                noise=(t(en), t(tw), t(de)), np_noise=(en, tw, de),
                want=jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
                                  if a.dtype != bool else np.asarray(a), want))


def _forward(model, r):
    en, tw, de = r["noise"]
    with torch.no_grad():
        return model(r["ts"], enc_noise=en, twin_noise=tw, dec_noise=de)


def test_sde_encoder_matches_jax(sde):
    en, tw, _ = sde["noise"]
    with torch.no_grad():
        local, d_in, d_out, l_in, l_out = sde["tm"].encoder(sde["ts"], sde_noise=en, twin_noise=tw)
    w = sde["want"]
    for name, got in (("local", local), ("diff_in", d_in), ("diff_out", d_out)):
        assert got.dtype == torch.float32
        check_bf16(got, w[name], COMPONENT_BAR, name)
    assert l_in.dtype == l_out.dtype == torch.float32


def test_aggregator_from_jax_local_matches_jax(sde):
    w = sde["want"]
    with torch.no_grad():
        glob = sde["tm"].aggregator(sde["ts"], t(w["local"]))
    assert glob.dtype == torch.float32
    check_bf16(glob, w["glob"], COMPONENT_BAR, "glob")


def test_decoder_from_jax_upstream_matches_jax(sde):
    """fuse (bf16 out), the loop rollout on the bf16 state, decode (f32 out)."""
    w, dec, de = sde["want"], sde["tm"].decoder, sde["noise"][2]
    local, glob = t(w["local"]), t(w["glob"])
    with torch.no_grad():
        y0 = dec.fuse(sde["ts"], local, glob)
        out = dec(sde["ts"], local, glob, sde_noise=de)
    assert y0.dtype == torch.bfloat16
    check_bf16(y0, w["y0"], COMPONENT_BAR, "y0")
    for k in ("loc", "pi"):
        assert out[k].dtype == torch.float32
        check_bf16(out[k], w["out"][k], COMPONENT_BAR, k)
    assert torch.equal(out["reg_mask"], t(w["out"]["reg_mask"]))


def test_whole_sde_model_matches_jax(sde):
    got, w = _forward(sde["tm"], sde), sde["want"]
    for k in ("loc", "pi"):
        check_bf16(got[k], w["out"][k], MODEL_BAR, k)
    for k in ("diff_in", "diff_out"):
        check_bf16(got[k], w[k], COMPONENT_BAR, k)
    np.testing.assert_allclose(got["y"].numpy(), w["out"]["y"], rtol=1e-6, atol=1e-6)  # f32
    for k in ("loc", "pi", "y", "diff_in", "diff_out", "label_in", "label_out"):
        assert got[k].dtype == torch.float32, k


def test_whole_sde_model_in_f32_fails_the_bf16_bar(sde):
    """The planted fault: the same weights and noise through the port in f32."""
    got, w = _forward(sde["f32"], sde), sde["want"]
    dists = [bf16_distance(got[k], w["out"][k]) for k in ("loc", "pi")]
    assert all(d[1] > MODEL_BAR[1] for d in dists), dists


def _silenced(params):
    """Both encoder diffusion nets' and the decoder's output biases pushed to
    -1e4: every draw is multiplied by 0, so forward_ood is deterministic."""
    params = flax.core.unfreeze(params)
    for path in (("encoder", "sde_rnn", "g_nus"), ("encoder", "sde_rnn", "g_argo"),
                 ("decoder", "sde_rollout", "g_func")):
        node = params["params"]
        for p in path:
            node = node[p]
        node["dense_out"]["bias"] = node["dense_out"]["bias"] - 1e4
    return params


def test_ood_forward_matches_jax():
    """``forward_ood`` in bf16: the ensemble's state, draws and mean in
    bf16, the embedding and the stds cast back to f32."""
    cfg = bf16_cfg(small_cfg(D=D, H=H, Tf=TF, K=K))
    cfg["encoder"]["kwargs"]["eval_iter"] = 4
    js, ts = scene_pair(9, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    params = _silenced(params)
    fn = lambda p, s: jm.apply(p, s, ood=True, rngs={"sde": jax.random.key(4)})  # noqa: E731
    want = jit_exact(fn, params, js)(params, js)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(ts, ood=True, generator=torch.Generator().manual_seed(0))
        local, stds = tm.encoder.forward_ood(ts, generator=torch.Generator().manual_seed(0))
    assert local.dtype == stds.dtype == got["stds"].dtype == torch.float32
    assert got["stds"].shape == (B, A)
    for k in ("loc", "pi"):
        check_bf16(got[k], np.asarray(want[k]), MODEL_BAR, k)
    np.testing.assert_array_equal(got["stds"].numpy(), np.asarray(want["stds"]))


@pytest.fixture(scope="module")
def baseline():
    cfg = bf16_cfg(small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0))
    js, ts = scene_pair(2, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    fn = lambda p, s: jm.apply(p, s)  # noqa: E731
    want = {k: np.asarray(v) for k, v in jit_exact(fn, params, js)(params, js).items()}
    f32 = torch_build_model(small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0), device="cpu")
    f32.load_state_dict(tm.state_dict())
    return dict(ts=ts, tm=tm, f32=f32, want=want)


def test_baseline_model_matches_jax(baseline):
    with torch.no_grad():
        got = baseline["tm"](baseline["ts"])
    for k in ("loc", "pi"):
        assert got[k].dtype == torch.float32
        check_bf16(got[k], baseline["want"][k], MODEL_BAR, k)


def test_baseline_model_in_f32_fails_the_bf16_bar(baseline):
    with torch.no_grad():
        got = baseline["f32"](baseline["ts"])
    dists = [bf16_distance(got[k], baseline["want"][k]) for k in ("loc", "pi")]
    assert all(d[1] > MODEL_BAR[1] for d in dists), dists


def test_kernel_serving_path_matches_the_jax_composition(sde, monkeypatch):
    """The kernel engine on the bf16 model: K1 (its plain version here)
    takes the fuse's bf16 output as f32 rows and ``decode`` takes its f32
    ``sol``, as JAX's serving method does (fuse -> f32 -> the Pallas
    rollout in interpret mode -> decode)."""
    jm, params = sde["jm"], sde["params"]
    en, tw, de = sde["np_noise"]
    rows = de.reshape(TF, B * K * A, D)
    kp = rollout_params_from_linen(params["params"]["decoder"]["sde_rollout"])

    def comp(p, scene, en, tw, noise):
        def f(m, scene):
            local = m.encoder(scene, True, en, tw)[0]
            glob = m.aggregator(scene, local, True)
            y0 = m.decoder.fuse(scene, local, glob)
            t0s, dts = m.decoder.time_grid()
            ys = jax_rollout(y0.reshape(-1, D).astype(jnp.float32), kp, t0s, dts, jnp.int32(0),
                             num_steps=TF, block_rows=8, interpret=True, noise=noise)
            sol = jnp.transpose(ys.reshape(TF, B, K, A, D), (1, 2, 3, 0, 4))
            return m.decoder.decode(scene, sol, local, glob)
        return jm.apply(p, scene, method=f)

    want = jit_exact(comp, params, sde["js"], en, tw, rows)(params, sde["js"], en, tw, rows)
    seen = []

    def spy(y0, *a, **kw):
        seen.append(y0.dtype)
        return rollout(y0, *a, **kw)

    rollout = tserving.sde_rollout
    monkeypatch.setattr(tserving, "sde_rollout", spy)
    got = make_serving_fn(sde["tm"], "cpu")(sde["ts"], 0, noise=t(rows), sde_noise=t(en),
                                            twin_noise=t(tw))
    assert seen == [torch.float32]
    for k in ("loc", "pi"):
        assert got[k].dtype == torch.float32
        check_bf16(got[k], np.asarray(want[k]), MODEL_BAR, k)


def test_scan_engine_serves_the_bf16_model(sde):
    """``make_scan_fn`` is the bf16 model's own forward in eval mode."""
    model = copy.deepcopy(sde["tm"])
    got = make_scan_fn(model, "cpu")(sde["ts"], 0, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = model(sde["ts"], generator=torch.Generator().manual_seed(3), rollout_seed=0)
    for k in ("loc", "pi", "diff_in", "diff_out"):
        assert got[k].dtype == torch.float32 and bool(torch.isfinite(got[k]).all())
        assert torch.equal(got[k], want[k])


def test_fused_decoder_hands_the_kernels_f32_and_returns_the_state_dtype(sde):
    """``fused_rollout`` casts a bf16 ``y0`` up for K1 (its plain version
    here) and hands ``ys`` back in bf16, as JAX's fused decoder does (one
    train step through it: ``tests/test_torch_bf16_train.py``)."""
    cfg = copy.deepcopy(sde["cfg"])
    cfg["decoder"]["kwargs"]["fused"] = True
    model = torch_build_model(cfg, device="cpu")
    model.load_state_dict(sde["tm"].state_dict())
    dec, w, de = model.decoder, sde["want"], sde["noise"][2]
    with torch.no_grad():
        y0 = dec.fuse(sde["ts"], t(w["local"]), t(w["glob"]))
        ys = dec.fused_rollout(y0, 0, noise=de.reshape(TF, -1, D))
    assert y0.dtype == ys.dtype == torch.bfloat16 and ys.shape == (TF,) + tuple(y0.shape)
    assert bool(torch.isfinite(ys.float()).all())
