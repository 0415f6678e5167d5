"""The port's flagship model vs the JAX package on the CPU, with bridged
weights and pinned noise (twin [B,1,Th,2], encoder [Th,B,A+1,D], decoder
[Tf,B,F,A,D]), at tiny dims and at the shipped widths (D=64, H=8, Th=21,
Tf=60, K=10) with small B/A/L.

Each component gets the JAX model's own upstream outputs, so a mismatch
names its module.  Tolerance: rtol = atol = 1e-4 for whole-model outputs
(21 ODE-RNN and 60 rollout steps in f32; LayerNorm variance and
summation order differ between the frameworks).
"""
import flax
import jax
import numpy as np
import pytest
import torch

from trajsde_tpu_torch.bridge import params_to_flax

from _torch_helpers import FLAGSHIP, jax_build_model, ExperimentConfig, model_pair, noise_for, \
    scene_pair, small_cfg, t, torch_build_model

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = {"tiny": (small_cfg(), 2, 5, 6), "shipped": (FLAGSHIP, 2, 4, 6)}


def _jax_parts(m, scene, en, tw, de):
    local, d_in, d_out, _, _ = m.encoder(scene, True, en, tw)
    glob = m.aggregator(scene, local, True)
    out = m.decoder(scene, local, glob, True, de)
    out["y"] = m._rotated_y(scene)
    return dict(local=local, diff_in=d_in, diff_out=d_out, glob=glob,
                y0=m.decoder.fuse(scene, local, glob), out=out)


@pytest.fixture(scope="module", params=sorted(SIZES))
def run(request):
    cfg, B, A, L = SIZES[request.param]
    js, ts = scene_pair(7, B, A, L)
    if request.param == "tiny":  # flax init, bridged into the port
        jm, params, tm = model_pair(cfg, js)
    else:  # the port's seeded init, bridged back into flax
        jm = jax_build_model(ExperimentConfig(cfg))
        tm = torch_build_model(cfg, device="cpu", seed=3)
        params = {"params": params_to_flax(tm.state_dict())}
    en, tw, de = noise_for(cfg, B, A)
    parts = jax.jit(lambda p, s, a, b, c: jm.apply(p, s, a, b, c, method=_jax_parts))(
        params, js, en, tw, de)
    parts = jax.tree.map(np.asarray, parts)
    return dict(tm=tm, ts=ts, en=t(en), tw=t(tw), de=t(de), want=parts)


def _close(got, want):
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@torch.no_grad()
def test_encoder_matches_jax(run):
    r, w = run, run["want"]
    local, d_in, d_out, _, _ = r["tm"].encoder(r["ts"], sde_noise=r["en"], twin_noise=r["tw"])
    _close(local, w["local"])
    _close(d_in, w["diff_in"])
    _close(d_out, w["diff_out"])


@torch.no_grad()
def test_aggregator_matches_jax(run):
    r, w = run, run["want"]
    _close(r["tm"].aggregator(r["ts"], t(w["local"])), w["glob"])


@torch.no_grad()
def test_decoder_matches_jax(run):
    r, w = run, run["want"]
    dec = r["tm"].decoder
    local, glob = t(w["local"]), t(w["glob"])
    _close(dec.fuse(r["ts"], local, glob), w["y0"])
    out = dec(r["ts"], local, glob, sde_noise=r["de"])
    for k in ("loc", "pi", "reg_mask"):
        _close(out[k], w["out"][k])


@torch.no_grad()
def test_whole_model_matches_jax(run):
    r, w = run, run["want"]
    out = r["tm"](r["ts"], enc_noise=r["en"], twin_noise=r["tw"], dec_noise=r["de"])
    for k in ("loc", "pi", "reg_mask", "y"):
        _close(out[k], w["out"][k])
    _close(out["diff_in"], w["diff_in"])
    _close(out["diff_out"], w["diff_out"])
    assert float(out["label_in"].sum()) == 0.0 and float(out["label_out"].mean()) == 1.0


@torch.no_grad()
def test_ood_forward_matches_jax():
    """JAX's forward_ood takes no noise: with both encoder diffusion nets'
    output biases pushed to -1e4 (and the decoder's), every draw is
    multiplied by ~0 and both packages are deterministic."""
    cfg, B, A, L = SIZES["tiny"]
    cfg["encoder"]["kwargs"]["eval_iter"] = 4
    js, ts = scene_pair(9, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    params = flax.core.unfreeze(params)
    for path in (("encoder", "sde_rnn", "g_nus"), ("encoder", "sde_rnn", "g_argo"),
                 ("decoder", "sde_rollout", "g_func")):
        node = params["params"]
        for p in path:
            node = node[p]
        node["dense_out"]["bias"] = node["dense_out"]["bias"] - 1e4
    want = jax.jit(lambda p, s: jm.apply(p, s, ood=True, rngs={"sde": jax.random.key(4)}))(
        params, js)
    tm.load_state_dict({k: t(np.asarray(v)) for k, v in _flat(params["params"]).items()})
    got = tm(ts, ood=True, generator=torch.Generator().manual_seed(0))
    for k in ("loc", "pi", "stds"):
        _close(got[k], np.asarray(want[k]))
    assert got["stds"].shape == (B, A)


def _flat(tree):
    from trajsde_tpu_torch.bridge import params_from_flax

    return {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, tree)).items()}
