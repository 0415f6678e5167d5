"""The port's serving path on the CPU (rollout K1 by its plain version).

* ``make_serving_fn`` equals the port's model forward given the same
  noise, the rollout's laid out as ``[Tf, B*F*A, D]`` (atol 1e-5: the
  same math with dense0 split into y / time-feature parts);
* the spliced path equals the JAX composition encoder -> aggregator ->
  fuse -> Pallas ``sde_rollout`` (interpret mode) -> decode (1e-4);
* ``make_postprocess`` equals JAX's on one output dict (1e-5);
* ``ServingEngine.predict(device="cpu")`` pads to buckets and returns the
  JAX engine's keys and shapes, deterministic per (seed, counter).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.data.synthetic import make_raw_scene
from trajsde_tpu.ops.pallas.sde_rollout import rollout_params_from_linen, sde_rollout as jax_rollout
from trajsde_tpu.server import ServingEngine as JaxEngine, make_postprocess as jax_post
from trajsde_tpu_torch.server import ServingEngine, make_postprocess, mix_seed
from trajsde_tpu_torch.serving import make_serving_fn

from _torch_helpers import model_pair, noise_for, scene_pair, small_cfg, t

torch.set_num_threads(1)
CFG, B, A, L = small_cfg(), 2, 5, 6
TF, K, D = 12, 3, 16


@pytest.fixture(scope="module")
def models():
    js, ts = scene_pair(1, B, A, L)
    jm, params, tm = model_pair(CFG, js)
    return dict(js=js, ts=ts, jm=jm, params=params, tm=tm)


def _rows(dec_noise):
    return dec_noise.reshape(TF, B * K * A, D)


@torch.no_grad()
def test_serving_fn_matches_model_forward(models):
    tm, ts = models["tm"], models["ts"]
    en, tw, de = (t(a) for a in noise_for(CFG, B, A))
    want = tm(ts, enc_noise=en, twin_noise=tw, dec_noise=de)
    got = make_serving_fn(tm, "cpu")(ts, 0, noise=_rows(de), sde_noise=en, twin_noise=tw)
    for k in ("loc", "pi", "reg_mask", "y"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_serving_fn_matches_jax_composition(models):
    jm, params = models["jm"], models["params"]
    en, tw, de = noise_for(CFG, B, A)
    kp = rollout_params_from_linen(params["params"]["decoder"]["sde_rollout"])

    def comp(m, scene, en, tw, noise):
        local = m.encoder(scene, True, en, tw)[0]
        glob = m.aggregator(scene, local, True)
        y0 = m.decoder.fuse(scene, local, glob)
        t0s, dts = m.decoder.time_grid()
        ys = jax_rollout(y0.reshape(-1, D), kp, t0s, dts, jnp.int32(0), num_steps=TF,
                         block_rows=8, interpret=True, noise=noise)
        sol = jnp.transpose(ys.reshape(TF, B, K, A, D), (1, 2, 3, 0, 4))
        return m.decoder.decode(scene, sol, local, glob)

    want = jax.jit(lambda *a: jm.apply(params, *a, method=comp))(
        models["js"], en, tw, _rows(de))
    with torch.no_grad():
        got = make_serving_fn(models["tm"], "cpu")(models["ts"], 0, noise=t(_rows(de)),
                                                   sde_noise=t(en), twin_noise=t(tw))
    for k in ("loc", "pi", "reg_mask"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("is_gtabs,slim", [(True, False), (False, False), (True, True)])
def test_postprocess_matches_jax(models, is_gtabs, slim):
    r = np.random.default_rng(2)
    out = dict(loc=r.standard_normal((B, K, A, TF, 4)).astype(np.float32),
               pi=r.standard_normal((B, A, K)).astype(np.float32),
               stds=r.uniform(size=(B, A)).astype(np.float32))
    want = jax_post(is_gtabs, 20, slim)(models["js"], {k: jnp.asarray(v) for k, v in out.items()})
    got = make_postprocess(is_gtabs, 20, slim)(models["ts"], {k: t(v) for k, v in out.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def _scenes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_raw_scene(rng, s % 2, num_actors=4, num_lanes=5) for s in range(n)]


@pytest.mark.parametrize("slim,ood", [(False, False), (True, True)])
def test_engine_results_match_jax_engine_contract(models, slim, ood):
    scenes = _scenes(3)  # 3 scenes -> bucket 4, padded with a copy of the last
    kw = dict(num_actors=A, num_lanes=L, batch_buckets=(1, 2, 4), slim=slim, ood=ood)
    jeng = JaxEngine(models["jm"], models["params"]["params"], engine="scan", **kw)
    try:
        want = jeng.predict(scenes)
    finally:
        jeng.close()
    got = ServingEngine(models["tm"], device="cpu", **kw).predict(scenes)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert np.shape(g[k]) == np.shape(w[k]), k
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_allclose(g["agent_pi"].sum(), 1.0, rtol=1e-5)
        assert np.isfinite(g["agent_world"]).all()


def test_engine_is_deterministic_per_seed_and_counter(models):
    scenes = _scenes(2, seed=1)
    mk = lambda seed: ServingEngine(models["tm"], device="cpu", num_actors=A,  # noqa: E731
                                    num_lanes=L, batch_buckets=(1, 2), seed=seed)
    e1, e2 = mk(7), mk(7)
    a, b = e1.predict(scenes), e2.predict(scenes)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["loc"], y["loc"])
        np.testing.assert_array_equal(x["agent_world"], y["agent_world"])
    nxt = e1.predict(scenes)  # the counter moved: new draws
    other = mk(8).predict(scenes)
    assert not np.allclose(nxt[0]["loc"], a[0]["loc"])
    assert not np.allclose(other[0]["loc"], a[0]["loc"])
    assert mix_seed(7, 1) != mix_seed(7, 2) != mix_seed(8, 1)


def test_engine_slim_equals_full(models):
    scenes = _scenes(3, seed=2)
    kw = dict(device="cpu", num_actors=A, num_lanes=L, batch_buckets=(4,), seed=3)
    full = ServingEngine(models["tm"], **kw).predict(scenes)
    slim = ServingEngine(models["tm"], slim=True, **kw).predict(scenes)
    for f, s in zip(full, slim):
        assert set(s) == {"agent_world", "agent_pi", "seq_id"}
        np.testing.assert_array_equal(f["agent_world"], s["agent_world"])
        np.testing.assert_array_equal(f["agent_pi"], s["agent_pi"])


def test_entry_points_default_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("the no-GPU refusal is what this test checks")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(models["tm"], num_actors=A, num_lanes=L)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_fn(models["tm"])
