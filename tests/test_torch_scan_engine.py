"""The serving engine's ``scan`` engine (``trajsde_tpu/server.py``'s
``engine="scan"``) on the CPU: the model's own forward in eval mode behind
the same buckets, ``(seed, counter)`` stream, pipelined ``predict``,
``submit``, ``warmup``, ``stats`` and ``close``.

* the HiVT baseline (embed 32, 2 heads, 2 temporal layers, 3 modes) with
  the JAX baseline's weights: the port's engine, ``auto`` and ``scan``,
  within 1e-4 of JAX's ``engine="scan"`` on the same scenes; pipelined
  ``predict`` bit-equal to serial; ``submit`` equal to ``predict``;
* ``auto`` picks ``scan`` for the baseline and ``kernel`` for an SDE
  decoder; ``kernel`` on the baseline and ``ood=True`` without
  ``forward_ood`` raise;
* an SDE model under ``scan`` draws from a generator seeded with
  ``mix_seed(seed, counter)``, equal to its forward so seeded;
* ``serve_torch.py --engine scan`` (and ``auto``) on a ``CheckpointManager``
  checkpoint of the baseline equals an engine over its weights.

Every ``Future.result`` and join has a timeout.
"""
import json
import os

import numpy as np
import pytest
import torch

from trajsde_tpu.server import ServingEngine as JaxEngine
from trajsde_tpu_torch.data.pack import pack_scenes
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.ops.sde_rollout import mix_seed
from trajsde_tpu_torch.server import ServingEngine, align_scene, make_postprocess
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state

import serve_torch
from _torch_helpers import model_pair, scene_pair, small_baseline_cfg, small_cfg, torch_build_model

torch.set_num_threads(1)
A, L = 5, 6
WAIT_S = 120
KW = dict(device="cpu", num_actors=A, num_lanes=L, batch_buckets=(1, 2, 4))


@pytest.fixture(scope="module")
def baseline():
    js, _ = scene_pair(1, 2, A, L)
    jm, params, tm = model_pair(small_baseline_cfg(), js)
    return dict(jm=jm, params=params, tm=tm)


def _scenes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_raw_scene(rng, s % 2, num_actors=4, num_lanes=5) for s in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("engine", ["auto", "scan"])
def test_baseline_scan_engine_matches_jax(baseline, engine):
    scenes = _scenes(5)
    eng = ServingEngine(baseline["tm"], engine=engine, max_batch=2, seed=4, **KW)
    jeng = JaxEngine(baseline["jm"], baseline["params"]["params"], engine="scan",
                     num_actors=A, num_lanes=L, batch_buckets=(1, 2, 4), max_batch=2, seed=4)
    try:
        assert eng.engine == "scan"
        got, want = eng.predict(scenes), jeng.predict(scenes)
    finally:
        eng.close()
        jeng.close()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loc", "pi", "agent_world", "agent_pi"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0, atol=1e-4, err_msg=k)
        assert g["seq_id"] == w["seq_id"]


def test_baseline_pipelined_predict_is_bit_equal_to_serial_and_submit(baseline):
    """Five scenes at max_batch 2, pipelined and serial; one submitted
    scene equals its ``predict``; ``warmup`` leaves ``stats`` empty."""
    scenes = _scenes(5, seed=2)
    piped, serial = (ServingEngine(baseline["tm"], engine="scan", max_batch=2, seed=5, **KW)
                     for _ in range(2))
    one_a, one_b = (ServingEngine(baseline["tm"], engine="scan", seed=7, **KW) for _ in range(2))
    try:
        piped.warmup(scenes[0])
        serial.warmup(scenes[0])
        assert piped.stats()["served"] == 0
        _assert_same(piped.predict(scenes), serial.predict(scenes, pipeline=False))
        assert piped.stats()["served"] == serial.stats()["served"] == 5
        _assert_same([one_a.submit(scenes[3]).result(timeout=WAIT_S)], one_b.predict([scenes[3]]))
    finally:
        for e in (piped, serial, one_a, one_b):
            e.close()


def test_engine_choice_and_refusals(baseline):
    sde = torch_build_model(small_cfg(), device="cpu")
    eng = ServingEngine(sde, **KW)
    try:
        assert eng.engine == "kernel"
    finally:
        eng.close()
    with pytest.raises(NotImplementedError, match="scan engine"):
        ServingEngine(baseline["tm"], engine="kernel", **KW)
    with pytest.raises(ValueError, match="unknown serving engine"):
        ServingEngine(baseline["tm"], engine="stablehlo", **KW)
    with pytest.raises(ValueError, match="serves a loaded artifact"):
        ServingEngine(baseline["tm"], engine="exported", **KW)
    for engine in ("auto", "scan"):
        with pytest.raises(NotImplementedError, match="forward_ood"):
            ServingEngine(baseline["tm"], engine=engine, ood=True, **KW)


@torch.no_grad()
def test_sde_model_under_scan_draws_from_the_seed_and_counter():
    """Batch ``i`` of an engine seeded ``s`` is the model's forward with a
    generator seeded ``mix_seed(s, i)``; two such engines agree bit for bit;
    ``ood=True`` scores through the encoder's ensemble."""
    model = torch_build_model(small_cfg(), device="cpu", seed=3)
    scenes = _scenes(2, seed=4)
    a, b = (ServingEngine(model, engine="scan", max_batch=2, seed=9, **KW) for _ in range(2))
    ood = ServingEngine(model, engine="scan", ood=True, seed=9, **KW)
    try:
        got = a.predict(scenes)
        _assert_same(got, b.predict(scenes))
        scored = ood.predict(scenes)
    finally:
        for e in (a, b, ood):
            e.close()
    scene = pack_scenes([align_scene(s)[0] for s in scenes], A, L)
    out = model(scene, generator=torch.Generator().manual_seed(mix_seed(9, 1)),
                rollout_seed=mix_seed(9, 1))
    want = make_postprocess(True, 20)(scene, out)
    for i in range(2):
        np.testing.assert_array_equal(got[i]["agent_world"], want["agent_world"][i].numpy())
        np.testing.assert_array_equal(got[i]["loc"], want["loc"][i].numpy())
        assert scored[i]["ood_std"].shape == (A,) and np.isfinite(scored[i]["agent_std"])


@pytest.mark.parametrize("engine", ["scan", "auto"])
def test_serve_torch_scan_engine_on_a_checkpoint(baseline, tmp_path, engine, capsys):
    cfg = small_baseline_cfg()
    cfg["datamodule_specific"]["kwargs"].update(num_actors=A, num_lanes=L)
    cfg_path = tmp_path / "baseline.json"
    cfg_path.write_text(json.dumps(cfg))
    state = create_train_state(baseline["tm"], cfg["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(tmp_path / "run" / "checkpoints")).save(state, metric=None,
                                                                       step=2)
    src = tmp_path / "scenes"
    src.mkdir()
    scenes = _scenes(3, seed=6)
    for i, raw in enumerate(scenes):
        np.savez(src / f"s{i}.npz", **raw)
    out = tmp_path / "preds"
    stats = serve_torch.main(["-c", str(cfg_path), "--ckpt", ckpt, "--device", "cpu",
                              "--engine", engine, "--input-dir", str(src), "--output-dir",
                              str(out), "--max-batch", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats
    assert stats["served"] == 3
    model = torch_build_model(cfg, device="cpu", seed=1)
    CheckpointManager(str(tmp_path / "run" / "checkpoints")).restore_params(model, ckpt)
    eng = ServingEngine(model, engine="scan", device="cpu", num_actors=A, num_lanes=L,
                        max_batch=1)
    try:
        want = eng.predict(scenes)
    finally:
        eng.close()
    for i, w in enumerate(want):
        with np.load(out / f"s{i}_pred.npz") as z:
            for k in ("loc", "pi", "agent_world", "agent_pi"):
                np.testing.assert_array_equal(z[k], w[k], err_msg=k)
    assert sorted(os.listdir(out)) == [f"s{i}_pred.npz" for i in range(3)]
