"""Deployment artifacts of the port (``trajsde_tpu_torch/deploy.py``, the
counterpart of ``trajsde_tpu/deploy.py``) on the CPU, at small sizes (6
actors, 8 lanes, buckets 1 and 2):

* the manifest and the files (``tests/test_deploy.py``'s check);
* ``ServingEngine.from_export`` bit-equal to the port's live scan engine at
  the same seed and counter, for the SDE family with the rollout unfused
  (``dec_noise`` drawn outside the program) and fused with the fused AA
  encoder (``trajsde::sde_rollout`` and ``trajsde::aa_fused_fwd`` in the
  program, the rollout seed an input);
* the exported program with ``noise_for``'s pinned draws against JAX's
  forward and ``make_postprocess`` on the bridged weights, within 1e-4;
* the HiVT baseline (no draws in eval mode): JAX's ``export_serving`` /
  ``load_serving`` artifact and the port's, fed the same scenes, within
  1e-4;
* the schema guards with JAX's messages, a JAX artifact refused, the
  stale delta-mode artifact, the platforms, the adaptive encoder (item
  11b), ``ood`` / ``slim`` with ``engine="exported"``;
* a process that loads and serves an artifact imports no model code;
* the rollout seed is an input of the program, not a constant.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from trajsde_tpu.data.grid import align_to_grid as jax_align
from trajsde_tpu.data.pack import pack_scenes as jax_pack
from trajsde_tpu.deploy import export_serving as jax_export_serving
from trajsde_tpu.server import ServingEngine as JaxEngine
from trajsde_tpu.server import make_postprocess as jax_postprocess
from trajsde_tpu_torch.data.pack import pack_scenes
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.deploy import FORMAT, export_serving, load_serving
from trajsde_tpu_torch.server import ServingEngine, align_scene

from _torch_helpers import (jax_forward, model_pair, noise_for, scene_pair, small_baseline_cfg,
                            small_cfg, torch_build_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
A, L = 6, 8
BUCKETS = (1, 2)
TOL_JAX = 1e-4
WAIT_S = 300
KEYS = ("loc", "pi", "agent_world", "agent_pi", "seq_id")


def _raws(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_raw_scene(rng, s % 2, num_actors=5, num_lanes=6) for s in range(n)]


def _example(raw):
    return pack_scenes([align_scene(raw)[0]], A, L)


def _fused_cfg():
    cfg = small_cfg()
    cfg["encoder"]["kwargs"]["fused"] = True
    cfg["decoder"]["kwargs"]["fused"] = True
    return cfg


@pytest.fixture(scope="module")
def sde(tmp_path_factory):
    """The SDE family with the loop rollout, JAX's weights bridged; its
    artifact lists both platforms."""
    js, _ = scene_pair(1, 1, A, L)
    jm, params, tm = model_pair(small_cfg(), js)
    out = str(tmp_path_factory.mktemp("sde"))
    manifest = export_serving(tm, _example(_raws(1)[0]), out, buckets=BUCKETS,
                              platforms=["cpu", "cuda"])
    return dict(jm=jm, params=params, tm=tm, dir=out, manifest=manifest,
                exp=load_serving(out, device="cpu"))


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The fused AA encoder (K3's op) and the fused rollout (K1's op)."""
    model = torch_build_model(_fused_cfg(), device="cpu", seed=7)
    out = str(tmp_path_factory.mktemp("fused"))
    manifest = export_serving(model, _example(_raws(1)[0]), out, buckets=BUCKETS)
    return dict(model=model, dir=out, manifest=manifest, exp=load_serving(out, device="cpu"))


def _exported_engine(art, seed):
    """``ServingEngine.from_export``'s engine over an artifact loaded once
    (loading takes seconds of deserialization per bucket)."""
    exp = art["exp"]
    return ServingEngine(exp, device="cpu", num_actors=exp.num_actors, num_lanes=exp.num_lanes,
                         engine="exported", batch_buckets=exp.buckets, is_gtabs=exp.is_gtabs,
                         ref_time=exp.ref_time, seed=seed)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_manifest_and_files(sde, fused):
    m = sde["manifest"]
    assert m["format"] == FORMAT and m["buckets"] == [1, 2]
    assert m["num_actors"] == A and m["num_lanes"] == L
    assert m["platforms"] == ["cpu", "cuda"] and m["postprocess_rev"] == 2
    assert m["torch_version"] == torch.__version__
    for b in BUCKETS:
        assert os.path.exists(os.path.join(sde["dir"], f"bucket_{b}.pt2"))
        assert sde["exp"].programs[b].example_inputs is None   # no example tensors kept
    assert json.load(open(os.path.join(sde["dir"], "manifest.json"))) == m
    schema = {s["name"]: s for s in m["leaf_schema"]}
    assert [s["name"] for s in m["leaf_schema"]][:3] == ["x", "positions", "padding_mask"]
    assert schema["x"]["shape"] == [1, A, 21, 2] and schema["x"]["dtype"] == "float32"
    assert schema["goal_idcs"]["shape"] is None and schema["has_goal"]["shape"] is None
    assert [d["name"] for d in m["draws"]] == ["twin_noise", "enc_noise", "dec_noise"]
    assert m["ops"] == []
    f = fused["manifest"]
    assert [d["name"] for d in f["draws"]] == ["twin_noise", "enc_noise", "rollout_seed"]
    assert f["ops"] == ["trajsde::aa_fused_fwd", "trajsde::sde_rollout"]
    assert f["platforms"] == ["cpu"]


@pytest.mark.parametrize("which", ["sde", "fused"])
def test_exported_engine_is_the_live_scan_engine_bit_for_bit(sde, fused, which):
    """Same weights, same seed and counter: the artifact draws what the
    model draws, in its order, so loc, agent_world and agent_pi are the
    scan engine's bits (three scenes: a batch of 2, then one of 1)."""
    art = {"sde": sde, "fused": fused}[which]
    model = art.get("tm", art.get("model"))
    scenes = _raws(3, seed=4)
    live = ServingEngine(model, device="cpu", num_actors=A, num_lanes=L, engine="scan",
                         batch_buckets=BUCKETS, seed=5)
    exported = _exported_engine(art, 5)
    try:
        assert exported.engine == "exported" and exported.buckets == BUCKETS
        assert exported.max_batch == 2
        want = live.predict(scenes)
        got = exported.predict(scenes)
        one = exported.submit(scenes[0]).result(timeout=WAIT_S)
    finally:
        live.close()
        exported.close()
    _same(got, want)
    assert set(got[0]) == set(KEYS)
    assert np.isfinite(one["agent_world"]).all() and exported.stats()["served"] == 4


def test_exported_program_meets_jax_with_pinned_draws(sde):
    """The bucket-2 program fed ``noise_for``'s draws against JAX's forward
    with the same draws and JAX's postprocess, on JAX's packing of the same
    scenes, within 1e-4."""
    raws = _raws(2, seed=6)
    js = jax_pack([jax_align(dict(r, source=r["source"])) for r in raws], A, L)
    ts = pack_scenes([align_scene(r)[0] for r in raws], A, L)
    enc, twin, dec = noise_for(small_cfg(), 2, A)
    want = jax_forward(sde["jm"], sde["params"], js, enc, twin, dec)
    want = {k: np.asarray(v) for k, v in
            jax_postprocess(True, 20)(js, {k: jax.numpy.asarray(v) for k, v in want.items()
                                           if v is not None}).items()}
    got = sde["exp"](ts, 0, draws={"twin_noise": torch.from_numpy(twin),
                            "enc_noise": torch.from_numpy(enc), "dec_noise": torch.from_numpy(dec)})
    for k in ("agent_world", "agent_pi", "loc", "pi_all"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=TOL_JAX, err_msg=k)


def test_baseline_artifact_meets_jaxs_artifact(tmp_path):
    """The HiVT baseline draws nothing in eval mode: JAX's exported
    pipeline and the port's, on the bridged weights, answer the same
    scenes within 1e-4; the port refuses JAX's artifact directory."""
    js, _ = scene_pair(2, 1, A, L)
    jm, params, tm = model_pair(small_baseline_cfg(), js)
    raw = _raws(1)[0]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export_serving(jm, params["params"], jax_pack([jax_align(dict(raw, source=0))], A, L),
                       jax_dir, buckets=BUCKETS)
    m = export_serving(tm, _example(raw), port_dir, buckets=BUCKETS)
    assert m["draws"] == [] and m["ops"] == []
    scenes = _raws(3, seed=8)
    jeng = JaxEngine.from_export(jax_dir, seed=5)
    peng = ServingEngine.from_export(port_dir, device="cpu", seed=5)
    try:
        want, got = jeng.predict(scenes), peng.predict(scenes)
    finally:
        jeng.close()
        peng.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loc", "pi", "agent_world", "agent_pi"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0, atol=TOL_JAX, err_msg=k)
    with pytest.raises(ValueError, match="not a serving export"):
        load_serving(jax_dir, device="cpu")


def test_schema_guards(sde):
    exp = sde["exp"]
    raw = _raws(1)[0]
    with pytest.raises(ValueError, match="no exported bucket"):
        exp(pack_scenes([align_scene(raw)[0]] * 4, A, L), 0)
    with pytest.raises(ValueError, match="num_actors"):
        exp(pack_scenes([align_scene(raw)[0]], A + 2, L), 0)
    one = _example(raw)
    with pytest.raises(ValueError, match="leaf dtype"):
        exp(dataclasses.replace(one, x=one.x.double()), 0)
    with pytest.raises(ValueError, match="leaves but the artifact was exported"):
        exp(dataclasses.replace(one, y=None), 0)


def test_bad_manifest_and_platforms_rejected(sde, fused, tmp_path):
    os.makedirs(tmp_path / "x")
    (tmp_path / "x" / "manifest.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="not a serving export"):
        load_serving(str(tmp_path / "x"), device="cpu")
    # an artifact made for one platform never runs on another
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        load_serving(fused["dir"], device="cuda")
    bad = dict(json.load(open(os.path.join(fused["dir"], "manifest.json"))), platforms=["cuda"])
    shutil.copytree(fused["dir"], tmp_path / "cuda_only")
    (tmp_path / "cuda_only" / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
        load_serving(str(tmp_path / "cuda_only"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            load_serving(sde["dir"], device="cuda")
    with pytest.raises(ValueError, match="unknown platforms"):
        export_serving(sde["tm"], _example(_raws(1)[0]), str(tmp_path / "y"), platforms=["tpu"])


def test_stale_delta_mode_artifact_refused(sde, tmp_path):
    """A delta-mode artifact baked before postprocess rev 2 lacks the
    cumsum + grid-scale math in agent_world: loading it fails loudly."""
    stale = tmp_path / "stale"
    shutil.copytree(sde["dir"], stale)
    m = dict(sde["manifest"], is_gtabs=False)
    m.pop("postprocess_rev")  # pre-rev-2 manifests had no such field
    (stale / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="postprocess rev 1"):
        load_serving(str(stale), device="cpu")
    # gtabs artifacts from the same era are unaffected by the fix
    m2 = dict(sde["manifest"], buckets=[1])
    m2.pop("postprocess_rev")
    (stale / "manifest.json").write_text(json.dumps(m2))
    load_serving(str(stale), device="cpu")


def test_adaptive_encoder_export_is_refused_naming_item_11b(tmp_path):
    cfg = small_cfg()
    cfg["encoder"]["kwargs"]["adaptive"] = True
    model = torch_build_model(cfg, device="cpu", seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11b"):
        export_serving(model, _example(_raws(1)[0]), str(tmp_path / "a"), buckets=(1,))
    assert not os.path.exists(tmp_path / "a" / "manifest.json")


def test_ood_slim_and_a_live_model_refused_by_the_exported_engine(sde):
    exp = sde["exp"]
    kw = dict(device="cpu", num_actors=A, num_lanes=L, engine="exported")
    with pytest.raises(ValueError, match="ood=True needs the live model"):
        ServingEngine(exp, ood=True, **kw)
    with pytest.raises(ValueError, match="slim=True cannot shrink"):
        ServingEngine(exp, slim=True, **kw)
    with pytest.raises(ValueError, match="serves a loaded artifact"):
        ServingEngine(sde["tm"], **kw)


def test_serving_an_artifact_imports_no_model_code(fused, tmp_path):
    """In a fresh process, ``ServingEngine.from_export`` (``load_serving``)
    and its ``predict`` leave ``trajsde_tpu_torch.models`` and ``.config``
    unimported, and the answers are the live scan engine's."""
    out = tmp_path / "got.npz"
    code = f"""
import sys
import numpy as np
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.server import ServingEngine
eng = ServingEngine.from_export({fused["dir"]!r}, device="cpu", seed=3)
rng = np.random.default_rng(0)
got = eng.predict([make_raw_scene(rng, s % 2, num_actors=5, num_lanes=6) for s in range(3)])
eng.close()
np.savez({str(out)!r}, *[r["agent_world"] for r in got])
print(sorted(m for m in sys.modules if m.startswith("trajsde")))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=WAIT_S, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = eval(r.stdout.strip().splitlines()[-1])
    assert "trajsde_tpu_torch.deploy" in loaded and "trajsde_tpu_torch.ops.sde_rollout" in loaded
    assert not [m for m in loaded if m.startswith(("trajsde_tpu_torch.models",
                                                    "trajsde_tpu_torch.config",
                                                    "trajsde_tpu_torch.train"))], loaded
    assert not [m for m in loaded if m == "trajsde_tpu" or m.startswith("trajsde_tpu.")]
    eng = ServingEngine(fused["model"], device="cpu", num_actors=A, num_lanes=L, engine="scan",
                        batch_buckets=BUCKETS, seed=3)
    try:
        want = eng.predict(_raws(3))
    finally:
        eng.close()
    with np.load(out) as z:
        for i, w in enumerate(want):
            np.testing.assert_array_equal(z[f"arr_{i}"], w["agent_world"])


def test_the_rollout_seed_is_an_input_of_the_program(fused):
    """The fused artifact's graph calls K1's and K3's ops; the rollout op's
    seed is a user input of the program, not a constant, so two seeds give
    two draws and one seed the same twice."""
    ep = fused["exp"].programs[1]
    calls = {n.target: n for n in ep.graph.nodes if n.op == "call_function"}
    assert torch.ops.trajsde.aa_fused_fwd.default in calls
    seed = calls[torch.ops.trajsde.sde_rollout.default].args[4]
    assert seed.op == "placeholder" and seed.name in ep.graph_signature.user_inputs
    assert not ep.constants or all(v.dim() != 0 for v in ep.constants.values()
                                   if isinstance(v, torch.Tensor))
    exp = fused["exp"]
    scene = _example(_raws(1)[0])
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731  (the same encoder draws)
    a = exp(scene, 1, generator=gen())["loc"]
    b = exp(scene, 2, generator=gen())["loc"]
    assert not torch.equal(a, b)
    assert torch.equal(a, exp(scene, 1, generator=gen())["loc"])
