"""The port's utilities vs the JAX package's on the CPU: the config's loss
and metric lists, the reference-checkpoint converter and its script,
endpoint clustering and the plots.

* ``build_losses`` / ``build_metrics`` read ``losses_module`` /
  ``loss_weights`` / ``loss_args`` and ``metrics_module`` / ``metric_args``
  as JAX's ``ExperimentConfig`` does: the ``LaplaceNLL`` alias keeps its
  listed name, a ``loss_args`` of another length raises ``ValueError``, a
  missing ``metric_args`` gives each metric ``{}``.
* ``utils/convert.py``: a reference ``state_dict`` synthesized from JAX's
  ``build_rules`` over a JAX template (each transform inverted, the dead
  tensors and two unknown keys added) converts, through the port, to JAX's
  conversion carried through ``bridge.params_from_flax`` bit for bit, with
  JAX's report and error types, for both shipped families and a config
  written with the native encoder name.  The converted small models'
  forwards are within 1e-4 of JAX's with the converted params and pinned
  noise.  ``scripts/convert_checkpoint_torch.py`` writes a step directory
  that ``test_torch.py --ckpt`` and ``train_torch.py --wonly`` read bit for
  bit.  Nothing here needs the reference repository.
* ``utils/clustering.py``: JAX's initial draw (``jax.random.choice``) is
  handed to the port; assignments equal, centres, modes and probs within
  1e-5.
* ``utils/viz.py``: the three plots write files; ``_scene_arrays`` equals
  JAX's on one batch.
"""
import copy
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu import config as jconfig
from trajsde_tpu.train import metrics as jmetrics
from trajsde_tpu.utils import clustering as jclustering
from trajsde_tpu.utils import convert as jconvert
from trajsde_tpu.utils import viz as jviz
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.losses import LOSS_REGISTRY
from trajsde_tpu_torch.train.checkpoint import save_weights
from trajsde_tpu_torch.utils import clustering as tclustering
from trajsde_tpu_torch.utils import convert as tconvert
from trajsde_tpu_torch.utils import viz as tviz

import test_torch
import train_torch
from _torch_helpers import (jax_forward, noise_for, scene_pair, small_baseline_cfg, small_cfg,
                            t, torch_build_model, write_run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SDE_CFG = os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec.yml")
BASE_CFG = os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml")
UNKNOWN = {"metric.ADE_T.total": np.zeros((), np.float32),
           "aggregator.some_new_buffer": np.ones((3,), np.float32)}
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the loss and metric lists
# ---------------------------------------------------------------------------
def _lists(**kw):
    raw = {"losses_module": ["L2"], "loss_weights": [1], "loss_args": [{"reduction": "mean"}],
           "metrics_module": ["ADE_T"], "metric_args": [{"dataset": "nuScenes",
                                                         "end_idcs": [59, 29]}]}
    raw.update(kw)
    return {k: v for k, v in raw.items() if v is not None}


def _jax_losses(raw):
    return jconfig.build_losses(jconfig.ExperimentConfig(raw))


def _jax_metrics(raw):
    specs = jconfig.ExperimentConfig(raw).metric_specs
    return jmetrics.make_metrics([n for n, _ in specs], [dict(a) for _, a in specs])


def _error(fn, raw):
    try:
        fn(raw)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e)
    return None


@pytest.mark.parametrize("case", ["alias", "loss_args_length", "metric_args_default"])
def test_loss_and_metric_lists_read_as_jax_reads_them(case, monkeypatch):
    if case == "alias":
        raw = _lists(losses_module=["LaplaceNLL", "L2"], loss_weights=[0.5, 2],
                     loss_args=[{}, {}])
        got, want = tconfig.build_losses(raw), _jax_losses(raw)
        assert [(n, w) for n, w, _ in got] == [(n, w) for n, w, _ in want] \
            == [("LaplaceNLL", 0.5), ("L2", 2.0)]
        assert got[0][2] is LOSS_REGISTRY["LaplaceNLLLoss"]
        assert want[0][2].__name__ == got[0][2].__name__ == "laplace_nll_loss"
        # the native name still resolves, and an unknown one is a KeyError in both
        assert tconfig.build_losses(_lists(losses_module=["LaplaceNLLLoss"]))[0][0] \
            == "LaplaceNLLLoss"
        bad = _lists(losses_module=["Nope"])
        assert _error(tconfig.build_losses, bad) is _error(_jax_losses, bad) is KeyError
    elif case == "loss_args_length":
        for raw in (_lists(loss_args=[{}, {}]), _lists(loss_weights=[1, 1]),
                    _lists(loss_args=[])):
            assert _error(tconfig.build_losses, raw) is _error(_jax_losses, raw) is ValueError
        raw = _lists(loss_args=None, loss_weights=None)   # both default to one per loss
        assert [(n, w) for n, w, _ in tconfig.build_losses(raw)] \
            == [(n, w) for n, w, _ in _jax_losses(raw)] == [("L2", 1.0)]
    else:
        raw = _lists(metrics_module=["ADE_T", "FDE_T"], metric_args=None)
        handed = {}
        monkeypatch.setattr(tconfig, "make_metrics",
                            lambda names, args: handed.update(names=names, args=args))
        tconfig.build_metrics(raw)
        specs = jconfig.ExperimentConfig(raw).metric_specs
        assert handed == {"names": [n for n, _ in specs], "args": [a for _, a in specs]} \
            == {"names": ["ADE_T", "FDE_T"], "args": [{}, {}]}
        monkeypatch.undo()
        # {} names no dataset: both packages' metrics refuse it the same way
        assert _error(tconfig.build_metrics, raw) is _error(_jax_metrics, raw) is TypeError
        raw = _lists(metric_args=[{}, {}])
        assert _error(tconfig.build_metrics, raw) is _error(_jax_metrics, raw) is ValueError


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------
def _dead(cfg_raw, D, Th):
    """The reference's dead tensors of this family (the converter skips
    them by name; HiVT's ALEncoder embeddings at its shapes)."""
    dead = {"encoder.al_encoder.is_intersection_embed": np.zeros((2, D), np.float32),
            "encoder.al_encoder.turn_direction_embed": np.zeros((3, D), np.float32),
            "encoder.al_encoder.traffic_control_embed": np.zeros((2, D), np.float32)}
    if cfg_raw["decoder"]["module_name"] == "SDEDecoder":
        dead.update({"encoder.lsde_func.h_func.theta": np.ones((1,), np.float32),
                     "encoder.lsde_func.h_func.mu": np.zeros((1,), np.float32),
                     "decoder.hidden": np.zeros((D,), np.float32)})
    else:
        dead["encoder.temporal_encoder.attn_mask"] = np.zeros((Th + 1, Th + 1), np.float32)
    return dead


def reference_state_dict(cfg_raw, flax_params):
    """A reference Lightning ``state_dict`` (numpy) whose conversion by JAX's
    rules is ``flax_params``: each rule's transform inverted (transpose for
    ``_T_LINEAR``, a singleton axis 1 for the temporal tokens), plus the
    dead tensors and two unknown keys."""
    rules = jconvert.build_rules(jconfig.ExperimentConfig(cfg_raw)).rules
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(flax_params)[0]:
        fpath = tuple(str(getattr(k, "key", k)) for k in path)
        tkey, fn = rules[fpath]
        leaf = np.asarray(leaf)
        ref = leaf.T.copy() if fn is jconvert._T_LINEAR else \
            leaf.copy() if fn is jconvert._IDENT else np.expand_dims(leaf, 1)
        np.testing.assert_array_equal(fn(ref), leaf)
        sd[tkey] = ref
    kw = cfg_raw["encoder"]["kwargs"]
    sd.update(_dead(cfg_raw, kw["embed_dim"], kw["historical_steps"]))
    sd.update(copy.deepcopy(UNKNOWN))
    return sd


def _native(raw):
    raw = copy.deepcopy(raw)
    raw["encoder"]["module_name"] = "LocalEncoderSDESep"
    return raw


@pytest.fixture(scope="module")
def families():
    """Each shipped family (and the flagship written with its native
    encoder name): its config, a JAX template at the YAML's widths with
    seeded numpy values, the reference ``state_dict`` and the port's model."""
    from trajsde_tpu.data.synthetic import make_scene_batch

    scene = make_scene_batch(np.random.default_rng(0), batch_size=1, num_actors=4,
                             num_lanes=6)
    out = {}
    for name, path in (("sde", SDE_CFG), ("baseline", BASE_CFG)):
        raw = tconfig.load_config(path)
        jm = jconfig.build_model(jconfig.ExperimentConfig(raw))
        shapes = jax.eval_shape(jm.init, {"params": jax.random.key(0),
                                          "sde": jax.random.key(1)}, scene)["params"]
        r = np.random.default_rng(len(name))
        template = jax.tree.map(lambda s: r.standard_normal(s.shape).astype(s.dtype), shapes)
        model = torch_build_model(raw, device="cpu", seed=4)
        out[name] = (raw, template, reference_state_dict(raw, template), model)
    raw, template, sd, model = out["sde"]
    out["sde native"] = (_native(raw), template, sd, model)
    return out


@pytest.mark.parametrize("family", ["sde", "baseline", "sde native"])
def test_convert_state_dict_is_jax_conversion_bit_for_bit(families, family):
    raw, template, sd, model = families[family]
    jparams, jreport = jconvert.convert_state_dict(sd, jconfig.ExperimentConfig(raw), template)
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    got, report = tconvert.convert_state_dict(sd, raw, model)
    assert list(got) == list(model.state_dict())
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu", k
        assert torch.equal(v, want[k]), k
    assert report == jreport
    assert report["unused"] == sorted(UNKNOWN)
    assert report["skipped"] == sorted(_dead(raw, 64, 21))
    model.load_state_dict(got)   # strict: every leaf, no more


@pytest.mark.parametrize("fault", ["missing", "shape", "decoder", "aggregator"])
def test_convert_errors_are_jax_errors(families, fault):
    raw, template, sd, model = families["sde"]
    sd = dict(sd)
    if fault == "missing":
        del sd["decoder.pi.3.weight"]
        want = KeyError
    elif fault == "shape":
        sd["aggregator.multihead_proj.weight"] = sd["aggregator.multihead_proj.weight"][:, :-1]
        want = ValueError
    else:
        raw = copy.deepcopy(raw)
        raw[fault]["module_name"] = "SomethingElse"
        want = ValueError
    with pytest.raises(want) as jax_err:
        jconvert.convert_state_dict(sd, jconfig.ExperimentConfig(raw), template)
    with pytest.raises(want) as port_err:
        tconvert.convert_state_dict(sd, raw, model)
    if fault in ("decoder", "aggregator"):
        assert str(port_err.value) == str(jax_err.value)


def test_convert_takes_tensors_and_a_fused_encoder_by_the_same_rules(families):
    """Torch tensors in the checkpoint (Lightning's own) give the numpy
    result, and ``encoder.fused: true`` converts by the dense encoder's
    rules to the same leaves."""
    raw, _, sd, model = families["sde"]
    want, _ = tconvert.convert_state_dict(sd, raw, model)
    fused = copy.deepcopy(raw)
    fused["encoder"]["kwargs"]["fused"] = True
    got, _ = tconvert.convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                         fused, torch_build_model(fused, device="cpu"))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("family", ["sde", "baseline"])
def test_converted_small_model_forward_is_jax_forward(family):
    cfg = small_cfg() if family == "sde" else small_baseline_cfg()
    B, A = 2, 5
    js, ts = scene_pair(11, B, A, 6)
    seeded = torch_build_model(cfg, device="cpu", seed=6)
    template = params_to_flax(seeded.state_dict())
    jcfg = jconfig.ExperimentConfig(cfg)
    jparams, _ = jconvert.convert_state_dict(reference_state_dict(cfg, template), jcfg, template)
    model = torch_build_model(cfg, device="cpu", seed=0)
    got_sd, _ = tconvert.convert_state_dict(reference_state_dict(cfg, template), cfg, model)
    model.load_state_dict(got_sd)
    jm = jconfig.build_model(jcfg)
    with torch.no_grad():
        if family == "sde":
            en, tw, de = noise_for(cfg, B, A)
            want = jax_forward(jm, {"params": jparams}, js, en, tw, de)
            got = model(ts, enc_noise=t(en), twin_noise=t(tw), dec_noise=t(de))
        else:
            want = jax.tree.map(np.asarray, jm.apply({"params": jparams}, js))
            got = model(ts)
    for k in ("loc", "pi"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def _script():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint_torch", os.path.join(REPO, "scripts", "convert_checkpoint_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_script_round_trips_through_test_torch_and_wonly(tmp_path, capsys):
    cfg_path = write_run(tmp_path, n_train=2)
    cfg = json.loads(open(cfg_path).read())
    seeded = torch_build_model(cfg, device="cpu", seed=9)
    sd = reference_state_dict(cfg, params_to_flax(seeded.state_dict()))
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    sd["encoder.al_encoder.is_intersection_embed"] = \
        sd["encoder.al_encoder.is_intersection_embed"].bfloat16()   # read as f32
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ref.ckpt")
    out = str(tmp_path / "converted" / "step_00000000")
    line = _script().main(["-c", cfg_path, "--torch-ckpt", str(tmp_path / "ref.ckpt"),
                           "--out", out])
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == line
    assert line == {"out": out, "converted_leaves": len(seeded.state_dict()),
                    "skipped_dead": sorted(_dead(cfg, 16, 21)), "unused_keys": sorted(UNKNOWN)}
    assert "2 unrecognized checkpoint keys" in captured.err
    saved = torch.load(os.path.join(out, "state.pt"), weights_only=True)
    assert set(saved) == {"model"}
    assert all(torch.equal(saved["model"][k], v) for k, v in seeded.state_dict().items())

    direct = save_weights(seeded.state_dict(), str(tmp_path / "direct" / "step_00000000"))
    args = ["-c", cfg_path, "--device", "cpu", "--ood"]
    got = test_torch.main(args + ["--ckpt", out])
    want = test_torch.main(args + ["--ckpt", direct])
    assert got == want and all(np.isfinite(v) for v in got.values())
    state, _ = train_torch.main(["-c", cfg_path, "-n", "warm", "--logdir", str(tmp_path / "logs"),
                                 "--device", "cpu", "--epochs", "0", "--wonly", out])
    assert all(torch.equal(state.model.state_dict()[k], v)
               for k, v in seeded.state_dict().items())


def test_convert_script_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="nowhere.ckpt"):
        _script().main(["-c", SDE_CFG, "--torch-ckpt", str(tmp_path / "nowhere.ckpt"),
                        "--out", str(tmp_path / "out")])


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------
def _two_clusters():
    """``tests/test_aux_components.py``'s case: two endpoint clusters, 3:1."""
    rng = np.random.default_rng(0)
    tt = np.linspace(0, 1, 10, dtype=np.float32)[None, :, None]
    a = np.tile(tt * np.array([10.0, 0.0], np.float32), (6, 1, 1))
    b = np.tile(tt * np.array([-10.0, 0.0], np.float32), (2, 1, 1))
    return np.concatenate([a, b]) + rng.normal(0, 0.05, (8, 10, 2)).astype(np.float32)


def _empty_cluster():
    """Every endpoint equal: all samples join the first centre and the other
    clusters stay empty, so their modes are the fallback draws."""
    trajs = np.random.default_rng(4).normal(size=(5, 8, 2)).astype(np.float32)
    trajs[:, -1] = [1.5, -2.0]
    return trajs


CLUSTER_CASES = {
    "two clusters": (_two_clusters, 2, 0),
    "random": (lambda: np.random.default_rng(1).normal(0, 3, (40, 12, 2)).astype(np.float32),
               6, 3),
    "k above S": (lambda: np.random.default_rng(2).normal(size=(4, 6, 2)).astype(np.float32),
                  6, 1),
    "empty cluster": (_empty_cluster, 3, 2),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_clustering_matches_jax_with_its_draw(case):
    make, k, seed = CLUSTER_CASES[case]
    trajs = make()
    S = trajs.shape[0]
    kk = min(k, S)
    key = jax.random.key(seed)
    init_idx = np.asarray(jax.random.choice(key, S, (kk,), replace=False))
    j_assign, j_centers = jclustering.kmeans_endpoints(jnp.asarray(trajs), key, k=k)
    assign, centers = tclustering.kmeans_endpoints(torch.from_numpy(trajs), k=k,
                                                   init_idx=init_idx)
    assert centers.shape == (kk, 2) and assign.dtype == torch.int64
    np.testing.assert_array_equal(assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(centers.numpy(), np.asarray(j_centers), rtol=1e-5, atol=1e-5)

    j_modes, j_probs = jclustering.cluster_and_rank(trajs, k=k, seed=seed)
    modes, probs = tclustering.cluster_and_rank(trajs, k=k, seed=seed, init_idx=init_idx)
    assert modes.shape == (kk, trajs.shape[1], 2) and probs.shape == (kk,)
    np.testing.assert_allclose(modes, j_modes, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs, j_probs, rtol=1e-5, atol=1e-5)
    if case == "empty cluster":
        assert (probs[1:] == 0).all()
        rng = np.random.default_rng(seed)
        for c in range(1, kk):   # the fallback rows, one rng for every empty cluster
            np.testing.assert_array_equal(modes[c], trajs[rng.integers(0, S)])


def test_kmeans_draws_its_centres_from_a_generator():
    trajs = torch.from_numpy(_two_clusters())
    a = tclustering.kmeans_endpoints(trajs, k=2, generator=torch.Generator().manual_seed(5))
    b = tclustering.kmeans_endpoints(trajs, k=2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert len(torch.unique(a[0])) == 2
    with pytest.raises(ValueError, match="init_idx"):
        tclustering.kmeans_endpoints(trajs, k=2, init_idx=[0, 1, 2])


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------
def test_viz_writes_its_three_plots_and_reads_jax_arrays(tmp_path):
    js, ts = scene_pair(5, B=2, A=4, L=6)
    want, got = jviz._scene_arrays(js, 1), tviz._scene_arrays(ts, 1)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    paths = [tviz.viz_scene(ts, 0, str(tmp_path / "scene.png")),
             tviz.viz_predictions(ts, {"loc": torch.zeros(2, 3, 4, 60, 2)}, 0,
                                  str(tmp_path / "pred.png")),
             tviz.viz_ood(ts, torch.rand(2, 4), 1, str(tmp_path / "sub" / "ood.png"))]
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0


@pytest.mark.parametrize("family", ["sde", "baseline"])
def test_to_reference_is_the_inverse_of_the_jax_rules(families, family):
    """``to_reference`` gives the state_dict the JAX rules invert to, and
    converts back to the same leaves."""
    raw, _, _, model = families[family]
    sd = model.state_dict()
    ref = tconvert.to_reference(sd, raw)
    want = reference_state_dict(raw, params_to_flax(sd))
    assert set(ref) == set(want) - set(UNKNOWN) - set(_dead(raw, 64, 21))
    for k, v in ref.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    back, report = tconvert.convert_state_dict(ref, raw, model)
    assert report == {"skipped": [], "unused": []}
    assert all(torch.equal(back[k], v) for k, v in sd.items())
