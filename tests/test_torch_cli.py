"""The port's command line (``train_torch.py``, ``test_torch.py``) and the
rest of its ``Trainer`` on the CPU, at a small size: widths 16, 2 heads,
3 modes, batches of 4 scenes of 6 actors and 8 lanes, written as npz files
from the port's synthetic scenes.

* ``FLAGSHIP_H100`` is the H100 YAML; a JSON copy of a config loads the same;
* ``ExperimentLogger`` writes JAX's records; async records keep their order;
  ``snapshot_sources`` leaves ``_build/`` out; ``--profile 1`` leaves a trace;
* preemption: SIGTERM mid-fit and mid-eval saves unscored and returns, a
  stale flag is cleared, and SIGTERM to the process group of a
  ``train_torch.py`` run with 2 loader workers leaves no process behind;
* ``train_torch.main`` trains, checkpoints and resumes, 1 + 1 epochs equal
  to 2 bit for bit;
* ``test_torch.main`` on bridged JAX weights with every diffusion output
  bias at -1e4 (both packages deterministic): ADE_T / FDE_T / MR_T within
  rtol 1e-4 / atol 1e-6 of JAX's, plain (``make_eval_step``) and
  ``--only-agent`` (``test.py``'s filters); ``--submit`` within 1e-4 of
  JAX's ``make_postprocess``; ``--ood`` and ``--serving`` finite;
  ``--viz-ood --viz-limit 2`` writes test.py's files from the stds taken
  before the ``--only-agent`` cut.
"""
import json
import math
import os
import signal
import subprocess
import sys
import time

import flax
import jax
import numpy as np
import pytest
import torch

from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
from trajsde_tpu.data import loader as jloader
from trajsde_tpu.data import transforms as jtransforms
from trajsde_tpu.data.scene import strip_for_device as jax_strip
from trajsde_tpu.server import make_postprocess as jax_make_postprocess
from trajsde_tpu.train import logging as jlogging
from trajsde_tpu.train import metrics as jmetrics
from trajsde_tpu.train.loop import agent_slices as jax_agent_slices
from trajsde_tpu.train.loop import make_eval_step as jax_make_eval_step
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.config import build_losses, build_metrics
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import Trainer, create_train_state

import test_torch
import train_torch
from _torch_helpers import scene_pair, small_baseline_cfg, small_cfg, torch_build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
A, L, BATCH = 6, 8, 4
N_TRAIN, N_VAL = 6, 8          # per domain: 3 train steps an epoch; 2 test batches


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL only: importing tensorboard here pulls in TensorFlow (~16 s)."""
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


def _cfg(workers=1, fused=True):
    """The H100 config at the small size, over the npz tree at ``root``."""
    cfg = small_cfg(Tf=60)
    cfg["encoder"]["kwargs"]["fused"] = fused
    cfg["decoder"]["kwargs"]["fused"] = fused
    cfg["datamodule_specific"]["kwargs"].update(
        train_batch_size=BATCH, val_batch_size=BATCH, num_actors=A, num_lanes=L,
        num_workers=workers)
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """npz scenes of both sources (train) and of nuScenes (val / test)."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(0)
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        for split, n in (("train", N_TRAIN), ("val", N_VAL if src == 0 else 0)):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(n):
                raw = make_raw_scene(rng, src, num_actors=int(rng.integers(3, A + 1)),
                                     num_lanes=int(rng.integers(4, L + 1)))
                np.savez(d / f"scene_{1000 + 7 * i:06d}.npz", **raw)
    return root


def _write_cfg(path, root, **kw):
    cfg = _cfg(**kw)
    cfg["datamodule_specific"]["kwargs"].update(nu_dir=str(root / "nuScenes"),
                                                Argo_dir=str(root / "Argoverse"))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# config, logger, snapshot
# ---------------------------------------------------------------------------
def test_flagship_h100_equals_the_yaml_and_json_loads_the_same(tmp_path):
    path = os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml")
    raw = tconfig.load_config(path)
    assert raw == tconfig.FLAGSHIP_H100
    assert raw["encoder"]["kwargs"]["fused"] and raw["decoder"]["kwargs"]["fused"]
    assert raw["datamodule_specific"]["kwargs"]["train_batch_size"] == 128
    shipped = tconfig.load_config(os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec.yml"))
    for sec in ("training_specific", "losses_module", "loss_weights", "metrics_module", "metric_args",
                "aggregator", "model_specific"):
        assert raw[sec] == shipped[sec], sec
    with open(tmp_path / "h100.json", "w") as f:
        json.dump(raw, f)
    assert tconfig.load_config(str(tmp_path / "h100.json")) == raw


def test_logger_writes_the_records_of_jax(tmp_path):
    values = [(0, {"nfe/x": 21.0}), (3, {"train/L2": 1.5, "train/total": 2.25, "b": 7})]
    jl = jlogging.ExperimentLogger(str(tmp_path / "jax"), use_tensorboard=False)
    tl = tlogging.ExperimentLogger(str(tmp_path / "torch"))
    for step, vals in values:
        jl.log_scalars(step, {k: jax.numpy.float32(v) for k, v in vals.items()})
        tl.log_scalars(step, {k: torch.tensor(float(v)) for k, v in vals.items()})
    jl.log_scalars_async(4, {"z": jax.numpy.float32(0.5), "a": 1.0})
    tl.log_scalars_async(4, {"z": torch.tensor(0.5), "a": 1.0})
    jl.close()
    tl.close()
    want, got = _records(str(tmp_path / "jax")), _records(str(tmp_path / "torch"))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert list(g) == list(w)            # step, time, then the scalars in order
        assert {k: v for k, v in g.items() if k != "time"} == {k: v for k, v in w.items() if k != "time"}


def test_logger_async_records_land_in_submit_order(tmp_path):
    tl = tlogging.ExperimentLogger(str(tmp_path))
    for step in range(40):
        tl.log_scalars_async(step, {"train/total": torch.tensor(float(step)) * 2})
    tl.log_scalars(40, {"val/ADE_T": 1.0})   # after every queued record
    tl.close()
    rows = _records(str(tmp_path))
    assert [r["step"] for r in rows] == list(range(41))
    assert [r["train/total"] for r in rows[:40]] == [2.0 * s for s in range(40)]


def test_snapshot_sources_copies_the_port_without_builds(tmp_path):
    dest = tlogging.snapshot_sources(str(tmp_path))
    pkg = os.path.join(dest, "trajsde_tpu_torch")
    assert os.path.isfile(os.path.join(pkg, "train", "loop.py"))
    assert os.path.isfile(os.path.join(pkg, "csrc", "sde_rollout.cu"))
    for _, dirs, files in os.walk(pkg):
        assert "_build" not in dirs and "__pycache__" not in dirs
        assert not any(f.endswith((".so", ".pyc")) for f in files)


# ---------------------------------------------------------------------------
# preemption, in-process (tests/test_train.py's, for the port's Trainer)
# ---------------------------------------------------------------------------
def _trainer_and_state(tmp_path):
    cfg = _cfg()
    state = create_train_state(torch_build_model(cfg, device="cpu", seed=1),
                               cfg["training_specific"], steps_per_epoch=1, seed=1)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu", checkpointer=ckpt)
    return trainer, state, scene_pair(30, BATCH, A, L)[1]


def test_preemption_mid_fit_saves_unscored_and_resumes(tmp_path):
    trainer, state, scene = _trainer_and_state(tmp_path)

    def batches_then_sigterm():
        yield scene
        os.kill(os.getpid(), signal.SIGTERM)   # caught by the trainer's handler
        yield scene
        yield scene

    out = trainer.fit(state, batches_then_sigterm, lambda: [scene], max_epochs=5)
    # the step in flight finishes, nothing after it runs
    assert out.step == 1 and trainer.preempted
    entry = trainer.checkpointer.latest()
    assert entry is not None and entry["metric"] is None and entry["step"] == 1
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
    restored = trainer.checkpointer.restore(out)
    assert restored.step == 1
    # fit clears the stale flag itself
    resumed = trainer.fit(restored, lambda: [scene], lambda: [scene], max_epochs=1)
    assert resumed.step == 2 and not trainer.preempted
    assert trainer.checkpointer.latest()["metric"] is not None


def test_preemption_mid_eval_saves_unscored(tmp_path):
    trainer, state, scene = _trainer_and_state(tmp_path)

    def val_then_sigterm():
        yield scene
        os.kill(os.getpid(), signal.SIGTERM)
        yield scene
        yield scene

    scored = []
    metric = trainer.metrics[0]
    accumulate = metric.accumulate
    metric.accumulate = lambda c: (scored.append(1), accumulate(c))
    out = trainer.fit(state, lambda: [scene], val_then_sigterm, max_epochs=3)
    assert trainer.preempted and out.step == 1   # epoch 1 trained, nothing after the signal
    assert len(scored) <= 1                      # the val pass stopped at the signal (of 3)
    assert trainer.epoch_logs == []              # the partial val pass is not scored
    entry = trainer.checkpointer.latest()
    assert entry is not None and entry["metric"] is None
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_preemption_with_a_loader_that_fails_after_the_signal(tmp_path):
    """The signal reaches the loader's workers too (a SIGTERM to the process
    group), and the loader fails while the trainer waits for its next
    batch: ``fit`` still saves unscored and returns."""
    trainer, state, scene = _trainer_and_state(tmp_path)

    def batches():
        yield scene
        time.sleep(1.0)                        # the trainer now waits for batch 2
        os.kill(os.getpid(), signal.SIGTERM)
        raise RuntimeError("DataLoader worker (pid 1) exited unexpectedly")

    out = trainer.fit(state, batches, lambda: [scene], max_epochs=2)
    assert trainer.preempted and out.step == 1
    assert trainer.checkpointer.latest()["metric"] is None


_CHILD = """
import sys
from trajsde_tpu_torch.train import logging
logging._tensorboard_writer = lambda log_dir: None   # JSONL only (no TensorFlow import)
import train_torch
train_torch.main(sys.argv[1:])
"""


def _group_alive(pgid):
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


def test_sigterm_to_the_process_group_saves_and_leaves_no_worker(data, tmp_path):
    """``train_torch.py`` with 2 loader worker processes in a session of its
    own; SIGTERM goes to the whole group after the first step's record.
    The run saves unscored, logs ``preempted`` and exits 0, and no process
    of the group outlives it."""
    cfg = _write_cfg(tmp_path / "cfg.json", data, workers=2)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, "-c", cfg, "-n", "run", "--epochs", "100", "--logdir",
         str(tmp_path), "--device", "cpu"], cwd=REPO, env=env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    run_dir = tmp_path / "run"
    try:
        deadline = time.time() + 120
        while not any("train/total" in r for r in (_records(run_dir) if (run_dir / "metrics.jsonl").exists() else [])):
            assert proc.poll() is None and time.time() < deadline, proc.stdout.read().decode()[-3000:]
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out.decode()[-3000:]
        deadline = time.time() + 20
        while _group_alive(proc.pid) and time.time() < deadline:
            time.sleep(0.05)
        assert not _group_alive(proc.pid), "a process of the run outlived it"
    finally:
        if _group_alive(proc.pid):
            os.killpg(proc.pid, signal.SIGKILL)
    rows = _records(run_dir)
    assert rows[-1].get("preempted") == 1.0
    step = rows[-1]["step"]
    assert 1 <= step < 300
    with open(run_dir / "checkpoints" / "leaderboard.json") as f:
        board = json.load(f)
    assert board[-1]["step"] == step and board[-1]["metric"] is None


# ---------------------------------------------------------------------------
# train_torch.main
# ---------------------------------------------------------------------------
def _train(cfg, logdir, name, *extra):
    return train_torch.main(["-c", cfg, "-n", name, "--logdir", str(logdir), "--device", "cpu",
                             "--seed", "3", *extra])


def _latest(run_dir):
    return CheckpointManager(os.path.join(run_dir, "checkpoints")).latest()


def test_train_torch_trains_resumes_and_profiles(data, tmp_path):
    """2 epochs straight, and 1 epoch (profiled from step 1) then a
    ``--ckpt`` resume for 1 more: the same weights, AdamW state and
    schedule bit for bit; the step continues; each run leaves a finite
    scored checkpoint, ``metrics.jsonl`` and ``source_snapshot/``."""
    cfg = _write_cfg(tmp_path / "cfg.json", data, workers=2)
    full, _ = _train(cfg, tmp_path, "full", "--epochs", "2")
    assert full.step == 6
    run = tmp_path / "full"
    board = json.loads((run / "checkpoints" / "leaderboard.json").read_text())
    assert board and all(math.isfinite(e["metric"]) for e in board)
    rows = _records(run)
    assert rows[0]["nfe/decoder_sde_steps"] == 60.0
    assert [r["step"] for r in rows if "train/total" in r] == list(range(1, 7))
    assert sum("val/ADE_T" in r for r in rows) == 2
    assert (run / "source_snapshot" / "trajsde_tpu_torch" / "train" / "loop.py").is_file()

    first, _ = _train(cfg, tmp_path, "split", "--epochs", "1", "--profile", "1")
    assert first.step == 3
    traces = os.listdir(tmp_path / "split" / "profile")
    assert traces == ["trace_step1.json"]
    with open(tmp_path / "split" / "profile" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    resumed, _ = _train(cfg, tmp_path, "split", "--epochs", "1", "--ckpt",
                        _latest(tmp_path / "split")["path"])
    assert resumed.step == 6 and _latest(tmp_path / "split")["step"] == 6
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert full.scheduler.state_dict() == resumed.scheduler.state_dict()
    split_rows = [r for r in _records(tmp_path / "split") if "train/total" in r]
    assert [r["train/total"] for r in split_rows] == [r["train/total"] for r in rows if "train/total" in r]


def test_train_torch_wonly_and_config_guards(data, tmp_path):
    cfg = _write_cfg(tmp_path / "cfg.json", data)
    src = create_train_state(torch_build_model(_cfg(), device="cpu", seed=8),
                             _cfg()["training_specific"], steps_per_epoch=3)
    path = CheckpointManager(str(tmp_path / "warm")).save(src, metric=None, step=0)
    state, _ = _train(cfg, tmp_path, "warm_run", "--epochs", "0", "--wonly", path)
    a, b = src.model.state_dict(), state.model.state_dict()
    assert state.step == 0 and all(torch.equal(a[k], b[k]) for k in a)
    for bad in (1.0, True):
        raw = json.loads(open(cfg).read())
        raw["model_specific"]["kwargs"]["ts_drop"] = bad
        (tmp_path / "bad.json").write_text(json.dumps(raw))
        with pytest.raises(SystemExit, match="ts_drop must be a drop RATE"):
            _train(str(tmp_path / "bad.json"), tmp_path, "bad")


# what ``--chain 2`` does not run with yet, each naming its ROADMAP.md Queue 1
# item: flags (refused before any file is read), or an edit of a small config
CHAIN_REFUSED = [
    (["--multihost"], None, "item 5f"),
    (["--multihost", "--zero1"], None, "item 5f"),
    ([], ("encoder", "remat", True), "item 5g"),
    ([], ("encoder", "adaptive", True), "item 5h"),
]


@pytest.mark.parametrize("flags,edit,item", CHAIN_REFUSED)
def test_flags_not_ported_exit_naming_their_item(flags, edit, item, tmp_path):
    path = "x.yml"
    if edit is not None:
        cfg = small_cfg()
        sec, key, value = edit
        cfg[sec]["kwargs"][key] = value
        path = str(tmp_path / "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
        train_torch.main(["-c", path, "-n", "x", "--chain", "2", *flags])


def _bf16(cap=0, fused=False):
    """``_tpu.yml`` at the small size (cap: ``_tpu_fast.yml``; fused: the
    ``encoder.fused: true`` fallback, plain K3b / K4b here)."""
    cfg = _cfg(fused=False)
    for sec in ("encoder", "aggregator", "decoder"):
        cfg[sec]["kwargs"]["dtype"] = "bfloat16"
    cfg["encoder"]["kwargs"].update(neighbor_cap=cap, fused=fused)
    return cfg


def _baseline(fused=False):
    """The HiVT baseline at the small size (fused: plain K3 / K4 here)."""
    cfg = small_baseline_cfg(Tf=60, fused=fused)
    cfg["datamodule_specific"]["kwargs"].update(
        train_batch_size=BATCH, val_batch_size=BATCH, num_actors=A, num_lanes=L, num_workers=1)
    return cfg


# the builds --chain once refused (ROADMAP.md Queue 1 item 5h), small
CHAIN_BUILDS = {"tpu": lambda: _bf16(), "tpu_fast": lambda: _bf16(cap=3),
                "tpu_fused": lambda: _bf16(fused=True), "baseline": lambda: _baseline(),
                "baseline_fused": lambda: _baseline(fused=True)}


@pytest.mark.parametrize("build", list(CHAIN_BUILDS))
def test_chain_trains_every_shipped_build_from_files(build, data, tmp_path):
    """``train_torch.main --chain 2`` from npz files on the small forms of
    ``_tpu.yml``, ``_tpu_fast.yml``, the fused bf16 fallback and both
    baselines: 3 batches chained 2 + 1 (the trailing chain trains), one
    train record a chain, no skip, finite val metrics."""
    cfg = CHAIN_BUILDS[build]()
    cfg["datamodule_specific"]["kwargs"].update(nu_dir=str(data / "nuScenes"),
                                                Argo_dir=str(data / "Argoverse"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    state, trainer = train_torch.main(["-c", str(path), "-n", "x", "--chain", "2", "--device",
                                       "cpu", "--epochs", "1", "--logdir", str(tmp_path)])
    assert state.step == 3 and state.scheduler.last_epoch == 3 and trainer.chain_steps == 2
    epoch = trainer.epoch_logs[-1]
    assert epoch["train/steps_skipped"] == 0.0
    vals = {k: v for k, v in epoch.items() if k.startswith("val/")}
    assert vals and all(np.isfinite(v) for v in vals.values())
    rows = [r for r in _records(tmp_path / "x") if "train/total" in r]
    assert [r["step"] for r in rows] == [2, 3] and all(np.isfinite(r["train/total"]) for r in rows)


@pytest.mark.parametrize("flags", [["--multihost"], ["--multihost", "--zero1"], ["--zero1"]])
def test_multihost_and_zero1_parse_and_need_a_rendezvous(flags, monkeypatch):
    """Both flags parse; ``--multihost`` with no rendezvous in the
    environment, and ``--zero1`` without ``--multihost``, exit saying what
    is missing before anything is loaded."""
    args = train_torch.parse_args(["-c", "x.yml", "-n", "x", *flags])
    assert (args.multihost, args.zero1) == ("--multihost" in flags, "--zero1" in flags)
    for var in ("TRAJSDE_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    want = "needs a rendezvous" if "--multihost" in flags else "add --multihost"
    with pytest.raises(SystemExit, match=want):
        train_torch.main(["-c", "x.yml", "-n", "x", *flags])


# ---------------------------------------------------------------------------
# test_torch.main vs the JAX package
# ---------------------------------------------------------------------------
def _silence_diffusion(params):
    params = flax.core.unfreeze(params)
    for path in (("encoder", "sde_rnn", "g_nus"), ("encoder", "sde_rnn", "g_argo"),
                 ("decoder", "sde_rollout", "g_func")):
        node = params["params"]
        for p in path:
            node = node[p]
        node["dense_out"]["bias"] = node["dense_out"]["bias"] - 1e4
    return params


@pytest.fixture(scope="module")
def evaluated(data, tmp_path_factory):
    """JAX's answers over the JAX loader's test batches of the npz tree,
    with the checkpoint of the same (silenced) weights in the port's format.
    The JAX model is the dense one; the port's config runs the fused
    encoder and decoder (plain K1-K4 on the CPU) over the same tree."""
    tmp = tmp_path_factory.mktemp("eval")
    cfg_path = _write_cfg(tmp / "cfg.json", data)
    tcfg = json.loads(open(cfg_path).read())
    jcfg = _cfg(fused=False)
    kw = dict(tcfg["datamodule_specific"]["kwargs"])
    batches = [jax_strip(b) for b in jloader.DataModuleNuArgoMix(**kw).test_loader()]
    assert len(batches) == 2
    # the port's seeded weights as the flax tree (no JAX init to compile)
    jm = jax_build_model(ExperimentConfig(jcfg))
    dense = torch_build_model(jcfg, device="cpu", seed=5)
    params = {"params": params_to_flax(dense.state_dict())}
    params = _silence_diffusion(params)
    jms = jmetrics.make_metrics(jcfg["metrics_module"], jcfg["metric_args"])
    jeval = jax_make_eval_step(jm, jms, True)
    post_fn = jax_make_postprocess(True, 20)

    @jax.jit
    def only_agent_step(p, scene, key, i):
        # test.py's eval step with --only-agent --submit
        out = jm.apply({"params": p}, scene, rngs={"sde": jax.random.fold_in(key, i)})
        out = jtransforms.leave_only_agent_output(out, scene.agent_index)
        scene = jtransforms.leave_only_agent(scene)
        pred, target, reg_mask, source = jax_agent_slices(scene, out, True)
        res = {m.name: m.update_fn(pred, target, reg_mask, source) for m in jms}
        post = post_fn(scene, out)
        return res, post["agent_world"], post["agent_pi"]

    key = jax.random.key(12345)
    plain = [jeval(params["params"], b, key, np.int32(i)) for i, b in enumerate(batches)]
    filtered = [only_agent_step(params["params"], b, key, np.int32(i)) for i, b in enumerate(batches)]
    want = {}
    for name, contribs in (("plain", plain), ("only_agent", [c for c, _, _ in filtered])):
        for m in jms:
            m.reset()
            for c in contribs:
                m.accumulate(c[m.name])
        want[name] = {m.name: m.compute() for m in jms}
    want["world"] = np.concatenate([np.asarray(w) for _, w, _ in filtered])
    want["pi"] = np.concatenate([np.asarray(p) for _, _, p in filtered])
    want["seq_id"] = np.concatenate([np.asarray(b.seq_id) for b in batches])

    model = torch_build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    state = create_train_state(model, tcfg["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(tmp / "run" / "checkpoints")).save(state, metric=None, step=7)
    return cfg_path, ckpt, want


def _test(cfg, ckpt, *extra):
    return test_torch.main(["-c", cfg, "--ckpt", ckpt, "--device", "cpu", *extra])


@pytest.mark.parametrize("mode", ["plain", "only_agent"])
def test_test_torch_metrics_match_jax(evaluated, mode, capsys):
    cfg, ckpt, want = evaluated
    got = _test(cfg, ckpt, *(["--only-agent"] if mode == "only_agent" else []))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want[mode]) == {"ADE_T", "FDE_T", "MR_T"}
    for k in want[mode]:
        np.testing.assert_allclose(got[k], want[mode][k], rtol=1e-4, atol=1e-6, err_msg=k)
    out = os.path.join(os.path.dirname(os.path.dirname(ckpt)), "out", "result_step_00000007.json")
    assert json.load(open(out)) == got


def test_test_torch_submission_matches_jax(evaluated):
    cfg, ckpt, want = evaluated
    _test(cfg, ckpt, "--submit")
    sub = np.load(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "out",
                               "submission_step_00000007.npz"))
    assert sub["trajectories"].shape == want["world"].shape == (2 * BATCH, 3, 60, 2)
    np.testing.assert_allclose(sub["trajectories"], want["world"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sub["probabilities"], want["pi"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sub["probabilities"].sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(sub["seq_ids"], want["seq_id"])
    assert (sub["sources"] == 0).all()


def test_viz_ood_draws_the_first_batches_from_the_uncut_stds(evaluated, tmp_path, monkeypatch):
    """``--viz-ood --viz-limit 2 --only-agent --ood`` over 4 test batches
    writes test.py's ``batch0000.png`` and ``batch0001.png`` alone, from
    scene 0 of each batch and the stds of every actor, taken before the
    only-agent cut: the model's own ``forward_ood`` stds of that batch."""
    from trajsde_tpu_torch.train.loop import EVAL_SEED, step_generator
    from trajsde_tpu_torch.utils import viz

    cfg_path, ckpt, _ = evaluated
    raw = json.loads(open(cfg_path).read())
    raw["datamodule_specific"]["kwargs"]["val_batch_size"] = 2   # 8 scenes: 4 batches
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    run = tmp_path / "run" / "checkpoints"
    run.mkdir(parents=True)
    ckpt_copy = str(run / os.path.basename(ckpt))
    os.symlink(ckpt, ckpt_copy)
    drawn, real = [], viz.viz_ood
    monkeypatch.setattr(viz, "viz_ood", lambda scene, stds, b, path: drawn.append(
        (scene, stds, b, path)) or real(scene, stds, b, path))
    got = _test(cfg, ckpt_copy, "--viz-ood", "--viz-limit", "2", "--only-agent", "--ood")
    assert "agent_std_mean" in got
    viz_dir = tmp_path / "run" / "out" / "viz_ood"
    assert sorted(os.listdir(viz_dir)) == ["batch0000.png", "batch0001.png"]
    assert all(os.path.getsize(viz_dir / f) > 0 for f in os.listdir(viz_dir))
    assert [os.path.basename(p) for *_, p in drawn] == ["batch0000.png", "batch0001.png"]
    model = torch_build_model(raw, device="cpu")
    CheckpointManager(str(run)).restore_params(model, ckpt_copy)
    for i, (scene, stds, b, _) in enumerate(drawn):
        assert b == 0 and stds.shape == (2, A) == tuple(scene.actor_valid.shape)
        with torch.no_grad():
            _, want = model.encoder.forward_ood(scene, generator=step_generator("cpu", EVAL_SEED,
                                                                                i)[0])
        assert torch.equal(stds, want)


@pytest.mark.parametrize("flags", [["--ood"], ["--serving"], ["--serving", "--ood", "--only-agent"]])
def test_test_torch_ood_and_serving_give_finite_metrics(evaluated, flags):
    cfg, ckpt, _ = evaluated
    got = _test(cfg, ckpt, *flags)
    assert {"ADE_T", "FDE_T", "MR_T"} <= set(got)
    assert all(math.isfinite(v) for v in got.values())
    assert ("agent_std_mean" in got) == ("--ood" in flags)
