"""JAX's orbax checkpoints read into the port (``scripts/orbax_to_torch.py``,
``bridge.adamw_state_from_optax``) on the CPU.

The JAX package trains the small flagship two steps with its own train
step and saves with its own ``CheckpointManager``; the script converts the
step directory, and the port restores it:

* the parameters bit-equal to JAX's;
* AdamW's moments bit-equal to optax's ``mu`` / ``nu``, its step equal to
  the adam count, the schedule at the same update with the same rate;
* one more update with the same gradient in both within 1e-6 (AdamW's
  arithmetic in another order);
* ``train_torch.py --ckpt`` resumes it and trains on, ``--wonly`` and
  ``test_torch.py --ckpt`` take its weights.

The script's run is the flagship's (no ``nodecay``); optax's masked
weight decay (``nodecay: true``, the port's two parameter groups) goes
through the bridge on an optax state of its own.
"""
import importlib.util
import json
import math
import os

import jax
import numpy as np
import optax
import pytest
import torch

from trajsde_tpu.config import ExperimentConfig, build_losses as jax_build_losses
from trajsde_tpu.data.scene import strip_for_device as jax_strip
from trajsde_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from trajsde_tpu.train.loop import create_train_state as jax_create_train_state
from trajsde_tpu.train.loop import make_train_step as jax_make_train_step
from trajsde_tpu.train.optim import build_optimizer as jax_build_optimizer
from trajsde_tpu_torch.bridge import adamw_state_from_optax, params_from_flax, params_to_flax
from trajsde_tpu_torch.config import build_datamodule, load_config
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state
from trajsde_tpu_torch.train.optim import cosine_factor

import test_torch
import train_torch
from _torch_helpers import (jax_build_model, scene_pair, small_cfg, torch_build_model,
                            write_run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
JAX_STEPS = 2


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    cfg_path = write_run(tmp)
    cfg = load_config(cfg_path)
    for sec in ("encoder", "decoder"):      # JAX's plain paths (no interpret-mode Pallas)
        cfg[sec]["kwargs"]["fused"] = False
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    updates = len(build_datamodule(cfg).train_loader())

    jcfg = ExperimentConfig(cfg)
    jm = jax_build_model(jcfg)
    opt = jax_build_optimizer(cfg["training_specific"], updates)
    scenes = [jax_strip(scene_pair(s, 2, 6, 8)[0]) for s in (70, 71)]
    state = jax_create_train_state(jm, opt, scenes[0], seed=4)
    step = jax_make_train_step(jm, opt, jax_build_losses(jcfg), donate=False)
    for js in scenes[:JAX_STEPS]:
        state, logs = step(state, js)
        assert float(logs["train/step_skipped"]) == 0.0
    jckpt = JaxCheckpointManager(str(tmp / "jax_ckpt"))
    jckpt.save(state, metric=None, step=int(state.step))
    report = _script().main(["-c", cfg_path, "--jax-ckpt", jckpt.latest()["path"],
                             "--out", str(tmp / "torch_ckpt"), "--seed", "3"])
    return dict(cfg=cfg, cfg_path=cfg_path, tmp=tmp, opt=opt, state=state, updates=updates,
                report=report)


def _restored(cv):
    state = create_train_state(torch_build_model(cv["cfg"], device="cpu", seed=9),
                               cv["cfg"]["training_specific"], cv["updates"])
    CheckpointManager(str(cv["tmp"] / "torch_ckpt")).restore(state, cv["report"]["out"])
    return state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_the_script_writes_the_ports_layout(converted):
    r, out = converted["report"], converted["tmp"] / "torch_ckpt"
    assert r["step"] == JAX_STEPS and r["adam_count"] == JAX_STEPS
    assert r["schedule_position"] == JAX_STEPS and r["updates_per_epoch"] == converted["updates"]
    with open(out / "leaderboard.json") as f:
        board = json.load(f)
    assert board == [{"step": JAX_STEPS, "metric": None, "path": r["out"]}]
    saved = torch.load(os.path.join(r["out"], "state.pt"), weights_only=True)
    assert set(saved) == {"model", "optimizer", "scheduler", "step", "seed"}
    assert (saved["step"], saved["seed"]) == (JAX_STEPS, 3)


def test_parameters_and_adamw_state_are_jaxs(converted):
    state, jstate = _restored(converted), converted["state"]
    want = params_from_flax(_np(jstate.params))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    adam = _np(jstate.opt_state[0])
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt_state = state.optimizer.state
    assert len(opt_state) == len(want)
    for p, s in opt_state.items():
        n = names[id(p)]
        assert torch.equal(s["exp_avg"], mu[n]) and torch.equal(s["exp_avg_sq"], nu[n]), n
        assert float(s["step"]) == float(adam.count) == JAX_STEPS
    assert (state.step, state.seed, state.scheduler.last_epoch) == (JAX_STEPS, 3, JAX_STEPS)
    groups = state.optimizer.param_groups
    assert len(groups) == 1 and not converted["cfg"]["training_specific"]["nodecay"]
    tr = converted["cfg"]["training_specific"]
    lr = tr["lr"] * cosine_factor(JAX_STEPS, tr["T_max"] * converted["updates"], 0.0)
    assert all(g["lr"] == pytest.approx(lr, rel=1e-12) for g in groups)


def test_one_more_update_with_the_same_gradient_agrees(converted):
    state, jstate, opt = _restored(converted), converted["state"], converted["opt"]
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         _np(jstate.params))
    updates, _ = opt.update(grads, jstate.opt_state, jstate.params)
    want = params_from_flax(_np(optax.apply_updates(jstate.params, updates)))
    g = params_from_flax(grads)
    for n, p in state.model.named_parameters():
        p.grad = g[n].clone()
    state.optimizer.step()
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_the_ports_clis_take_the_converted_checkpoint(converted, tmp_path):
    path, cfg_path = converted["report"]["out"], converted["cfg_path"]
    common = ["-c", cfg_path, "--logdir", str(tmp_path), "--device", "cpu", "--epochs", "1"]
    state, trainer = train_torch.main(common + ["-n", "resumed", "--ckpt", path])
    assert state.step == JAX_STEPS + converted["updates"] and state.seed == 3
    assert trainer.epoch_logs[-1]["train/steps_skipped"] == 0.0
    warm, _ = train_torch.main(common + ["-n", "warm", "--wonly", path, "--epochs", "0"])
    want = params_from_flax(_np(converted["state"].params))
    assert warm.step == 0 and all(torch.equal(warm.model.state_dict()[k], want[k]) for k in want)
    results = test_torch.main(["-c", cfg_path, "--ckpt", path, "--device", "cpu"])
    assert {"ADE_T", "FDE_T", "MR_T"} <= set(results)
    assert all(math.isfinite(v) for v in results.values())


def test_the_bridge_maps_optax_masked_weight_decay_onto_the_groups():
    """``nodecay: true``: optax's ``MaskedState`` carries no numbers, the
    port's second group (no decay) holds the mask.  Two optax updates with
    random gradients on the port's seeded weights, bridged, then a third in
    both within 1e-6."""
    cfg = small_cfg()
    cfg["training_specific"].update(nodecay=True, weight_decay=0.05)
    updates = 3
    model = torch_build_model(cfg, device="cpu", seed=6)
    params = params_to_flax(model.state_dict())
    opt = jax_build_optimizer(cfg["training_specific"], updates)
    opt_state = opt.init(params)
    assert any(type(s).__name__ == "MaskedState" for s in opt_state)
    rng = np.random.default_rng(7)
    draw = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    for _ in range(2):
        u, opt_state = opt.update(draw(), opt_state, params)
        params = optax.apply_updates(params, u)

    state = create_train_state(model, cfg["training_specific"], updates)
    assert len(state.optimizer.param_groups) == 2
    model.load_state_dict(params_from_flax(_np(params)))
    sd, position = adamw_state_from_optax(_np(opt_state), model, state.optimizer)
    state.optimizer.load_state_dict(sd)
    _script().position_schedule(state.scheduler, position)
    assert position == 2 and state.scheduler.last_epoch == 2

    grads = draw()
    u, _ = opt.update(grads, opt_state, params)
    want = params_from_flax(_np(optax.apply_updates(params, u)))
    g = params_from_flax(grads)
    for n, p in model.named_parameters():
        p.grad = g[n].clone()
    state.optimizer.step()
    got = model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_the_bridge_refuses_a_state_without_adam_moments():
    cfg = small_cfg()
    state = create_train_state(torch_build_model(cfg, device="cpu"),
                               cfg["training_specific"], 1)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        adamw_state_from_optax((optax.EmptyState(),), state.model, state.optimizer)
