"""Asynchronous checkpoints (``train_torch.py --async-ckpt``,
``CheckpointManager(async_save=True)``) on the CPU, as
``trajsde_tpu/train/checkpoint.py`` keeps them:

* the state is copied to host memory before ``save`` returns, so values
  changed in place right after it (the next ``optimizer.step()``) do not
  reach the file;
* the board lists a save only once its write has landed; the next save,
  ``wait()``, ``latest()`` / ``best()`` and a restore land it first;
* a prune spares a save still being written;
* a preemption save is synchronous, and ``Trainer.fit`` returns with its
  last save landed;
* ``train_torch.main(--async-ckpt --accum 2)`` trains and resumes.

The writer is held at ``torch.save`` by an event, so each test sees the
write in flight.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from trajsde_tpu_torch.config import build_losses, build_metrics
from trajsde_tpu_torch.train import checkpoint as tcheckpoint
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import Trainer, create_train_state, make_train_step

import train_torch
from _torch_helpers import scene_pair, small_cfg, torch_build_model, write_run

torch.set_num_threads(1)
B, A, L = 2, 5, 6
TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


@pytest.fixture
def held(monkeypatch):
    """An event that ``torch.save`` in the checkpoint module waits on
    (set it to let writes through); set again at teardown.  Its
    ``entered`` event is set when a write reaches ``torch.save``."""
    gate = threading.Event()
    gate.entered = threading.Event()
    real = torch.save

    def save(obj, f, *a, **kw):
        gate.entered.set()
        assert gate.wait(TIMEOUT_S), "the test never released the writer"
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(tcheckpoint.torch, "save", save)
    yield gate
    gate.set()


def _state(seed=0, steps=1):
    """A small flagship TrainState after ``steps`` updates (AdamW moments
    present)."""
    cfg = small_cfg(Tf=60)
    state = create_train_state(torch_build_model(cfg, device="cpu", seed=seed),
                               cfg["training_specific"], steps_per_epoch=4, seed=seed)
    step = make_train_step(state.model, state.optimizer, state.scheduler, build_losses(cfg),
                           "cpu")
    scene = scene_pair(60, B, A, L)[1]
    for _ in range(steps):
        step(scene, state.step, state.seed)
        state.step += 1
    return cfg, state


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in state.optimizer.state_dict()["state"].items()})


def _board(directory):
    with open(os.path.join(directory, "leaderboard.json")) as f:
        return json.load(f)


def _release_later(gate, seconds=0.3):
    timer = threading.Timer(seconds, gate.set)
    timer.start()
    return timer


def test_async_save_writes_the_values_at_save_time(tmp_path, held):
    cfg, state = _state()
    params, moments = _snapshot(state)
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    path = ckpt.save(state, metric=0.5, step=state.step)
    # the next update's in-place writes, while the file is still unwritten
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for s in state.optimizer.state.values():
            s["exp_avg"].mul_(3.0)
            s["step"].add_(5.0)
    state.step += 7
    held.set()
    ckpt.wait()
    restored = create_train_state(torch_build_model(cfg, device="cpu", seed=9),
                                  cfg["training_specific"], steps_per_epoch=4)
    CheckpointManager(str(tmp_path)).restore(restored, path)
    assert restored.step == 1
    got = restored.model.state_dict()
    assert all(torch.equal(got[k], params[k]) for k in params)
    sd = restored.optimizer.state_dict()["state"]
    assert all(torch.equal(sd[i][k], moments[i][k]) for i in moments for k in moments[i])


def test_the_board_lists_a_save_only_once_it_has_landed(tmp_path, held):
    _, state = _state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    held.set()
    first = ckpt.save(state, metric=0.5, step=1, wait=True)    # synchronous despite async_save
    assert [e["path"] for e in _board(tmp_path)] == [first] and os.path.isdir(first)
    held.clear()
    held.entered.clear()
    path = ckpt.save(state, metric=0.3, step=2)
    assert held.entered.wait(TIMEOUT_S)
    assert not os.path.exists(path) and os.path.isdir(path + ".tmp")
    assert [e["step"] for e in _board(tmp_path)] == [1]
    timer = _release_later(held)
    assert ckpt.latest()["step"] == 2            # latest() lands it first
    timer.join()
    assert [e["step"] for e in _board(tmp_path)] == [1, 2] and os.path.isdir(path)
    # the next save lands the one in flight before it starts
    held.clear()
    ckpt.save(state, metric=0.2, step=3)
    timer = _release_later(held)
    ckpt.save(state, metric=0.1, step=4)
    timer.join()
    assert [e["step"] for e in _board(tmp_path)] == [1, 2, 3]
    ckpt.wait()
    assert [e["step"] for e in _board(tmp_path)] == [1, 2, 3, 4]
    assert ckpt.best()["step"] == 4


def test_a_restore_lands_the_save_in_flight(tmp_path, held):
    cfg, state = _state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    path = ckpt.save(state, metric=None, step=5)
    timer = _release_later(held)
    other = create_train_state(torch_build_model(cfg, device="cpu", seed=9),
                               cfg["training_specific"], steps_per_epoch=4)
    ckpt.restore(other, path)                     # waits for the write, then reads it
    timer.join()
    a, b = state.model.state_dict(), other.model.state_dict()
    assert other.step == state.step and all(torch.equal(a[k], b[k]) for k in a)
    assert ckpt.latest()["path"] == path


def test_the_prune_spares_a_save_in_flight(tmp_path, held):
    """save_top_k 1, keep_last off: a worse save in flight is not on the
    board, so a prune in the meantime cannot take it; it lands, and only
    the next landing prunes it by its metric."""
    _, state = _state()
    ckpt = CheckpointManager(str(tmp_path), save_top_k=1, keep_last=False, async_save=True)
    held.set()
    best = ckpt.save(state, metric=0.1, step=1, wait=True)
    held.clear()
    held.entered.clear()
    worse = ckpt.save(state, metric=0.9, step=2)
    assert held.entered.wait(TIMEOUT_S)
    ckpt._prune()
    assert os.path.isdir(worse + ".tmp") and os.path.isdir(best)
    held.set()
    ckpt.wait()
    # it landed, then the landing's prune took it by its metric
    assert [e["step"] for e in _board(tmp_path)] == [1]
    assert not os.path.exists(worse) and not os.path.exists(worse + ".tmp")


def test_a_preemption_save_is_synchronous(tmp_path, held):
    _, state = _state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    trainer = Trainer(build_losses(small_cfg(Tf=60)), [], device="cpu", checkpointer=ckpt)
    held.set()
    trainer._emergency_stop(state)
    assert ckpt._pending is None
    assert [e["step"] for e in _board(tmp_path)] == [state.step]
    assert os.path.isfile(os.path.join(_board(tmp_path)[0]["path"], "state.pt"))


def test_fit_returns_with_its_last_async_save_landed(tmp_path):
    cfg = small_cfg(Tf=60)
    batches = [scene_pair(s, B, A, L)[1] for s in (61, 62)]
    state = create_train_state(torch_build_model(cfg, device="cpu"), cfg["training_specific"],
                               steps_per_epoch=2)
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    Trainer(build_losses(cfg), build_metrics(cfg), device="cpu", checkpointer=ckpt).fit(
        state, lambda: batches, lambda: batches, max_epochs=2)
    assert ckpt._pending is None
    board = _board(tmp_path)
    assert [e["step"] for e in board][-1] == 4 and all(os.path.isdir(e["path"]) for e in board)


def test_train_torch_async_ckpt_trains_and_resumes(tmp_path):
    cfg = write_run(tmp_path)
    common = ["-c", cfg, "-n", "async", "--logdir", str(tmp_path / "logs"), "--device", "cpu",
              "--epochs", "1", "--accum", "2", "--async-ckpt"]
    state, trainer = train_torch.main(common)
    assert trainer.checkpointer.async_save and trainer.checkpointer._pending is None
    board = _board(os.path.join(tmp_path, "logs", "async", "checkpoints"))
    assert [e["step"] for e in board] == [2] and np.isfinite(board[0]["metric"])
    resumed, _ = train_torch.main(common + ["--ckpt", board[0]["path"]])
    assert resumed.step == 4
    board = _board(os.path.join(tmp_path, "logs", "async", "checkpoints"))
    assert [e["step"] for e in board] == [2, 4]
