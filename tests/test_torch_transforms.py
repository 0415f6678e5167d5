"""The port's scene transforms vs the JAX package's on the CPU, bit for bit.

* ``ts_drop`` fed JAX's own uniform draws, at rates 0, 0.5 and 0.9;
* ``take_per_scene``, ``leave_only_agent`` and ``leave_only_agent_output``;
* ``ts_drop`` inside the train step: its mask comes from a generator of its
  own, so it leaves every other draw of the step as it was.
"""
import jax
import numpy as np
import pytest
import torch

from trajsde_tpu.data import transforms as jt
from trajsde_tpu_torch.config import build_losses
from trajsde_tpu_torch.data import transforms as tt
from trajsde_tpu_torch.ops.sde_rollout import mix_seed
from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

from _torch_helpers import SCENE_FIELDS, scene_pair, small_cfg, torch_build_model

torch.set_num_threads(1)
B, A, L = 3, 6, 8


def _scene_pair(seed):
    """A JAX batch and the port's copy, with ``goal_idcs`` / ``has_goal``
    so the only-agent filter's optional fields are exercised."""
    js, ts = scene_pair(seed, B, A, L, sources=(0, 1, 0))
    r = np.random.default_rng(seed + 100)
    goal = (r.uniform(size=(B, A, L)) < 0.2).astype(np.float32)
    has = r.uniform(size=(B, A)) < 0.6
    js = js.replace(goal_idcs=jax.numpy.asarray(goal), has_goal=jax.numpy.asarray(has))
    ts.goal_idcs, ts.has_goal = torch.from_numpy(goal), torch.from_numpy(has)
    return js, ts


def _equal(jv, tv, what):
    if jv is None or tv is None:
        assert jv is None and tv is None, what
        return
    j, t = np.asarray(jv), tv.numpy()
    assert j.shape == t.shape, (what, j.shape, t.shape)
    if j.dtype.kind in "iu":
        np.testing.assert_array_equal(j.astype(np.int64), t.astype(np.int64), err_msg=what)
    else:
        assert j.dtype == t.dtype, (what, j.dtype, t.dtype)
        np.testing.assert_array_equal(j, t, err_msg=what)


@pytest.mark.parametrize("rate", [0.0, 0.5, 0.9])
def test_ts_drop_bit_equal_to_jax(rate):
    js, ts = _scene_pair(1)
    key = jax.random.key(7)
    want = jt.ts_drop(js, rate, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, js.bos_mask.shape)))
    got = tt.ts_drop(ts, rate, u=u)
    for f in SCENE_FIELDS:
        _equal(getattr(want, f), getattr(got, f), f)
    dropped = got.padding_mask[:, :, :ts.historical_steps] & ~ts.padding_mask[:, :, :ts.historical_steps]
    assert (int(dropped.sum()) > 0) == (rate > 0)
    assert not dropped[:, :, -1].any() and not (dropped & ts.bos_mask).any()
    assert torch.equal(ts.x, _scene_pair(1)[1].x)   # the input is left as it was


def test_ts_drop_draws_from_the_generator():
    _, ts = _scene_pair(2)
    a = tt.ts_drop(ts, 0.5, torch.Generator().manual_seed(3))
    b = tt.ts_drop(ts, 0.5, u=torch.rand(ts.bos_mask.shape, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(a.x, b.x) and torch.equal(a.padding_mask, b.padding_mask)


@pytest.mark.parametrize("axis", [1, 2])
def test_take_per_scene_bit_equal_to_jax(axis):
    r = np.random.default_rng(axis)
    arr = r.normal(size=(B, 4, A, 5)).astype(np.float32)
    if axis == 1:
        arr = arr.reshape(B, 4 * A, 5)[:, :A]
    idx = np.array([2, 0, 5], np.int32)
    want = jt.take_per_scene(jax.numpy.asarray(arr), jax.numpy.asarray(idx), axis=axis)
    got = tt.take_per_scene(torch.from_numpy(arr), torch.from_numpy(idx), axis=axis)
    _equal(want, got, f"axis {axis}")
    assert jt.take_per_scene(None, idx) is None and tt.take_per_scene(None, idx) is None


def test_leave_only_agent_bit_equal_to_jax():
    js, ts = _scene_pair(4)
    want, got = jt.leave_only_agent(js), tt.leave_only_agent(ts)
    for f in SCENE_FIELDS + ("goal_idcs", "has_goal"):
        _equal(getattr(want, f), getattr(got, f), f)
    assert got.x.shape[1] == 1 and not got.agent_index.any() and not got.av_index.any()


def test_leave_only_agent_output_bit_equal_to_jax():
    r = np.random.default_rng(5)
    K, Tf = 3, 7
    out = {"loc": r.normal(size=(B, K, A, Tf, 4)).astype(np.float32),
           "pi": r.normal(size=(B, A, K)).astype(np.float32),
           "y": r.normal(size=(B, A, Tf, 2)).astype(np.float32),
           "reg_mask": r.uniform(size=(B, A, Tf)) < 0.7,
           "extra": r.normal(size=(B,)).astype(np.float32)}
    idx = np.array([1, 5, 0], np.int32)
    for drop in ((), ("pi", "y")):
        o = {k: v for k, v in out.items() if k not in drop}
        want = jt.leave_only_agent_output({k: jax.numpy.asarray(v) for k, v in o.items()},
                                          jax.numpy.asarray(idx))
        got = tt.leave_only_agent_output({k: torch.from_numpy(v) for k, v in o.items()},
                                         torch.from_numpy(idx))
        assert set(want) == set(got)
        for k in want:
            _equal(want[k], got[k], k)


def _step(cfg, rate, seed=0):
    model = torch_build_model(cfg, device="cpu", seed=seed).train()
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=4)
    return model, make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                                  "cpu", ts_drop_rate=rate)


def test_train_step_ts_drop_keeps_the_other_draws():
    """At a rate that drops nothing the step is bit-equal to the step
    without ``ts_drop`` (so no other draw moved); at 0.5 it is the plain
    step on the scene ``ts_drop`` makes with ``mix_seed(s, 1)``."""
    cfg = small_cfg(Tf=60)
    cfg["decoder"]["kwargs"]["fused"] = True
    _, ts = _scene_pair(6)
    step_no = 3
    base_model, base = _step(cfg, 0.0)
    want = float(base(ts, step_no, 9)["train/total"])
    model, tiny = _step(cfg, 1e-12)
    assert float(tiny(ts, step_no, 9)["train/total"]) == want
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), base_model.parameters()))

    s = mix_seed(9, step_no)
    dropped = tt.ts_drop(ts, 0.5, torch.Generator().manual_seed(mix_seed(s, 1)))
    assert not torch.equal(dropped.padding_mask, ts.padding_mask)
    _, half = _step(cfg, 0.5)
    _, plain = _step(cfg, 0.0)
    assert float(half(ts, step_no, 9)["train/total"]) == float(plain(dropped, step_no, 9)["train/total"])
