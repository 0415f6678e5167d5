"""Gradient accumulation (``train_torch.py --accum K``) vs the JAX package on
the CPU.

* ``group_microbatches`` forms JAX's groups on a mixed-shape stream, a
  trailing partial group included;
* an accum-2 update's gradients and loss equal the mean of
  ``jax.value_and_grad`` over the same two micro-batches with pinned noise
  (``tests/test_torch_train.py``'s ``step_parity`` pattern: every leaf
  within 2e-3 x scale + 1e-6, the loss rtol 2e-4);
* with the fused encoder and decoder (the plain K1-K4 through their
  ``autograd.Function``s) the update's gradients are ``(g1 + g2) / 2`` of the
  two micro-batches run alone with the same seeds, bit for bit;
* a NaN in one micro-batch skips the whole update; the schedule and
  ``state.step`` advance once per update, ``ceil(batches / K)`` an epoch;
* ``train_torch.main(--accum 2)`` trains and resumes.
"""
import copy
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch import nn

from trajsde_tpu import losses as jlosses
from trajsde_tpu.train.loop import group_microbatches as jax_group_microbatches
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import build_losses
from trajsde_tpu_torch.ops.sde_rollout import mix_seed
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.loop import (Trainer, create_train_state, group_microbatches,
                                          make_train_step, micro_seeds)
from trajsde_tpu_torch.train.optim import cosine_factor

import train_torch
from _torch_helpers import (SCENE_FIELDS, check_leaves, model_pair, noise_for, scene_pair,
                            small_cfg, t, torch_build_model, write_run)

torch.set_num_threads(1)
B, A, L = 2, 5, 6


def _cfg(fused=False, drop=0.0):
    cfg = small_cfg(Tf=60)
    cfg["encoder"]["kwargs"].update(dropout=drop, fused=fused)
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = fused
    return cfg


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------
def test_grouping_matches_jax_on_a_mixed_shape_stream():
    """Shapes a a b a b b a c (b: other lanes only, c: other actors) in
    groups of 2: full groups as they fill, then the partial ones."""
    shapes = {"a": (5, 6), "b": (5, 8), "c": (4, 6)}
    stream = [scene_pair(10 + i, B, *shapes[k]) for i, k in enumerate("aababbac")]
    want = list(jax_group_microbatches([js for js, _ in stream], 2))
    got = list(group_microbatches([ts for _, ts in stream], 2))
    assert [len(g) for g in got] == [2, 2, 2, 1, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(np.stack([getattr(s, f).numpy() for s in g]),
                                          np.asarray(getattr(w, f)), err_msg=f)
    # k = 1 passes every batch on alone, in order
    ones = list(group_microbatches([ts for _, ts in stream], 1))
    assert [g[0] for g in ones] == [ts for _, ts in stream]


def test_micro_seeds_are_the_steps_seed_alone_and_distinct_in_a_group():
    s = mix_seed(3, 7)
    assert micro_seeds(s, 1) == [s]
    seeds = micro_seeds(s, 4)
    assert len(set(seeds + [s, mix_seed(s, 1)])) == 6


# ---------------------------------------------------------------------------
# one accumulated update vs jax.value_and_grad
# ---------------------------------------------------------------------------
class _Pinned(nn.Module):
    """The model with each micro-batch's noise pinned (looked up by the
    scene object), called as the train step calls a model."""

    def __init__(self, model, noise):
        super().__init__()
        self.model, self.noise = model, noise

    def forward(self, scene, generator=None, rollout_seed=None):
        en, tw, de = self.noise[id(scene)]
        return self.model(scene, enc_noise=en, twin_noise=tw, dec_noise=de)


@pytest.fixture(scope="module")
def accum_parity():
    cfg = _cfg()
    pairs = [scene_pair(s, B, A, L) for s in (31, 32)]
    jm, params, tm = model_pair(cfg, pairs[0][0])
    noises = [noise_for(cfg, B, A, seed=s) for s in (41, 42)]

    def jax_loss(p, js, en, tw, de):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    vg = jax.jit(jax.value_and_grad(jax_loss))
    results = [vg(params, js, *n) for (js, _), n in zip(pairs, noises)]
    loss = float(np.mean([float(r[0]) for r in results]))
    grads = jax.tree.map(lambda a, b: (a + b) * 0.5, results[0][1], results[1][1])
    return dict(cfg=cfg, tm=tm, scenes=[ts for _, ts in pairs],
                noise=[tuple(t(a) for a in n) for n in noises], loss=loss,
                grads=params_from_flax(jax.tree.map(np.asarray, grads)))


def test_accum_2_update_grads_match_the_mean_of_jax_value_and_grad(accum_parity):
    ap = accum_parity
    model = copy.deepcopy(ap["tm"])
    pinned = _Pinned(model, {id(s): n for s, n in zip(ap["scenes"], ap["noise"])})
    state = create_train_state(model, ap["cfg"]["training_specific"], steps_per_epoch=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(pinned, state.optimizer, state.scheduler, build_losses(ap["cfg"]),
                           "cpu")
    logs = step(ap["scenes"], 0, 0)
    assert logs["train/step_skipped"] == 0.0
    np.testing.assert_allclose(float(logs["train/total"]), ap["loss"], rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()}, ap["grads"])
    # one update on them
    assert state.scheduler.last_epoch == 1
    assert not torch.equal(model.state_dict()["decoder.aggr_dense.weight"],
                           before["decoder.aggr_dense.weight"])


def _micro_alone(model, cfg, scene, s):
    """One micro-batch's loss and backward as the train step runs it."""
    gen = torch.Generator().manual_seed(s)
    out = model(scene, generator=gen, rollout_seed=s)
    total = 0.0
    for _, w, fn in build_losses(cfg):
        total = total + w * fn(out["y"], out)
    total.backward()
    return total.detach()


@pytest.mark.parametrize("fused", [False, True])
def test_accum_grads_are_the_mean_of_the_micro_batches_alone_bit_for_bit(fused):
    """Dropout live, draws from the micro-batches' own seeds; with
    ``fused`` the K1-K4 ``autograd.Function``s add into ``.grad``."""
    cfg = _cfg(fused=fused, drop=0.1)
    scenes = [scene_pair(s, B, A, L)[1] for s in (33, 34)]
    model = torch_build_model(cfg, device="cpu", seed=2).train()
    seeds = micro_seeds(mix_seed(5, 3), 2)
    alone = []
    for scene, s in zip(scenes, seeds):
        model.zero_grad(set_to_none=True)
        _micro_alone(model, cfg, scene, s)
        alone.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=5)
    make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), "cpu")(
        scenes, 3, 5)
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(alone[0]) == set(alone[1])
    for n in got:
        assert torch.equal(got[n], (alone[0][n] + alone[1][n]) / 2), n


def test_a_nan_in_one_micro_batch_skips_the_whole_update():
    cfg = _cfg()
    scenes = [scene_pair(s, B, A, L)[1] for s in (35, 36)]
    scenes[1].x[0, 0, -1, 0] = float("nan")
    model = torch_build_model(cfg, device="cpu", seed=3)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           "cpu")(scenes, 0, 0)
    assert logs["train/step_skipped"] == 1.0 and not math.isfinite(float(logs["train/total"]))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert state.optimizer.state_dict()["state"] == {} and state.scheduler.last_epoch == 0


def test_the_schedule_steps_once_per_update():
    """5 batches at accum 2: 3 updates (the last of one batch), the step,
    the schedule and AdamW's count all at 3, sized on ceil(5 / 2)."""
    cfg = _cfg()
    batches = [scene_pair(s, B, A, L)[1] for s in range(50, 55)]
    updates = -(-len(batches) // 2)
    state = create_train_state(torch_build_model(cfg, device="cpu"), cfg["training_specific"],
                               steps_per_epoch=updates)
    trainer = Trainer(build_losses(cfg), [], device="cpu", accum_steps=2)
    trainer.fit(state, lambda: batches, lambda: [], max_epochs=1)
    assert state.step == 3 and state.scheduler.last_epoch == 3
    assert {float(v["step"]) for v in state.optimizer.state_dict()["state"].values()} == {3.0}
    tr = cfg["training_specific"]
    want = tr["lr"] * cosine_factor(3, tr["T_max"] * updates, 0.0)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)
    assert trainer.epoch_logs[-1]["perf/scenes_per_s"] > 0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


def test_train_torch_accum_trains_and_resumes(tmp_path):
    """12 train scenes at batch 4: 3 batches, 2 updates an epoch (the second
    of one batch)."""
    cfg = write_run(tmp_path)
    common = ["-c", cfg, "-n", "acc", "--logdir", str(tmp_path / "logs"), "--device", "cpu",
              "--epochs", "1", "--accum", "2"]
    state, trainer = train_torch.main(common)
    assert state.step == 2 and state.scheduler.last_epoch == 2
    assert trainer.accum_steps == 2 and trainer.epoch_logs[-1]["train/steps_skipped"] == 0.0
    latest = trainer.checkpointer.latest()
    assert latest["step"] == 2
    resumed, _ = train_torch.main(common + ["--ckpt", latest["path"]])
    assert resumed.step == 4 and resumed.scheduler.last_epoch == 4
    tr = json.loads(open(cfg).read())["training_specific"]
    want = tr["lr"] * cosine_factor(4, tr["T_max"] * 2, 0.0)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)
