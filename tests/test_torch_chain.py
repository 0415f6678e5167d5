"""The chained train step (``train_torch.py --chain C``) vs the JAX package
and vs the eager step, on the CPU, where the chained update runs
uncaptured (on a card each update is one replay of its CUDA graph).

* a chain of 3 against three sequential ``jax.value_and_grad`` + optax
  AdamW / cosine updates with pinned noise (``tests/test_torch_accum.py``'s
  pattern): each update's loss rtol 2e-4, every leaf after the chain within
  2e-3 x scale + 1e-6, with Adam's eps at ``EPS`` on both sides, and the
  same with the port's ``encoder.remat`` on; and at the
  configured eps (1e-8), every entry but the attention key biases
  (``optim.noise_entries``), whose JAX gradient is rounding noise;
* the chain against three eager (``--chain 1``) steps: bit for bit on the
  CPU (on a card within ``optim.chain_eager_bound``, which an unchanged
  state and an update of the wrong sign fail);
* a NaN planted in update 2 of 3: ``train/step_skipped`` sums to 1, and the
  weights, the moments and the count are JAX's guarded update's;
* the logs aggregated as JAX's ``chained_step`` aggregates them, and the
  trainer's log cadence as JAX's ``fit``;
* ``--chain 2 --accum 2`` against ``--accum 2`` alone;
* ``train_torch.main --chain 2`` from npz files, a trailing partial chain,
  and resumes across ``--chain 1`` and ``--chain 2`` both ways.
"""
import copy
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from trajsde_tpu import losses as jlosses
from trajsde_tpu.train.optim import decay_mask as jax_decay_mask
from trajsde_tpu_torch.bridge import adamw_state_from_optax, params_from_flax
from trajsde_tpu_torch.config import build_losses
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.loop import (ChainedStep, Trainer, create_train_state,
                                          make_train_step)
from trajsde_tpu_torch.train.optim import (NOISE_GRAD, chain_eager_bound, grad_split,
                                           largest_gap, noise_entries)

import train_torch
from _torch_helpers import (check_leaves, model_pair, noise_for, scene_pair, small_cfg, t,
                            torch_build_model, write_run)

torch.set_num_threads(1)
B, A, L = 2, 5, 6
C = 3
TRAINING = {"lr": 0.003, "weight_decay": 0.01, "T_max": 1, "nodecay": True}
# Adam's eps in the comparison with JAX of every leaf.  At the configured
# 1e-8, Adam turns the rounding noise of a gradient that is zero in exact
# arithmetic (every attention key bias: the softmax does not see it; |g|
# ~ 1e-10 here, ``optim.noise_entries``) into a step of up to lr, and JAX's
# noise is not the port's, so those leaves differ by a step whatever
# either side computes.  At 1e-4 such a step is 1e-6 lr, while the other
# gradients (2e-3 to 1) still take steps of about lr.
EPS = 1e-4
CONFIGURED_EPS = 1e-8


def _cfg(fused=False, drop=0.0):
    cfg = small_cfg(Tf=60)
    cfg["encoder"]["kwargs"].update(dropout=drop, fused=fused)
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = fused
    cfg["training_specific"].update(TRAINING)
    return cfg


class _Pinned(nn.Module):
    """The model with each scene's noise pinned (looked up by the scene
    object), called as the train steps call a model."""

    def __init__(self, model, noise):
        super().__init__()
        self.model, self.noise = model, noise

    def forward(self, scene, generator=None, rollout_seed=None):
        en, tw, de = self.noise[id(scene)]
        return self.model(scene, enc_noise=en, twin_noise=tw, dec_noise=de)


def _jax_value_and_grad(jm):
    def jax_loss(p, js, en, tw, de):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    return jax.jit(jax.value_and_grad(jax_loss))


def _jax_updates(vg, params, tx, batches, noises):
    """Sequential ``value_and_grad`` + optax updates with JAX's NaN guard (a
    non-finite loss or gradient leaves the parameters and the optimizer
    state as they were): (losses, params, opt_state, each leaf's largest
    |gradient| over the updates, by the port's names)."""
    opt_state = tx.init(params)
    losses, largest = [], {}
    for js, n in zip(batches, noises):
        loss, grads = vg(params, js, *n)
        losses.append(float(loss))
        for k, g in params_from_flax(jax.tree.map(np.asarray, grads)).items():
            g = torch.as_tensor(g).abs().max() if g.size else torch.zeros(())
            largest[k] = torch.maximum(largest.get(k, g), g)
        finite = np.isfinite(float(loss)) and all(
            bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))
        if finite:
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
    return losses, params, opt_state, largest


@pytest.fixture(scope="module")
def jax_chain():
    """The small flagship (loop decoder, no dropout) in JAX and the port,
    three batches with their pinned noise, and JAX's three updates, clean
    and with a NaN in batch 2."""
    cfg = _cfg()
    pairs = [scene_pair(s, B, A, L) for s in (61, 62, 63)]
    jm, params, tm = model_pair(cfg, pairs[0][0])
    noises = [noise_for(cfg, B, A, seed=s) for s in (71, 72, 73)]
    tr = cfg["training_specific"]

    def tx(eps):   # trajsde_tpu/train/optim.py's cosine_adamw, at Adam's eps
        return optax.adamw(optax.cosine_decay_schedule(tr["lr"], tr["T_max"] * C, 0.0),
                           weight_decay=tr["weight_decay"], eps=eps, mask=jax_decay_mask)

    vg = _jax_value_and_grad(jm)
    js = [j for j, _ in pairs]
    clean = _jax_updates(vg, params, tx(EPS), js, noises)
    configured = _jax_updates(vg, params, tx(CONFIGURED_EPS), js, noises)
    bad = copy.deepcopy(pairs[1][1])
    bad.y[0, 0, 0, 0] = float("nan")
    js_bad = list(js)
    js_bad[1] = js[1].replace(y=jnp.asarray(bad.y.numpy()))
    guarded = _jax_updates(vg, params, tx(EPS), js_bad, noises)
    return dict(cfg=cfg, tm=tm, scenes=[s for _, s in pairs], bad=bad,
                noise=[tuple(t(a) for a in n) for n in noises], clean=clean, guarded=guarded,
                configured=configured)


def _chain(jc, scenes, eps=EPS, remat=False):
    """The port's chain of ``scenes`` on a copy of the bridged weights, at
    Adam's ``eps``, its encoder's AA and AL blocks rematerialized with
    ``remat``: (model, state, chained step, logs)."""
    model = copy.deepcopy(jc["tm"])
    model.encoder.remat = remat
    pinned = _Pinned(model, {id(s): n for s, n in zip(scenes, jc["noise"])})
    state = create_train_state(model, jc["cfg"]["training_specific"], steps_per_epoch=C)
    for group in state.optimizer.param_groups:
        group["eps"] = eps
    chained = ChainedStep(pinned, state.optimizer, state.scheduler, build_losses(jc["cfg"]),
                          "cpu", accum_steps=1)
    logs = chained(scenes, 0, 0)
    return model, state, chained, logs


@pytest.mark.parametrize("remat", [False, True])
def test_chain_of_3_meets_three_sequential_jax_updates(jax_chain, remat):
    """With ``encoder.remat`` too (JAX's ``nn.remat`` computes the plain
    model's math; ``tests/test_torch_remat.py`` holds both JAX forms to the
    port): the same JAX updates, the same bars."""
    jc = jax_chain
    model, state, chained, logs = _chain(jc, jc["scenes"], remat=remat)
    losses, params, _, _ = jc["clean"]
    per_update = chained.chain_logs[:, -2].tolist()   # train/total of each update
    np.testing.assert_allclose(per_update, losses, rtol=2e-4)
    check_leaves({n: p.detach() for n, p in model.named_parameters()},
                 params_from_flax(jax.tree.map(np.asarray, params)))
    assert logs["train/step_skipped"] == 0.0 and state.scheduler.last_epoch == C


def test_chain_of_3_meets_jax_at_the_configured_eps_but_the_noise_leaves(jax_chain):
    """At Adam's configured eps (1e-8) the losses meet JAX's at rtol 2e-4
    and every leaf at 2e-3 x scale + 1e-6, but the key-bias entries
    (``noise_entries``, by structure: the attention key biases), whose JAX
    gradient is rounding noise (max|g| over the three updates below
    NOISE_GRAD, every other leaf's above it)."""
    jc = jax_chain
    model, _, chained, _ = _chain(jc, jc["scenes"], eps=CONFIGURED_EPS)
    losses, params, _, largest = jc["configured"]
    np.testing.assert_allclose(chained.chain_logs[:, -2].tolist(), losses, rtol=2e-4)
    noise = noise_entries(dict(model.named_parameters()))
    assert noise and all(sl == slice(None) and re.search(r"\.lin_k(_edge)?\.bias$", n)
                         for n, sl in noise.items())
    on_noise, least, leaf = grad_split(largest, noise)
    assert 0.0 < on_noise < NOISE_GRAD <= least, (on_noise, least, leaf)
    want = params_from_flax(jax.tree.map(np.asarray, params))
    check_leaves({n: p.detach() for n, p in model.named_parameters() if n not in noise},
                 {n: w for n, w in want.items() if n not in noise})


def _moments(optimizer, model):
    """{name: (exp_avg, exp_avg_sq, step)} of every parameter with a state."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: (st["exp_avg"], st["exp_avg_sq"], float(st["step"]))
            for p, st in optimizer.state.items()}


def test_a_nan_in_update_2_of_3_is_jax_guarded_update(jax_chain):
    """Update 2 skipped: the sum of the skips is 1, the mean loss NaN, and
    the weights, the moments and the count are those of JAX's updates 1
    and 3 with update 2 guarded."""
    jc = jax_chain
    scenes = [jc["scenes"][0], jc["bad"], jc["scenes"][2]]
    model, state, chained, logs = _chain(jc, scenes)
    assert logs["train/step_skipped"] == 1.0 and math.isnan(logs["train/total"])
    assert chained.chain_logs[:, -1].tolist() == [0.0, 1.0, 0.0]
    _, params, opt_state, _ = jc["guarded"]
    check_leaves({n: p.detach() for n, p in model.named_parameters()},
                 params_from_flax(jax.tree.map(np.asarray, params)))
    want, position = adamw_state_from_optax(opt_state, model, state.optimizer)
    assert position == state.scheduler.last_epoch == 2
    got = _moments(state.optimizer, model)
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id[id(p)] for g in state.optimizer.param_groups for p in g["params"]]
    for i, st in want["state"].items():
        if names[i] not in got:   # no gradient (the pi head): JAX's moments stay 0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), names[i]
            continue
        exp_avg, exp_avg_sq, step = got[names[i]]
        assert step == float(st["step"]) == 2.0
        check_leaves({"m": exp_avg, "v": exp_avg_sq}, {"m": st["exp_avg"], "v": st["exp_avg_sq"]})


@pytest.fixture(scope="module")
def fused_model():
    """The small flagship with both fused paths (the plain K1-K4 on the
    CPU) and dropout live, seeded."""
    cfg = _cfg(fused=True, drop=0.1)
    return cfg, torch_build_model(cfg, device="cpu", seed=5)


def _states_equal(a, b) -> bool:
    """Two ``TrainState``s' weights, AdamW state and schedule bit for bit."""
    wa, wb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (all(torch.equal(wa[k], wb[k]) for k in wa)
            and oa["state"].keys() == ob["state"].keys()
            and all(torch.equal(oa["state"][i][k].cpu(), ob["state"][i][k].cpu())
                    for i in oa["state"] for k in oa["state"][i])
            and oa["param_groups"] == ob["param_groups"]
            and a.scheduler.state_dict() == b.scheduler.state_dict())


# (AA encoder fused, decoder fused, NaN planted in update): FLAGSHIP_H100's
# build with and without a NaN, then FLAGSHIP_TRAIN's, FLAGSHIP_FUSED's and
# FLAGSHIP's
BUILDS = [(True, True, None), (True, True, 1), (False, True, None), (True, False, None),
          (False, False, None)]


@pytest.mark.parametrize("enc_fused,dec_fused,nan_at", BUILDS)
def test_chain_is_the_eager_steps_bit_for_bit_on_the_cpu(fused_model, enc_fused, dec_fused,
                                                         nan_at):
    """Dropout, ts_drop and the kernels' in-kernel noise live, the rollout
    keys read from the chain's buffer: three chained updates give the
    eager steps' weights, moments, schedule and logs bit for bit on the
    CPU (and with a NaN in update 2, the eager guard's), on each build the
    chain runs.  On a card the bar is ``chain_eager_bound`` outside the
    noise leaves: the CPU's 0 meets it, the unchanged state and a chain
    that stepped each weight the other way fail it."""
    cfg, base = fused_model
    if not (enc_fused and dec_fused):
        cfg = _cfg(fused=False, drop=0.1)
        cfg["encoder"]["kwargs"]["fused"] = enc_fused
        cfg["decoder"]["kwargs"]["fused"] = dec_fused
        base = torch_build_model(cfg, device="cpu", seed=5)
    scenes = [scene_pair(s, B, A, L)[1] for s in (81, 82, 83)]
    if nan_at is not None:
        scenes[nan_at].x[0, 1, 3, 0] = float("nan")
    states = [create_train_state(copy.deepcopy(base), cfg["training_specific"],
                                 steps_per_epoch=C, seed=9) for _ in range(2)]
    losses = build_losses(cfg)
    eager = make_train_step(states[0].model, states[0].optimizer, states[0].scheduler, losses,
                            "cpu", ts_drop_rate=0.2)
    eager_logs = [eager(s, 4 + k, 9) for k, s in enumerate(scenes)]
    chained = ChainedStep(states[1].model, states[1].optimizer, states[1].scheduler, losses,
                          "cpu", ts_drop_rate=0.2, accum_steps=1)
    logs = chained(scenes, 4, 9)
    assert _states_equal(*states)
    want = torch.stack([torch.stack([*(l[n] for n in chained.names),
                                     torch.tensor(l["train/step_skipped"])]) for l in eager_logs])
    torch.testing.assert_close(chained.chain_logs, want, rtol=0, atol=0, equal_nan=True)
    assert logs["train/step_skipped"] == (0.0 if nan_at is None else 1.0)
    assert logs["scenes"] == C * B and logs["stop"] is False
    bound = chain_eager_bound(cfg["training_specific"]["lr"], C)
    start, after = base.state_dict(), states[0].model.state_dict()
    noise = noise_entries(after)
    assert largest_gap(states[1].model.state_dict(), after, noise)[0] <= bound
    assert largest_gap(start, after, noise)[0] > bound
    assert largest_gap({k: 2 * v - after[k] for k, v in start.items()}, after, noise)[0] > bound


def test_logs_are_aggregated_as_jax_chained_step_and_logged_on_its_cadence(fused_model):
    """The chain's logs are ``jax.tree.map(jnp.mean, logs_c)`` of its
    updates' logs with ``train/step_skipped`` their sum (JAX's
    ``chained_step``; a NaN update's NaN stays in the mean); ``fit``
    writes a record when the step crosses a multiple of ``log_every``
    (JAX's ``fit``): 7 batches in chains of 3 at log_every 2 log at steps
    3 and 6, and the trailing chain of 1 trains."""
    cfg, base = fused_model
    scenes = [scene_pair(s, B, A, L)[1] for s in range(90, 97)]
    scenes[1].y[0, 0, 0, 0] = float("nan")
    state = create_train_state(copy.deepcopy(base), cfg["training_specific"],
                               steps_per_epoch=7)
    log = _Log()
    trainer = Trainer(build_losses(cfg), [], device="cpu", logger=log, log_every=2,
                      chain_steps=3)
    trainer.fit(state, lambda: scenes, lambda: [], max_epochs=1)
    assert state.step == 7 and state.scheduler.last_epoch == 6
    rows = [(step, row) for step, row in log.rows if "train/total" in row]
    assert [step for step, _ in rows] == [3, 6]
    assert math.isnan(rows[0][1]["train/total"]) and rows[0][1]["train/step_skipped"] == 1.0
    assert rows[1][1]["train/step_skipped"] == 0.0 and rows[1][1]["train/steps_skipped_cum"] == 1.0
    assert trainer.epoch_logs[-1]["train/steps_skipped"] == 1.0

    chained = ChainedStep(state.model, state.optimizer, state.scheduler, build_losses(cfg),
                          "cpu", accum_steps=1)
    logs = chained(scenes[:3], 7, 0)
    per = chained.chain_logs.numpy()
    logs_c = {n: jnp.asarray(per[:, i]) for i, n in enumerate(chained.names)}
    logs_c["train/step_skipped"] = jnp.asarray(per[:, -1])
    want = jax.tree.map(jnp.mean, logs_c)
    want["train/step_skipped"] = jnp.sum(logs_c["train/step_skipped"])
    # the same mean up to the last f32 bit (XLA and torch divide by 3 apart)
    for k, v in want.items():
        np.testing.assert_allclose(np.float32(logs[k]), np.asarray(v), rtol=3e-7, err_msg=k)
    assert logs["train/step_skipped"] == float(want["train/step_skipped"]) == 1.0


class _Log:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, values):
        self.rows.append((step, {k: float(v) for k, v in values.items()}))


def test_chain_2_accum_2_is_accum_2_alone_bit_for_bit(fused_model):
    """5 batches at accum 2: groups of 2, 2 and 1, chained as 2 + 1; the
    three updates equal ``--accum 2``'s eager updates bit for bit."""
    cfg, base = fused_model
    batches = [scene_pair(s, B, A, L)[1] for s in range(100, 105)]
    states = []
    for chain in (1, 2):
        state = create_train_state(copy.deepcopy(base), cfg["training_specific"],
                                   steps_per_epoch=3, seed=2)
        trainer = Trainer(build_losses(cfg), [], device="cpu", accum_steps=2, chain_steps=chain,
                          ts_drop_rate=0.2)
        trainer.fit(state, lambda: batches, lambda: [], max_epochs=1)
        assert state.step == 3 and state.scheduler.last_epoch == 3
        states.append(state)
    assert _states_equal(*states)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


def _train_records(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if "train/total" in r]


def test_train_torch_chain_trains_from_files_and_resumes_across_chain_lengths(tmp_path):
    """12 train scenes at batch 4: 3 batches, chained 2 + 1.  ``--chain 2``
    logs once a chain (steps 2 and 3), the trailing chain of 1 trains, and
    its checkpoint resumes under ``--chain 1``; the reverse order (``--chain
    1`` then ``--chain 2``) reaches the same state bit for bit, as every
    chained update on the CPU is the eager step's."""
    cfg = write_run(tmp_path)
    logdir = tmp_path / "logs"
    finals = []
    for name, first, then in (("chained_first", "2", "1"), ("eager_first", "1", "2")):
        common = ["-c", cfg, "-n", name, "--logdir", str(logdir), "--device", "cpu",
                  "--epochs", "1"]
        state, trainer = train_torch.main(common + ["--chain", first])
        assert state.step == 3 and trainer.chain_steps == int(first)
        assert trainer.epoch_logs[-1]["train/steps_skipped"] == 0.0
        steps = [r["step"] for r in _train_records(logdir / name)]
        assert steps == ([2, 3] if first == "2" else [1, 2, 3])
        latest = trainer.checkpointer.latest()
        assert latest["step"] == 3
        resumed, _ = train_torch.main(common + ["--chain", then, "--ckpt", latest["path"]])
        assert resumed.step == 6 and resumed.scheduler.last_epoch == 6
        steps = [r["step"] for r in _train_records(logdir / name)]
        assert steps == ([2, 3, 4, 5, 6] if first == "2" else [1, 2, 3, 5, 6])
        finals.append(resumed)
    assert _states_equal(*finals)


def test_a_state_converted_from_optax_resumes_under_the_chain_as_under_eager(jax_chain):
    """JAX's weights and optax state after its three updates, converted as
    ``scripts/orbax_to_torch.py`` converts them (``adamw_state_from_optax``,
    the schedule put at its position), train on through a chain of 2 and
    through 2 eager steps to the same bits."""
    from scripts.orbax_to_torch import position_schedule

    jc = jax_chain
    _, params, opt_state, _ = jc["clean"]
    states = []
    for _ in range(2):
        model = copy.deepcopy(jc["tm"])
        model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
        state = create_train_state(model, jc["cfg"]["training_specific"], steps_per_epoch=C)
        sd, position = adamw_state_from_optax(opt_state, model, state.optimizer)
        state.optimizer.load_state_dict(sd)
        position_schedule(state.scheduler, position)
        state.step = position
        states.append(state)
    scenes = jc["scenes"][:2]
    pinned = [_Pinned(s.model, {id(x): n for x, n in zip(scenes, jc["noise"])}) for s in states]
    losses = build_losses(jc["cfg"])
    eager = make_train_step(pinned[0], states[0].optimizer, states[0].scheduler, losses, "cpu")
    for k, scene in enumerate(scenes):
        eager(scene, C + k, 0)
    chained = ChainedStep(pinned[1], states[1].optimizer, states[1].scheduler, losses, "cpu",
                          accum_steps=1)
    chained(scenes, C, 0)
    assert states[1].scheduler.last_epoch == C + 2
    assert _states_equal(*states)
