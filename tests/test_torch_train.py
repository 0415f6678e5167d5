"""The port's training slice vs the JAX package on the CPU.

* losses, metrics, the weight-decay mask and AdamW + cosine vs JAX/optax;
* real dropout (flax semantics, the caller's generator) and a serving
  path that stays in eval mode;
* the fused decoder keeps the unfused decoder's parameter names;
* one whole train step (loss and every gradient leaf) of the tiny flagship
  vs ``jax.value_and_grad``, with pinned noise and dropout 0, through the
  unfused decoder and through the fused rollout (plain K1 + plain K2);
* the eval step vs JAX's, the NaN guard, and the ``Trainer`` with its
  checkpoints.

Tolerances: losses and metrics rtol 1e-5 (same f32 math); optimizer
params atol 1e-6 over 5 updates; gradient leaves max|diff| <= 2e-3 *
leaf scale + 1e-6 (``tests/test_reference_grad_parity.py``'s criterion)
and the loss rtol 2e-4 (21 encoder and 12 rollout steps in f32).
"""
import copy
import json
import math
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu.train import metrics as jmetrics
from trajsde_tpu.train.loop import make_eval_step as jax_make_eval_step
from trajsde_tpu.train.optim import build_optimizer as jax_build_optimizer, decay_mask as jax_decay_mask
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.config import build_losses, build_metrics
from trajsde_tpu_torch.models.layers import dropout
from trajsde_tpu_torch.server import ServingEngine
from trajsde_tpu_torch.train import metrics as tmetrics
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import (Trainer, TrainState, create_train_state,
                                          make_train_step)
from trajsde_tpu_torch.train.optim import build_optimizer, decay_mask

from _torch_helpers import (check_leaves, model_pair, noise_for, scene_pair, small_cfg, t,
                            torch_build_model)

torch.set_num_threads(1)
B, A, L = 2, 5, 6


def _cfg(Tf=12, drop=0.1, fused=False, lr=None):
    cfg = small_cfg(Tf=Tf)
    cfg["encoder"]["kwargs"]["dropout"] = drop
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = fused
    if lr is not None:
        cfg["training_specific"]["lr"] = lr
    return cfg


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------
def _loss_inputs(seed, all_masked=False):
    r = np.random.default_rng(seed)
    Bq, F, Aq, Tf = 3, 4, 5, 7
    out = dict(loc=r.normal(size=(Bq, F, Aq, Tf, 4)).astype(np.float32),
               reg_mask=np.zeros((Bq, Aq, Tf), bool) if all_masked else r.uniform(size=(Bq, Aq, Tf)) > 0.3,
               diff_in=r.uniform(size=(Bq,)).astype(np.float32),
               diff_out=r.uniform(size=(Bq,)).astype(np.float32),
               label_in=np.zeros(Bq, np.float32), label_out=np.ones(Bq, np.float32))
    out["loc"][..., 2:] = np.abs(out["loc"][..., 2:]) + 0.1
    out["loc"][:, 1] = out["loc"][:, 0]          # tied modes: the first wins
    out["diff_in"][0] = 0.0                      # clipped at 1e-6
    return r.normal(size=(Bq, Aq, Tf, 2)).astype(np.float32), out


@pytest.mark.parametrize("name", ["L2", "DiffBCE", "LaplaceNLLLoss"])
@pytest.mark.parametrize("all_masked", [False, True])
def test_losses_match_jax(name, all_masked):
    y, out = _loss_inputs(0, all_masked)
    want = float(jlosses.LOSS_REGISTRY[name](jnp.asarray(y), {k: jnp.asarray(v) for k, v in out.items()}))
    got = float(tlosses.LOSS_REGISTRY[name](t(y), {k: t(v) for k, v in out.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _metric_inputs():
    r = np.random.default_rng(1)
    Bq, K, Tf = 8, 4, 60
    pred = r.normal(scale=3.0, size=(Bq, K, Tf, 2)).astype(np.float32)
    pred[:, 2] = pred[:, 0]                      # ties resolve to the first mode
    target = r.normal(scale=3.0, size=(Bq, Tf, 2)).astype(np.float32)
    reg_mask = r.uniform(size=(Bq, Tf)) > 0.2
    reg_mask[1] = False                          # no valid step
    reg_mask[2, 59] = reg_mask[3, 29] = False    # invalid at the end index
    source = np.array([0, 1, 0, 1, 1, 0, 1, 0])
    return pred, target, reg_mask, source


@pytest.mark.parametrize("source_filter", [None, 0, 1])
@pytest.mark.parametrize("dataset", ["nuScenes", "Argoverse"])
@pytest.mark.parametrize("name", ["ADE_T", "FDE_T", "MR_T"])
def test_metrics_match_jax(name, dataset, source_filter):
    args = dict(dataset=dataset, end_idcs=[59, 29], source_filter=source_filter)
    jm, tm = jmetrics.TransferMetric(name, **args), tmetrics.TransferMetric(name, **args)
    assert jm.name == tm.name
    inputs = _metric_inputs()
    for half in (slice(0, 4), slice(4, 8)):
        part = [a[half] for a in inputs]
        jm.update(*[jnp.asarray(a) for a in part])
        tm.update(*[torch.from_numpy(np.array(a)) for a in part])
    np.testing.assert_allclose(tm.compute(), jm.compute(), rtol=1e-5)
    assert math.isnan(tmetrics.TransferMetric(name, **args).compute())   # empty -> NaN


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    js, ts = scene_pair(7, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    return dict(cfg=cfg, js=js, ts=ts, jm=jm, params=params, tm=tm)


def test_decay_mask_matches_jax(tiny):
    want = {k: bool(v) for k, v in params_from_flax(
        jax.tree.map(np.asarray, jax_decay_mask(tiny["params"]["params"]))).items()}
    got = decay_mask(tiny["tm"])
    assert got == want
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("nodecay", [False, True])
def test_adamw_cosine_matches_optax(tiny, nodecay):
    """5 updates on fixed grads; the 4-step cosine reaches its floor, so
    min(k, K) is exercised."""
    training = dict(tiny["cfg"]["training_specific"], lr=0.01, weight_decay=0.1, T_max=2,
                    nodecay=nodecay)
    p = tiny["params"]["params"]
    tx = jax_build_optimizer(training, steps_per_epoch=2)
    opt_state = tx.init(p)
    model = torch_build_model(tiny["cfg"], device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, p)))
    optimizer, scheduler = build_optimizer(model, training, steps_per_epoch=2)
    params = dict(model.named_parameters())
    r = np.random.default_rng(3)
    for _ in range(5):
        g = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32), p)
        updates, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        for name, grad in params_from_flax(g).items():
            params[name].grad = grad
        optimizer.step()
        scheduler.step()
    want = params_from_flax(jax.tree.map(np.asarray, p))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# dropout and serving
# ---------------------------------------------------------------------------
def test_dropout_keeps_one_minus_p_scaled():
    x = torch.ones(200_000)
    out = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert dropout(x, 0.1, False) is x and dropout(x, 0.0, True) is x


def _forward(model, ts, noise, seed=0):
    en, tw, de = (t(a) for a in noise)
    return model(ts, enc_noise=en, twin_noise=tw, dec_noise=de,
                 generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def test_dropout_is_seeded_and_off_at_rate_zero(tiny):
    noise = noise_for(tiny["cfg"], B, A)
    sd = tiny["tm"].state_dict()
    zero = torch_build_model(_cfg(drop=0.0), device="cpu")
    zero.load_state_dict(sd)
    torch.testing.assert_close(_forward(zero.train(), tiny["ts"], noise)["loc"],
                               _forward(zero.eval(), tiny["ts"], noise)["loc"], rtol=0, atol=0)
    model = torch_build_model(tiny["cfg"], device="cpu")
    model.load_state_dict(sd)
    model.train()
    a, b = (_forward(model, tiny["ts"], noise, seed=5)["loc"] for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, _forward(model, tiny["ts"], noise, seed=6)["loc"])
    assert not torch.allclose(a, _forward(model.eval(), tiny["ts"], noise)["loc"])


def test_serving_stays_in_eval_mode(tiny):
    from trajsde_tpu.data.synthetic import make_raw_scene

    rng = np.random.default_rng(0)
    scenes = [make_raw_scene(rng, s % 2, num_actors=4, num_lanes=5) for s in range(2)]
    kw = dict(device="cpu", num_actors=A, num_lanes=L, batch_buckets=(2,), seed=3)
    model = copy.deepcopy(tiny["tm"]).train()
    engine = ServingEngine(model, **kw)
    got = engine.predict(scenes)
    want = ServingEngine(copy.deepcopy(tiny["tm"]).eval(), **kw).predict(scenes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["loc"], w["loc"])
    model.train()
    with pytest.raises(RuntimeError, match="train mode"):
        engine.predict(scenes)


def test_fused_decoder_keeps_parameter_names(tiny):
    fused = torch_build_model(_cfg(fused=True), device="cpu")
    assert fused.decoder.fused and not tiny["tm"].decoder.fused
    plain_sd, fused_sd = tiny["tm"].state_dict(), fused.state_dict()
    assert [(k, v.shape) for k, v in plain_sd.items()] == [(k, v.shape) for k, v in fused_sd.items()]
    # the flax tree of the JAX model loads into both, and both round-trip
    fused.load_state_dict(params_from_flax(jax.tree.map(np.asarray, tiny["params"])), strict=True)
    for sd in (plain_sd, fused.state_dict()):
        back = params_from_flax(params_to_flax(sd))
        assert all(torch.equal(back[k], sd[k]) for k in sd)


@torch.no_grad()
def test_fused_decoder_takes_its_seed_from_the_host(tiny):
    """The fused rollout's seed is a host integer: without one the forward
    raises rather than reading a draw back from the device."""
    fused = torch_build_model(_cfg(fused=True), device="cpu")
    fused.load_state_dict(tiny["tm"].state_dict())
    en, tw, _ = (t(a) for a in noise_for(tiny["cfg"], B, A))
    run = lambda **kw: fused(tiny["ts"], enc_noise=en, twin_noise=tw,
                             generator=torch.Generator().manual_seed(0), **kw)["loc"]
    with pytest.raises(ValueError, match="rollout_seed"):
        run()
    a = run(rollout_seed=7)
    torch.testing.assert_close(a, run(rollout_seed=7), rtol=0, atol=0)
    assert torch.isfinite(a).all() and not torch.allclose(a, run(rollout_seed=8))


# ---------------------------------------------------------------------------
# one train step vs jax.value_and_grad
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step_parity():
    cfg = _cfg(drop=0.0)
    js, ts = scene_pair(8, B, A, L)
    jm, params, tm = model_pair(cfg, js)
    Tf = cfg["decoder"]["kwargs"]["future_steps"]
    en, tw, de = noise_for(cfg, B, A, seed=4)

    def jax_loss(p):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        y = y[:, :, -Tf:]   # the targets of the Tf steps reg_mask covers
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    return dict(cfg=cfg, ts=ts, tm=tm, noise=(t(en), t(tw), t(de)), loss=float(loss), grads=want)


def _port_loss(out, Tf):
    y = out["y"][:, :, -Tf:]
    return tlosses.l2_loss(y, out) + tlosses.diff_bce_loss(y, out)


def test_train_step_grads_match_jax_unfused(step_parity):
    sp = step_parity
    model = copy.deepcopy(sp["tm"]).train()
    en, tw, de = sp["noise"]
    out = model(sp["ts"], enc_noise=en, twin_noise=tw, dec_noise=de)
    loss = _port_loss(out, de.shape[0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), sp["loss"], rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()}, sp["grads"])


def test_train_step_grads_match_jax_fused(step_parity):
    """The fused path on the CPU: plain K1 forward, plain K2 backward, fed
    the same decoder noise through ``SDEDecoder.fused_rollout``."""
    sp = step_parity
    cfg = copy.deepcopy(sp["cfg"])
    cfg["decoder"]["kwargs"]["fused"] = True
    model = torch_build_model(cfg, device="cpu").train()
    model.load_state_dict(sp["tm"].state_dict())
    en, tw, de = sp["noise"]
    ts, dec, Tf = sp["ts"], model.decoder, de.shape[0]
    local, d_in, d_out, l_in, l_out = model.encoder(ts, sde_noise=en, twin_noise=tw)
    glob = model.aggregator(ts, local)
    y0 = dec.fuse(ts, local, glob)
    ys = dec.fused_rollout(y0, 0, noise=de.reshape(Tf, -1, y0.shape[-1]))
    out = dec.decode(ts, ys.permute(1, 2, 3, 0, 4), local, glob)
    out.update(y=model.rotated_y(ts), diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
    loss = _port_loss(out, Tf)
    loss.backward()
    np.testing.assert_allclose(loss.item(), sp["loss"], rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()}, sp["grads"])


# ---------------------------------------------------------------------------
# eval step, NaN guard, Trainer
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


@pytest.mark.parametrize("fused", [False, True])
def test_eval_step_matches_jax(fused):
    """With every diffusion output bias at -1e4 both packages are
    deterministic; ADE_T / FDE_T / MR_T (and per source) over two batches."""
    cfg = _cfg(Tf=60, fused=fused)
    for args in cfg["metric_args"]:
        args["per_source"] = True
    pairs = [scene_pair(s, B, A, L) for s in (11, 12)]
    jm, params, _ = model_pair(_cfg(Tf=60), pairs[0][0])
    params = _silence_diffusion(params)
    jms = jmetrics.make_metrics(cfg["metrics_module"], cfg["metric_args"])
    jeval = jax_make_eval_step(jm, jms, True)
    for i, (js, _) in enumerate(pairs):
        contribs = jeval(params["params"], js, jax.random.key(12345), np.int32(i))
        for m in jms:
            m.accumulate(contribs[m.name])
    want = {m.name: m.compute() for m in jms}
    model = torch_build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu")
    got = trainer.evaluate(TrainState(model, None, None), lambda: [ts for _, ts in pairs])
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_nan_guard_skips_the_update():
    cfg = _cfg(Tf=60, fused=True)
    model = torch_build_model(cfg, device="cpu")
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=2)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), "cpu")
    _, scene = scene_pair(13, B, A, L)
    assert step(scene, 0, 0)["train/step_skipped"] == 0.0
    params = {k: v.clone() for k, v in model.state_dict().items()}
    moments = copy.deepcopy(state.optimizer.state_dict())
    lr = state.scheduler.get_last_lr()
    scene.y[0] = float("nan")
    logs = step(scene, 1, 0)
    assert logs["train/step_skipped"] == 1.0 and not math.isfinite(float(logs["train/total"]))
    assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())
    after = state.optimizer.state_dict()
    for i, s in moments["state"].items():
        assert all(torch.equal(v, after["state"][i][k]) for k, v in s.items())
    assert state.scheduler.get_last_lr() == lr


def test_loss_falls_on_a_repeated_batch():
    cfg = _cfg(Tf=60, fused=True, lr=0.01)
    model = torch_build_model(cfg, device="cpu", seed=1)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), "cpu")
    _, scene = scene_pair(14, B, A, L)
    totals = [float(step(scene, k, 0)["train/total"]) for k in range(8)]
    assert np.mean(totals[-3:]) < totals[0], totals


class _Log:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, values):
        self.rows.append((step, dict(values)))


def test_trainer_fit_checkpoints_and_resume(tmp_path):
    cfg = _cfg(Tf=60, fused=True)
    batches = [scene_pair(s, B, A, L)[1] for s in (20, 21)]
    state = create_train_state(torch_build_model(cfg, device="cpu"), cfg["training_specific"],
                               steps_per_epoch=2, seed=1)
    log = _Log()
    ckpt = CheckpointManager(str(tmp_path), save_top_k=1)
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu", logger=log,
                      checkpointer=ckpt)
    trainer.fit(state, lambda: batches, lambda: batches, max_epochs=2)
    assert state.step == 4 and len(trainer.epoch_logs) == 2
    assert log.rows[0][1]["nfe/decoder_sde_steps"] == 60.0
    assert any("train/L2" in row for _, row in log.rows)
    assert trainer.epoch_logs[-1]["perf/steps_per_s"] > 0

    with open(tmp_path / "leaderboard.json") as f:
        board = json.load(f)
    assert 1 <= len(board) <= 2 and all(math.isfinite(e["metric"]) for e in board)
    on_disk = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert on_disk == sorted(os.path.basename(e["path"]) for e in board)
    assert ckpt.latest()["step"] == 4

    # full resume restores the step, weights, AdamW moments and schedule exactly
    resumed = create_train_state(torch_build_model(cfg, device="cpu", seed=9),
                                 cfg["training_specific"], steps_per_epoch=2)
    CheckpointManager(str(tmp_path)).restore(resumed)
    assert (resumed.step, resumed.seed) == (4, 1)
    a, b = state.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = state.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert resumed.scheduler.state_dict() == state.scheduler.state_dict()

    # draws derive from (seed, step): the resumed run continues identically
    fresh = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu")
    fresh.fit(state, lambda: batches[:1], lambda: [], 1)
    fresh.fit(resumed, lambda: batches[:1], lambda: [], 1)
    a, b = state.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

    # weights-only warm start
    warm = torch_build_model(cfg, device="cpu", seed=9)
    CheckpointManager(str(tmp_path)).restore_params(warm, ckpt.latest()["path"])
    saved = torch.load(os.path.join(ckpt.latest()["path"], "state.pt"), weights_only=True)["model"]
    assert all(torch.equal(warm.state_dict()[k], saved[k]) for k in saved)

    with pytest.raises(ValueError, match="monitor"):
        Trainer(build_losses(cfg), build_metrics(cfg), device="cpu", checkpointer=ckpt,
                monitor="ADE").fit(state, lambda: batches, lambda: batches, 1)
