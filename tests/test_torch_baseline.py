"""The HiVT baseline family in the port vs the JAX package on the CPU: the
transformer temporal encoder and the one-shot MLP decoder
(``configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml``).

At a small size (embed 32, 2 heads, 2 temporal layers, 3 modes, 2 scenes
of 5 actors and 6 lanes) the JAX baseline's weights go through the bridge
into the port, and the same numpy inputs through both:

* ``MultiheadSelfAttention``, ``TemporalEncoder`` (with padded steps),
  ``LocalEncoder`` dense and fused (the plain K3 on the CPU; JAX's dense
  encoder is the reference for both, the same function of the same
  weights), ``MLPDecoder`` and the whole ``PredictionModel`` forward:
  each within 1e-4;
* one train step at dropout 0, dense and fused (plain K3 / K4): the L2
  loss within rtol 2e-4 and every gradient leaf within 2e-3 x its scale
  + 1e-6, as ``tests/test_torch_train.py`` holds the SDE step;
* the attention weights' dropout: its keep rate, its scale and its seeding;
* the bridge both ways and a ``CheckpointManager`` checkpoint, bit for bit;
* ``BASELINE`` is the YAML, and ``build_model`` builds it at the published
  widths; ``LocalEncoder``'s refusals;
* ``train_torch.py`` trains the baseline from npz scenes, and
  ``test_torch.py``'s ADE_T / FDE_T / MR_T match JAX's eval step on the
  same weights and batches; ``--ood`` and ``--serving`` are refused.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
from trajsde_tpu.data import loader as jloader
from trajsde_tpu.data.scene import strip_for_device as jax_strip
from trajsde_tpu.models.layers import MultiheadSelfAttention as JMHA
from trajsde_tpu.models.local_encoder import TemporalEncoder as JTemporalEncoder
from trajsde_tpu.train import metrics as jmetrics
from trajsde_tpu.train.loop import make_eval_step as jax_make_eval_step
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.models.layers import MultiheadSelfAttention
from trajsde_tpu_torch.models.local_encoder import LocalEncoder, TemporalEncoder
from trajsde_tpu_torch.models.prediction import PredictionModel
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state

import test_torch
import train_torch
from _torch_helpers import check_leaves, scene_pair, small_baseline_cfg, t, torch_build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml")
torch.set_num_threads(1)
B, A, L, TF = 2, 5, 6, 12
TOL = 1e-4


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def pair():
    """The JAX baseline (dense) and its params; the port's dense and fused
    baselines with the same weights; the scene in both packages."""
    js, ts = scene_pair(3, B, A, L)
    cfg = small_baseline_cfg(Tf=TF)
    jm = jax_build_model(ExperimentConfig(cfg))
    params = jax.jit(jm.init)({"params": jax.random.key(0)}, js)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    models = {}
    for fused in (False, True):
        m = torch_build_model(small_baseline_cfg(Tf=TF, fused=fused), device="cpu")
        m.load_state_dict(sd)
        models[fused] = m
    return dict(jm=jm, params=params, js=js, ts=ts, models=models, sd=sd)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_baseline_is_the_yaml_and_builds_at_the_published_widths():
    raw = tconfig.load_config(YAML)
    assert raw == tconfig.BASELINE
    train = copy.deepcopy(tconfig.BASELINE_TRAIN)
    assert train["encoder"]["kwargs"].pop("fused") is True and train == raw
    model = tconfig.build_model(raw, device="cpu")
    assert isinstance(model, PredictionModel) and type(model).__name__ == "PredictionModel"
    assert not model.training
    enc, dec = model.encoder, model.decoder
    assert isinstance(enc, LocalEncoder) and not enc.aa_encoder.fused
    assert enc.temporal_encoder.num_layers == 4
    assert enc.temporal_encoder.layer0.self_attn.in_proj.weight.shape == (192, 64)
    assert enc.temporal_encoder.layer0.self_attn.num_heads == 4
    assert enc.temporal_encoder.pos_embed.shape == (22, 64)
    assert model.aggregator.num_modes == 10 and dec.num_modes == 10
    assert dec.future_steps == 60 and dec.loc_dense1.weight.shape == (120, 64)
    assert [n for n, _, _ in tconfig.build_losses(raw)] == ["L2"]
    assert [m.name for m in tconfig.build_metrics(raw)] == ["ADE_T", "FDE_T", "MR_T"]
    fused = tconfig.build_model(tconfig.BASELINE_TRAIN, device="cpu")
    assert fused.encoder.aa_encoder.fused
    assert [k for k in fused.state_dict()] == [k for k in model.state_dict()]


def test_local_encoder_fused_in_bf16_builds_and_takes_ln_mm():
    """The baseline's encoder with ``fused=True`` in bf16 (once refused)
    builds; ``ln_mm`` reaches its ``AAEncoder``, directly and through the
    registry, which once dropped it."""
    enc = LocalEncoder(21, 32, 2, dtype="bfloat16", fused=True)
    assert enc.aa_encoder.chain_dtype == "bfloat16" and enc.aa_encoder.ln_mm is True
    assert LocalEncoder(21, 32, 2, dtype="bfloat16", fused=True,
                        ln_mm=False).aa_encoder.ln_mm is False
    built = tconfig.build("LocalEncoder", dict(historical_steps=21, embed_dim=32, num_heads=2,
                                               dtype="bfloat16", fused=True, ln_mm=False))
    assert built.aa_encoder.fused and built.aa_encoder.ln_mm is False


def test_local_encoder_builds_with_remat_and_rematerializes():
    """``remat=True`` (once refused) wraps the AA and AL calls, not the
    modules: the parameter names stay, and a training backward runs each
    block's forward again (``tests/test_torch_remat.py`` holds it to the
    plain step)."""
    enc = tconfig.build("LocalEncoder", dict(historical_steps=21, embed_dim=32, num_heads=2,
                                             remat=True))
    assert enc.remat and list(enc.state_dict()) == list(LocalEncoder(21, 32, 2).state_dict())
    _, scene = scene_pair(3, B, A, L)
    calls = []
    for block in (enc.aa_encoder, enc.al_encoder):
        block.register_forward_pre_hook(lambda *_: calls.append(1))
    enc.train()(scene, generator=torch.Generator().manual_seed(0)).square().sum().backward()
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# modules vs JAX
# ---------------------------------------------------------------------------
def test_multihead_self_attention_matches_jax():
    """A batched additive mask ([B, A, S, S], ``finfo.min`` off the causal
    band and on random pairs) goes in at the head axis in both."""
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 3, 7, 32)).astype(np.float32)
    allowed = (np.tril(np.ones((7, 7), bool))[None, None] & (r.random((2, 3, 7, 7)) > 0.3)) \
        | np.eye(7, dtype=bool)
    mask = np.where(allowed, 0.0, np.finfo(np.float32).min).astype(np.float32)
    jmod = JMHA(32, 2, 0.1)
    params = jmod.init(jax.random.key(1), x, mask)
    want = jmod.apply(params, x, mask)
    mod = MultiheadSelfAttention(32, 2, 0.1).eval()
    mod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    _close(mod(t(x), t(mask)), want)


def test_temporal_encoder_matches_jax_with_padded_steps():
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 4, 21, 32)).astype(np.float32)
    pad = r.random((2, 4, 21)) < 0.3
    pad[0, 1] = True        # an actor with every step padded
    pad[1, 2, :10] = True   # one that enters late
    jmod = JTemporalEncoder(21, 32, 2, 2, 0.1)
    params = jmod.init(jax.random.key(2), x, pad)
    params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.key(3), a.shape),
                          params)   # tokens and LayerNorms away from their inits
    want = jmod.apply(params, x, pad)
    mod = TemporalEncoder(21, 32, 2, 2, 0.1).eval()
    mod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    got = mod(t(x), t(pad))
    assert got.shape == (2, 4, 32)
    _close(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_local_encoder_matches_jax(pair, fused):
    want = pair["jm"].apply(pair["params"], pair["js"], method=lambda m, s: m.encoder(s, True))
    with torch.no_grad():
        got = pair["models"][fused].encoder(pair["ts"])
    _close(got, want)


def test_mlp_decoder_matches_jax(pair):
    r = np.random.default_rng(4)
    local = r.standard_normal((B, A, 32)).astype(np.float32)
    glob = r.standard_normal((B, 3, A, 32)).astype(np.float32)
    want = pair["jm"].apply(pair["params"], pair["js"], local, glob,
                            method=lambda m, s, lo, gl: m.decoder(s, lo, gl, True))
    with torch.no_grad():
        got = pair["models"][False].decoder(pair["ts"], t(local), t(glob))
    assert got["loc"].shape == (B, 3, A, TF, 4) and got["pi"].shape == (B, A, 3)
    for k in ("loc", "pi"):
        _close(got[k], want[k], msg=k)
    np.testing.assert_array_equal(got["reg_mask"].numpy(), np.asarray(want["reg_mask"]))
    assert (got["loc"][..., 2:] >= 1e-3).all()


@pytest.mark.parametrize("fused", [False, True])
def test_prediction_model_forward_matches_jax(pair, fused):
    want = pair["jm"].apply(pair["params"], pair["js"])
    with torch.no_grad():
        got = pair["models"][fused](pair["ts"])
    assert set(got) == set(want) == {"loc", "pi", "reg_mask", "y"}
    for k in ("loc", "pi", "y"):
        _close(got[k], want[k], msg=k)


# ---------------------------------------------------------------------------
# one train step vs jax.value_and_grad
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step_parity(pair):
    cfg = small_baseline_cfg(Tf=TF, drop=0.0)
    jm = jax_build_model(ExperimentConfig(cfg))

    def jax_loss(p):
        out = jm.apply(p, pair["js"])
        return jlosses.l2_loss(out["y"][:, :, -TF:], out)

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(pair["params"])
    return dict(loss=float(loss), grads=params_from_flax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_grads_match_jax(pair, step_parity, fused):
    """Dropout 0 in training mode; fused: the AA pair chain through the
    plain K3 forward and the plain K4 backward."""
    model = torch_build_model(small_baseline_cfg(Tf=TF, drop=0.0, fused=fused), device="cpu")
    model.load_state_dict(pair["sd"])
    model.train()
    out = model(pair["ts"], generator=torch.Generator().manual_seed(0), rollout_seed=3)
    loss = tlosses.l2_loss(out["y"][:, :, -TF:], out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), step_parity["loss"], rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()}, step_parity["grads"])


def test_attention_weight_dropout_keeps_one_minus_p_scaled_and_is_seeded():
    """Equal logits and values of one: each output is the kept share of
    its S weights times S / (S (1 - p)), so the outputs count the kept
    weights.  0.9 of them kept, each scaled by 1 / 0.9; the same generator
    seed draws the same masks, another seed others; eval mode keeps all."""
    S, D, p = 8, 8, 0.1
    mod = MultiheadSelfAttention(D, 2, p)
    with torch.no_grad():
        mod.in_proj.weight.zero_()
        mod.in_proj.bias.copy_(torch.cat([torch.zeros(2 * D), torch.ones(D)]))
        mod.out_proj.weight.copy_(torch.eye(D))
        mod.out_proj.bias.zero_()
    x, mask = torch.zeros(4000, S, D), torch.zeros(S, S)
    run = lambda seed: mod.train()(x, mask, torch.Generator().manual_seed(seed))  # noqa: E731
    with torch.no_grad():
        a = run(0)
        kept = a * S * (1 - p)
        torch.testing.assert_close(kept, kept.round(), rtol=0, atol=1e-4)
        assert abs(kept.mean().item() / S - (1 - p)) < 0.005
        torch.testing.assert_close(a, run(0), rtol=0, atol=0)
        assert not torch.equal(a, run(1))
        torch.testing.assert_close(mod.eval()(x, mask), torch.ones_like(a), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the bridge and checkpoints
# ---------------------------------------------------------------------------
def test_bridge_round_trip_is_bit_equal(pair, tmp_path):
    flax_tree = jax.tree.map(np.asarray, pair["params"])["params"]
    back = params_to_flax(pair["sd"])
    assert jax.tree.structure(back) == jax.tree.structure(flax_tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(flax_tree)))
    te = back["encoder"]["temporal_encoder"]
    assert set(te["layer0"]) == {"norm1", "norm2", "self_attn", "mlp"}
    assert set(te["layer0"]["self_attn"]) == {"in_proj", "out_proj"}
    assert {"padding_token", "cls_token", "pos_embed", "norm"} <= set(te)
    assert {"pi_dense0", "pi_ln0", "pi_dense2", "loc_dense1", "scale_dense1", "aggr_dense",
            "aggr_ln"} <= set(back["decoder"])
    # a CheckpointManager checkpoint of the fused model restores into the dense one
    model = pair["models"][True]
    state = create_train_state(model, tconfig.BASELINE["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints")).save(state, metric=None, step=2)
    dense = torch_build_model(small_baseline_cfg(Tf=TF), device="cpu", seed=9)
    CheckpointManager(str(tmp_path / "checkpoints")).restore_params(dense, ckpt)
    got = params_to_flax(dense.state_dict())
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(flax_tree)))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
CA, CL, BATCH = 6, 8, 4


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL only: importing tensorboard here pulls in TensorFlow."""
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """npz scenes (train: both sources; val / test: nuScenes), the small
    baseline as a JSON config over them, and seeded weights as a
    ``CheckpointManager`` checkpoint."""
    root = tmp_path_factory.mktemp("baseline_cli")
    rng = np.random.default_rng(0)
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        for split, n in (("train", 4), ("val", 8 if src == 0 else 0)):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(n):
                raw = make_raw_scene(rng, src, num_actors=int(rng.integers(3, CA + 1)),
                                     num_lanes=int(rng.integers(4, CL + 1)))
                np.savez(d / f"scene_{1000 + 7 * i:06d}.npz", **raw)
    cfg = small_baseline_cfg(Tf=60, fused=True)
    cfg["datamodule_specific"]["kwargs"].update(
        train_batch_size=BATCH, val_batch_size=BATCH, num_actors=CA, num_lanes=CL,
        nu_dir=str(root / "nuScenes"), Argo_dir=str(root / "Argoverse"))
    path = root / "baseline.json"
    path.write_text(json.dumps(cfg))
    model = torch_build_model(cfg, device="cpu", seed=5)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(root / "run" / "checkpoints")).save(state, metric=None, step=4)
    return dict(root=root, cfg=cfg, path=str(path), ckpt=ckpt, sd=model.state_dict())


def test_train_torch_trains_the_baseline(cli, tmp_path):
    """One epoch of 2 steps through the fused encoder (plain K3 / K4): a
    scored checkpoint, finite losses, no nfe counts (no SDE)."""
    state, _ = train_torch.main(["-c", cli["path"], "-n", "run", "--device", "cpu", "--epochs",
                                 "1", "--logdir", str(tmp_path)])
    assert state.step == 2
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert not any(k.startswith("nfe/") for r in rows for k in r)
    losses = [r["train/L2"] for r in rows if "train/L2" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any(np.isfinite(r.get("val/ADE_T", np.nan)) for r in rows)
    assert CheckpointManager(str(tmp_path / "run" / "checkpoints")).latest()["step"] == 2


def test_test_torch_metrics_of_the_baseline_match_jax(cli, capsys):
    """JAX's eval step of the dense baseline over the JAX loader's test
    batches, with the checkpoint's weights; the port evaluates through the
    fused encoder (plain K3)."""
    jcfg = copy.deepcopy(cli["cfg"])
    jcfg["encoder"]["kwargs"]["fused"] = False
    batches = [jax_strip(b) for b in jloader.DataModuleNuArgoMix(
        **jcfg["datamodule_specific"]["kwargs"]).test_loader()]
    assert len(batches) == 2
    jm = jax_build_model(ExperimentConfig(jcfg))
    jms = jmetrics.make_metrics(jcfg["metrics_module"], jcfg["metric_args"])
    jeval = jax_make_eval_step(jm, jms, True)
    params = jax.tree.map(jnp.asarray, params_to_flax(cli["sd"]))
    for i, b in enumerate(batches):
        contribs = jeval(params, b, jax.random.key(12345), np.int32(i))
        for m in jms:
            m.accumulate(contribs[m.name])
    want = {m.name: m.compute() for m in jms}
    got = test_torch.main(["-c", cli["path"], "--ckpt", cli["ckpt"], "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) == {"ADE_T", "FDE_T", "MR_T"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("flag,match", [("--ood", "forward_ood"), ("--serving", "SDE decoder")])
def test_test_torch_refuses_what_the_baseline_has_not(cli, flag, match):
    with pytest.raises(SystemExit, match=match):
        test_torch.main(["-c", cli["path"], "--ckpt", cli["ckpt"], "--device", "cpu", flag])
