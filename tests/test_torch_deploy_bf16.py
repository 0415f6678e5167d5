"""A fused AA encoder in bf16 exported and served from its artifact, on the
CPU: kernel K3b as the registered op ``trajsde::aa_fused_fwd_bf16``
(``trajsde_tpu_torch/ops/aa_fused.py``) and ``trajsde_tpu_torch/deploy.py``.

* the op on a CPU tensor is the plain bf16 chain bit for bit, at both
  ``ln_mm``, with and without a keep mask and the statistics; its fake
  gives f32 outputs of the right shapes; ``torch.library.opcheck`` passes;
  the f32 op ``trajsde::aa_fused_fwd`` keeps its schema;
* the live bf16 forwards (no grad, and ``FusedPairAttentionFn``) go
  through the op, with the plain version's bits;
* the SDE family (``FLAGSHIP_BF16_FUSED``'s small form: ``dtype:
  bfloat16`` everywhere, ``encoder.fused: true``, the decoder's loop
  rollout) exported by ``serve_torch.py --export`` from a checkpoint: the
  manifest names the op, the draws are bf16 where the model draws in bf16,
  and the artifact answers bit for bit as the live scan engine at the
  same seed; its program fed pinned draws meets JAX's bf16 forward and
  ``make_postprocess`` (the fused AA block through the interpret-mode
  Pallas op, compiled by ``_torch_helpers.jit_exact``) within
  ``MODEL_BAR`` = max 2e-2 of max|JAX| and mean 2e-3 of mean|JAX|
  (``tests/test_torch_bf16_fused_model.py``'s bars), which the port in f32
  on the same weights and draws fails;
* the HiVT baseline with a fused bf16 encoder (no draws in eval mode):
  ``serve_torch.py --export``, then ``--from-export`` in batch mode writes
  the live scan engine's predictions bit for bit.

Each artifact is exported at bucket 1 (``--max-batch 1``) and loaded once.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from trajsde_tpu.data.grid import align_to_grid as jax_align
from trajsde_tpu.data.pack import pack_scenes as jax_pack
from trajsde_tpu.server import make_postprocess as jax_postprocess
from trajsde_tpu_torch.config import build_model
from trajsde_tpu_torch.data.pack import pack_scenes
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.deploy import load_serving
from trajsde_tpu_torch.ops import aa_fused as K3
from trajsde_tpu_torch.server import ServingEngine, align_scene, make_postprocess
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state

import serve_torch
from _torch_helpers import (bf16_cfg, bf16_distance, jit_exact, model_pair, noise_for,
                            scene_pair, small_baseline_cfg, small_cfg, t)

torch.set_num_threads(1)
A, L, N = 6, 8, 3
MODEL_BAR = (2e-2, 2e-3)
OP = "trajsde::aa_fused_fwd_bf16"


# --------------------------------------------------------------------------
# the op
# --------------------------------------------------------------------------
def _op_inputs(with_keep, D=16, H=4, B=2, T=3, Aq=5, Ak=6):
    r = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))  # noqa: E731
    q, u = f(B, T, Aq, D), 3 * f(B, T, Aq, Ak, 4)
    mask = torch.from_numpy((r.uniform(size=(B, T, Aq, Ak)) < 0.6).astype(np.float32))
    mask[1, 2, 4] = 0.0
    keep = torch.from_numpy((r.uniform(size=(B, T, Aq, Ak, H)) >= 0.1).astype(np.float32))
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wkv=(D, 2 * D), bkv=(1, 2 * D))
    ws = [f(*shapes[k]) * (shapes[k][0] ** -0.5 if k[0] == "w" else 0.2)
          + float(k.endswith("s")) for k in K3.W_ORDER]
    return q, u, mask, keep if with_keep else None, ws, H


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("ln_mm", [True, False])
def test_bf16_op_on_the_cpu_is_the_plain_bf16_chain(ln_mm, with_keep, with_stats):
    q, u, mask, keep, ws, H = _op_inputs(with_keep)
    before = K3.fused_pair_attention.bf16_launches
    out, stats = torch.ops.trajsde.aa_fused_fwd_bf16(q, u, mask, keep, ws, H, 0.1, with_stats,
                                                     ln_mm)
    want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, 0.1, with_stats,
                                             "bfloat16", ln_mm)
    if with_stats:
        assert torch.equal(out, want[0]) and torch.equal(stats, want[1])
    else:
        assert torch.equal(out, want) and stats.shape == (0,)
    assert out.dtype == stats.dtype == torch.float32
    assert K3.fused_pair_attention.bf16_launches == before
    other = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, 0.1, False, "bfloat16",
                                              not ln_mm)
    assert not torch.equal(out, other)                       # ln_mm reaches the chain


@pytest.mark.parametrize("with_stats", [False, True])
def test_bf16_op_fake_gives_f32_outputs_of_the_right_shapes(with_stats):
    q, u, mask, keep, ws, H = _op_inputs(True)
    with FakeTensorMode() as mode:
        fq, fu, fm, fk = (mode.from_tensor(x) for x in (q, u, mask, keep))
        fws = [mode.from_tensor(w) for w in ws]
        out, stats = torch.ops.trajsde.aa_fused_fwd_bf16(fq, fu, fm, fk, fws, H, 0.1, with_stats,
                                                         True)
    R = q.shape[0] * q.shape[1] * q.shape[2]
    assert out.shape == q.shape and out.dtype == torch.float32
    assert stats.shape == ((2, R, H) if with_stats else (0,)) and stats.dtype == torch.float32


@pytest.mark.parametrize("with_keep", [False, True])
def test_bf16_op_passes_opcheck(with_keep):
    q, u, mask, keep, ws, H = _op_inputs(with_keep)
    torch.library.opcheck(torch.ops.trajsde.aa_fused_fwd_bf16.default,
                          (q, u, mask, keep, ws, H, 0.1, True, True))


def test_the_f32_op_keeps_its_schema_and_the_bf16_op_adds_ln_mm():
    f32 = str(torch.ops.trajsde.aa_fused_fwd.default._schema)
    bf16 = str(torch.ops.trajsde.aa_fused_fwd_bf16.default._schema)
    args = ("Tensor q, Tensor u, Tensor mask_f, Tensor? keep, Tensor[] ws, SymInt num_heads, "
            "float dropout_rate, bool with_stats")
    assert f32 == f"trajsde::aa_fused_fwd({args}) -> (Tensor, Tensor)"
    assert bf16 == f"trajsde::aa_fused_fwd_bf16({args}, bool ln_mm) -> (Tensor, Tensor)"


class _Calls(TorchDispatchMode):
    """The names of the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grad", [False, True])
def test_live_bf16_forward_goes_through_the_op_with_the_plain_bits(grad):
    """``fused_pair_attention`` in bf16, without a gradient and as
    ``FusedPairAttentionFn`` (which asks the op for the statistics)."""
    q, u, mask, keep, ws, H = _op_inputs(True)
    if grad:
        q = q.requires_grad_()
    with _Calls() as calls:
        out = K3.fused_pair_attention(q, u, mask, keep, ws, H, 0.1, "bfloat16")
    assert "trajsde.aa_fused_fwd_bf16" in calls.names
    assert (out.grad_fn is not None) == grad
    want = K3.fused_pair_attention_reference(q.detach(), u, mask, keep, ws, H, 0.1,
                                             compute_dtype="bfloat16")
    assert torch.equal(out.detach(), want)


# --------------------------------------------------------------------------
# the artifacts
# --------------------------------------------------------------------------
def _raws(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_raw_scene(rng, s % 2, num_actors=5, num_lanes=6) for s in range(n)]


def _fused_bf16(cfg):
    cfg = bf16_cfg(cfg)
    cfg["encoder"]["kwargs"]["fused"] = True
    cfg["datamodule_specific"]["kwargs"].update(num_actors=A, num_lanes=L)
    return cfg


def _setup(root, cfg, model):
    """A JSON config, a checkpoint of ``model``'s weights, N npz scenes and
    the artifact that ``serve_torch.py --export`` writes from them."""
    path = root / "cfg.json"
    path.write_text(json.dumps(cfg))
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(root / "run" / "checkpoints")).save(state, metric=None, step=1)
    scenes = root / "scenes"
    scenes.mkdir()
    for i, raw in enumerate(_raws(N, seed=4)):
        np.savez(scenes / f"s{i}.npz", **raw)
    common = ["-c", str(path), "--ckpt", ckpt, "--device", "cpu"]
    art = str(root / "artifact")
    done = serve_torch.main(common + ["--export", art, "--max-batch", "1"])
    assert done == {"exported": art, "buckets": [1], "platforms": ["cpu"]}
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    return dict(cfg=cfg, model=model, art=art, manifest=manifest, common=common,
                scenes=str(scenes))


@pytest.fixture(scope="module")
def sde(tmp_path_factory):
    """The SDE family with JAX's init bridged in, its artifact loaded once."""
    cfg = _fused_bf16(small_cfg())
    js, _ = scene_pair(1, 1, A, L)
    jm, params, tm = model_pair(cfg, js)
    out = _setup(tmp_path_factory.mktemp("sde_bf16"), cfg, tm)
    return dict(out, jm=jm, params=params, exp=load_serving(out["art"], device="cpu"))


def test_sde_artifact_is_the_live_scan_engine_bit_for_bit(sde):
    m = sde["manifest"]
    assert m["ops"] == [OP]
    assert [(d["name"], d["dtype"]) for d in m["draws"]] == [
        ("twin_noise", "float32"), ("enc_noise", "bfloat16"), ("dec_noise", "bfloat16")]
    calls = {n.target for n in sde["exp"].programs[1].graph.nodes if n.op == "call_function"}
    assert torch.ops.trajsde.aa_fused_fwd_bf16.default in calls
    assert torch.ops.trajsde.aa_fused_fwd.default not in calls
    exp = sde["exp"]
    live = ServingEngine(sde["model"], device="cpu", num_actors=A, num_lanes=L, engine="scan",
                         batch_buckets=(1,), seed=5)
    exported = ServingEngine(exp, device="cpu", num_actors=A, num_lanes=L, engine="exported",
                             batch_buckets=exp.buckets, seed=5)
    try:
        want = live.predict(_raws(N, seed=4))
        got = exported.predict(_raws(N, seed=4))
    finally:
        live.close()
        exported.close()
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sde_artifact_meets_jax_bf16_with_pinned_draws(sde):
    """The bucket-1 program fed ``noise_for``'s draws (rounded to bf16 where
    the model draws bf16, as JAX casts them) against JAX's bf16 forward and
    postprocess on JAX's packing of the same scene; the port in f32 on the
    same weights and draws fails the mean bar."""
    raw = _raws(1, seed=6)[0]
    js = jax_pack([jax_align(dict(raw, source=raw["source"]))], A, L)
    ts = pack_scenes([align_scene(raw)[0]], A, L)
    enc, twin, dec = noise_for(sde["cfg"], 1, A)
    jm, params = sde["jm"], sde["params"]

    def fwd(p, scene, en, tw, de):
        def f(m, s):
            local, _, _, _, _ = m.encoder(s, True, en, tw)
            glob = m.aggregator(s, local, True)
            return m.decoder(s, local, glob, True, de)

        out = jm.apply(p, scene, method=f)
        return jax_postprocess(True, 20)(scene, {k: v for k, v in out.items() if v is not None})

    want = jit_exact(fwd, params, js, enc, twin, dec)(params, js, enc, twin, dec)
    want = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in want.items()}
    draws = {"twin_noise": t(twin), "enc_noise": t(enc).bfloat16(),
             "dec_noise": t(dec).bfloat16()}
    got = sde["exp"](ts, 0, draws=draws)
    plain = build_model(small_cfg(), device="cpu")
    plain.load_state_dict(sde["model"].state_dict())
    plain.eval()
    with torch.no_grad():
        out32 = plain(ts, enc_noise=t(enc), twin_noise=t(twin), dec_noise=t(dec))
        got32 = make_postprocess(True, 20)(ts, out32)
    for k in ("agent_world", "loc", "pi_all"):
        assert got[k].dtype == torch.float32, k
        dist = bf16_distance(got[k], want[k])
        wrong = bf16_distance(got32[k], want[k])
        print(f"{k}: max / mean |artifact - JAX| {dist[0]:.2e} / {dist[1]:.2e}; the f32 port "
              f"{wrong[0]:.2e} / {wrong[1]:.2e} (bar {MODEL_BAR})")
        assert dist[0] <= MODEL_BAR[0] and dist[1] <= MODEL_BAR[1], (k, dist)
        if k != "agent_world":  # the world frame's offsets swamp the rest there
            assert wrong[1] > MODEL_BAR[1], (k, wrong)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    cfg = _fused_bf16(small_baseline_cfg())
    return _setup(tmp_path_factory.mktemp("baseline_bf16"), cfg,
                  build_model(cfg, device="cpu", seed=3))


def test_baseline_from_export_cli_writes_the_live_engines_predictions(baseline, tmp_path):
    """``--from-export`` in batch mode (no config, no checkpoint) writes the
    npz files of ``--engine scan`` over the checkpoint bit for bit."""
    m = baseline["manifest"]
    assert m["ops"] == [OP] and m["draws"] == []
    live, exported = tmp_path / "live", tmp_path / "exported"
    serve_torch.main(baseline["common"] + ["--engine", "scan", "--input-dir", baseline["scenes"],
                                           "--output-dir", str(live), "--max-batch", "1"])
    stats = serve_torch.main(["--from-export", baseline["art"], "--device", "cpu",
                              "--input-dir", baseline["scenes"], "--output-dir", str(exported),
                              "--max-batch", "1"])
    assert stats["served"] == N
    names = sorted(os.listdir(live))
    assert names == sorted(os.listdir(exported)) and len(names) == N
    for name in names:
        with np.load(live / name) as w, np.load(exported / name) as g:
            assert set(g.files) == set(w.files)
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
