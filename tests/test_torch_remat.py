"""``remat: true`` on both encoders of the port (JAX's ``nn.remat`` of the AA
and AL blocks) on the CPU.

Small sizes: embed 16 (the SDE encoder) or 32 (the baseline), 2 heads, 2
scenes of 5 actors and 6 lanes, dropout 0.1.  Each case is a family
(``LocalEncoderSDESep`` under the flagship, ``LocalEncoder`` under the HiVT
baseline) and an AA path: dense, ``neighbor_cap`` 2 with ties planted at the
cap (actors 2 and 3 copy actor 1), ``fused`` (the plain K3 / K4 on the CPU),
bf16 dense and, on the SDE encoder, ``adaptive`` with its tree nodes drawn
from the generator or pinned (``sde_nodes``).

* remat against plain in the port, dropout live: the outputs, the loss and
  every gradient of a train step equal bit for bit, the generator left where
  the plain step leaves it, two steps in a row (the second step's draws did
  not rewind), with an explicit ``torch.Generator`` and with the global RNG;
* the recompute is real: forward pre-hooks on ``aa_encoder`` and ``al_encoder``
  fire twice in a remat train step and once under ``no_grad`` and in eval,
  and the bytes saved for backward (an outer ``saved_tensors_hooks``) fall
  by at least one pair tensor;
* against JAX built with ``remat=True`` (dropout off, pinned noise): the
  forward within 1e-4 and one train step's loss within rtol 2e-4 and every
  gradient leaf within 2e-3 x its scale + 1e-6 (``test_torch_train.py``'s
  and ``test_torch_baseline.py``'s bars), the JAX remat tree bridged into
  the port's remat model with the plain model's ``state_dict`` keys;
* through the entry points: a YAML copy of the small flagship with
  ``encoder.kwargs.remat: true`` trains through ``train_torch.main``, resumes
  from ``--ckpt``, and ``test_torch.main`` gives the plain config's metrics on
  its checkpoint; the serving engine answers as the plain config's, bit for
  bit.
"""
import json

import jax
import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

from trajsde_tpu import losses as jlosses
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.server import ServingEngine
from trajsde_tpu_torch.train import logging as tlogging
from trajsde_tpu_torch.train.checkpoint import CheckpointManager

import test_torch
import train_torch
from _torch_helpers import (ExperimentConfig, bf16_cfg, check_leaves, jax_build_model,
                            noise_for, scene_pair, small_baseline_cfg, small_cfg, t,
                            torch_build_model, write_run)

torch.set_num_threads(1)
B, A, L, TF = 2, 5, 6, 12
CAP = 2
TOL = dict(rtol=0, atol=1e-4)
PATHS = {"sde": ("dense", "capped", "fused", "bf16", "adaptive", "adaptive_pinned"),
         "baseline": ("dense", "capped", "fused", "bf16")}
CASES = [(fam, path) for fam, paths in PATHS.items() for path in paths]
IDS = [f"{fam}-{path}" for fam, path in CASES]


def _cfg(family, path="dense", remat=True, drop=0.1):
    if family == "sde":
        cfg = small_cfg(Tf=TF)
        cfg["encoder"]["kwargs"]["dropout"] = cfg["aggregator"]["kwargs"]["dropout"] = drop
    else:
        cfg = small_baseline_cfg(Tf=TF, drop=drop)
    enc = cfg["encoder"]["kwargs"]
    enc.update(fused=path == "fused", remat=remat)
    if path == "capped":
        enc["neighbor_cap"] = CAP
    if path.startswith("adaptive"):
        enc["adaptive"] = True
    return bf16_cfg(cfg) if path == "bf16" else cfg


def _scene():
    """The test scene, with actors 2 and 3 copies of actor 1: equally far
    from every receiver, so the cap meets exact ties."""
    _, ts = scene_pair(8, B, A, L)
    for f in ("x", "positions", "padding_mask", "bos_mask", "rotate_angles", "actor_valid"):
        v = getattr(ts, f)
        v[:, 2] = v[:, 1]
        v[:, 3] = v[:, 1]
    return ts


def test_the_scene_ties_senders_at_the_cap():
    """Some receiver's CAP-th and (CAP + 1)-th nearest in-radius senders are
    exactly as far, so which the cap keeps is the tie rule alone."""
    ts = _scene()
    mask, d2 = graph.aa_masks(ts, 50.0), (graph.aa_edge_vectors(ts) ** 2).sum(-1)
    d2 = torch.where(mask, d2, torch.full_like(d2, torch.inf)).sort(-1)[0]
    tied = (mask.sum(-1) > CAP) & (d2[..., CAP - 1] == d2[..., CAP])
    assert int(tied.sum()) > 0


def _nodes(model, seed=9):
    enc = model.encoder
    shape = (enc.historical_steps, 256, B, A + 1, enc.embed_dim)
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _forward(model, scene, generator, nodes=None):
    """The model's training forward, dropout drawn from ``generator``
    (None: the global RNG); the SDE family by parts, so that ``sde_nodes``
    can pin an adaptive encoder's trees."""
    if not hasattr(model.encoder, "ref_time"):
        return model(scene, generator=generator, rollout_seed=3)
    local, d_in, d_out, l_in, l_out = model.encoder(scene, generator=generator,
                                                    sde_nodes=nodes)
    glob = model.aggregator(scene, local, generator)
    out = model.decoder(scene, local, glob, generator=generator, rollout_seed=3)
    out.update(y=model.rotated_y(scene), diff_in=d_in, diff_out=d_out, label_in=l_in,
               label_out=l_out)
    return out


def _loss(cfg, out):
    y = out["y"][:, :, -TF:]   # the targets of the TF steps reg_mask covers
    return sum(w * fn(y, out) for _, w, fn in tconfig.build_losses(cfg))


def _step(model, cfg, scene, generator, nodes=None):
    """One train step's (outputs, loss, gradients), then the generator's state."""
    model.zero_grad(set_to_none=True)
    out = _forward(model, scene, generator, nodes)
    loss = _loss(cfg, out)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    outs = {k: v.detach() for k, v in out.items() if isinstance(v, torch.Tensor)}
    state = torch.get_rng_state() if generator is None else generator.get_state()
    return outs, loss.detach(), grads, state


def _models(family, path, seed=1):
    """(plain, remat) models of one seeded weight tree, in training mode."""
    plain = torch_build_model(_cfg(family, path, remat=False), device="cpu", seed=seed).train()
    remat = torch_build_model(_cfg(family, path), device="cpu", seed=seed).train()
    assert not plain.encoder.remat and remat.encoder.remat
    return plain, remat


def _assert_bit_equal(got, want):
    (outs_g, loss_g, grads_g, state_g), (outs_w, loss_w, grads_w, state_w) = got, want
    assert outs_g.keys() == outs_w.keys()
    for k in outs_w:
        assert torch.equal(outs_g[k], outs_w[k]), k
    assert torch.equal(loss_g, loss_w)
    assert grads_g.keys() == grads_w.keys()
    for k, w in grads_w.items():
        g = grads_g[k]
        assert (g is None) == (w is None), k
        assert w is None or torch.equal(g, w), k
    assert torch.equal(state_g, state_w), "the generator is not where the plain step left it"


@pytest.mark.parametrize("family,path", CASES, ids=IDS)
def test_remat_steps_are_the_plain_steps_bit_for_bit(family, path):
    """An explicit generator, two train steps in a row on each model."""
    plain, remat = _models(family, path)
    cfg, scene = _cfg(family, path), _scene()
    nodes = _nodes(plain) if path == "adaptive_pinned" else None
    gens = {m: torch.Generator().manual_seed(5) for m in ("plain", "remat")}
    firsts = []
    for _ in range(2):
        want = _step(plain, cfg, scene, gens["plain"], nodes)
        got = _step(remat, cfg, scene, gens["remat"], nodes)
        _assert_bit_equal(got, want)
        firsts.append(want[1])
    assert not torch.equal(*firsts), "the second step drew the first step's masks"
    if path == "capped":
        count = remat.encoder.aa_encoder.aa_overflow_edges
        assert count is not None and torch.equal(count, plain.encoder.aa_encoder.aa_overflow_edges)
        assert int(count) > 0


@pytest.mark.parametrize("family,path", CASES, ids=IDS)
def test_remat_step_on_the_global_rng_is_the_plain_step(family, path):
    """``generator=None``: dropout draws from the global RNG, which
    ``torch.utils.checkpoint`` itself restores for the recompute."""
    plain, remat = _models(family, path)
    cfg, scene = _cfg(family, path), _scene()
    nodes = _nodes(plain) if path == "adaptive_pinned" else None
    torch.manual_seed(11)
    want = _step(plain, cfg, scene, None, nodes)
    torch.manual_seed(11)
    got = _step(remat, cfg, scene, None, nodes)
    _assert_bit_equal(got, want)


class _Calls:
    """Forward calls of the AA and AL blocks, and the bytes autograd saves
    outside any inner hooks (``torch.utils.checkpoint`` keeps its own).
    The calls are counted by forward pre-hooks: a recompute stops once it
    has rebuilt what the backward needs, before a block's forward returns."""

    def __init__(self, model, nodes=None):
        self.model, self.nodes = model, nodes
        self.calls, self.saved = {"aa": 0, "al": 0}, 0
        for name in self.calls:
            block = getattr(model.encoder, f"{name}_encoder")
            block.register_forward_pre_hook(lambda *_, n=name: self._count(n))

    def _count(self, name):
        self.calls[name] += 1

    def _pack(self, x):
        self.saved += x.numel() * x.element_size()
        return x

    def run(self, cfg, scene, backward=True):
        self.calls, self.saved = {"aa": 0, "al": 0}, 0
        self.model.zero_grad(set_to_none=True)
        with saved_tensors_hooks(self._pack, lambda x: x):
            out = _forward(self.model, scene, torch.Generator().manual_seed(5), self.nodes)
            loss = _loss(cfg, out)
        if backward:
            loss.backward()
        return dict(self.calls), self.saved


def _pair_bytes(model, path):
    """One [B, Th, Aq, Ak, D] pair tensor of the AA block in its compute
    dtype (Ak the cap on the capped path).  The fused path's op keeps no
    such tensor in either mode; its pair tensors are the pair features, the
    mask and the keep mask, [B, Th, Aq, Ak] x (4 + 1 + H) in f32."""
    aa = model.encoder.aa_encoder
    Th, D = aa.bos_token.shape
    Aq = A + 1 if hasattr(model.encoder, "ref_time") else A
    Ak = CAP if path == "capped" else A
    if path == "fused":
        return B * Th * Aq * Ak * (4 + 1 + aa.attn.num_heads) * 4
    return B * Th * Aq * Ak * D * (2 if path == "bf16" else 4)


@pytest.mark.parametrize("family,path", CASES, ids=IDS)
def test_remat_recomputes_the_blocks_and_saves_less(family, path):
    """Each block runs twice in a remat train step, once in the plain one,
    under ``no_grad`` and in eval; the saved bytes fall by a pair tensor."""
    cfg, scene = _cfg(family, path), _scene()
    plain, remat = _models(family, path)
    nodes = _nodes(plain) if path == "adaptive_pinned" else None
    plain, remat = _Calls(plain, nodes), _Calls(remat, nodes)
    want_calls, plain_saved = plain.run(cfg, scene)
    got_calls, remat_saved = remat.run(cfg, scene)
    assert want_calls == {"aa": 1, "al": 1} and got_calls == {"aa": 2, "al": 2}
    pair = _pair_bytes(remat.model, path)
    assert plain_saved - remat_saved >= pair, (plain_saved, remat_saved, pair)
    with torch.no_grad():
        assert remat.run(cfg, scene, backward=False)[0] == {"aa": 1, "al": 1}
    remat.model.eval()
    assert remat.run(cfg, scene, backward=False)[0] == {"aa": 1, "al": 1}


# ---------------------------------------------------------------------------
# against JAX's nn.remat
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["sde", "baseline"])
def jax_remat(request):
    """JAX's model with ``remat=True`` at dropout 0, its params, one train
    step's loss and gradients (pinned noise) and its forward's outputs."""
    family = request.param
    cfg = _cfg(family, drop=0.0)
    js, ts = scene_pair(3, B, A, L)
    jm = jax_build_model(ExperimentConfig(cfg))
    assert jm.encoder.remat
    params = jax.jit(jm.init)({"params": jax.random.key(0), "sde": jax.random.key(1)}, js)
    en, tw, de = noise_for(cfg, B, A, seed=4)
    if family == "sde":
        def jax_loss(p):
            def fwd(m, scene):
                local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
                glob = m.aggregator(scene, local, True)
                out = m.decoder(scene, local, glob, True, de)
                out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out,
                           y=m._rotated_y(scene))
                return out

            out = jm.apply(p, js, method=fwd)
            y = out["y"][:, :, -TF:]
            return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out), out
    else:
        def jax_loss(p):
            out = jm.apply(p, js)
            return jlosses.l2_loss(out["y"][:, :, -TF:], out), out

    (loss, out), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    return dict(family=family, js=js, ts=ts, params=jax.tree.map(np.asarray, params),
                noise=(t(en), t(tw), t(de)), loss=float(loss),
                out={k: np.asarray(out[k]) for k in ("loc", "pi")},
                grads=params_from_flax(jax.tree.map(np.asarray, grads)))


def test_jax_remat_tree_bridges_into_the_remat_model_under_the_plain_keys(jax_remat):
    family = jax_remat["family"]
    sd = params_from_flax(jax_remat["params"])
    remat = torch_build_model(_cfg(family), device="cpu")
    plain = torch_build_model(_cfg(family, remat=False), device="cpu")
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(sd)           # strict: every key, no other
    assert all(torch.equal(remat.state_dict()[k], sd[k]) for k in sd)


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_remat_train_step_matches_jax_remat(jax_remat, path):
    """Training mode at dropout 0, so the port rematerializes; the fused
    path (the plain K3 / K4) against JAX's dense remat: the same function
    of the same weights."""
    jr, family = jax_remat, jax_remat["family"]
    model = torch_build_model(_cfg(family, path, drop=0.0), device="cpu").train()
    model.load_state_dict(params_from_flax(jr["params"]))
    en, tw, de = jr["noise"]
    if family == "sde":
        out = model(jr["ts"], enc_noise=en, twin_noise=tw, dec_noise=de)
        y = out["y"][:, :, -TF:]
        loss = tlosses.l2_loss(y, out) + tlosses.diff_bce_loss(y, out)
    else:
        out = model(jr["ts"], generator=torch.Generator().manual_seed(0), rollout_seed=3)
        loss = tlosses.l2_loss(out["y"][:, :, -TF:], out)
    for k, want in jr["out"].items():
        np.testing.assert_allclose(out[k].detach().numpy(), want, **TOL, err_msg=k)
    calls = []
    model.encoder.aa_encoder.register_forward_pre_hook(lambda *_: calls.append(1))
    loss.backward()
    assert calls == [1], "the backward did not recompute the AA block"
    np.testing.assert_allclose(loss.item(), jr["loss"], rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()}, jr["grads"])


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL only: importing tensorboard here pulls in TensorFlow."""
    monkeypatch.setattr(tlogging, "_tensorboard_writer", lambda log_dir: None)


def _remat_yaml(json_path):
    """A YAML copy of the JSON config ``write_run`` wrote, with
    ``encoder.kwargs.remat: true``."""
    import yaml

    with open(json_path) as f:
        cfg = json.load(f)
    cfg["encoder"]["kwargs"]["remat"] = True
    path = json_path[:-len(".json")] + "_remat.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_remat_yaml_trains_resumes_and_evaluates_as_the_plain_config(tmp_path, capsys):
    """The small flagship (both fused paths, their plain versions here) at
    batch 4: one epoch through ``train_torch.main`` gives the plain config's
    weights bit for bit, ``--ckpt`` resumes it, and ``test_torch.main``
    gives the plain config's metrics on its checkpoint."""
    plain = write_run(tmp_path)
    remat = _remat_yaml(plain)
    assert tconfig.load_config(remat)["encoder"]["kwargs"]["remat"] is True

    def train(cfg, name, *extra):
        return train_torch.main(["-c", cfg, "-n", name, "--logdir", str(tmp_path / "logs"),
                                 "--device", "cpu", "--seed", "3", "--epochs", "1", *extra])[0]

    got, want = train(remat, "remat"), train(plain, "plain")
    assert got.model.encoder.remat and not want.model.encoder.remat
    assert got.step == want.step == 3
    sd_got, sd_want = got.model.state_dict(), want.model.state_dict()
    assert all(torch.equal(sd_got[k], sd_want[k]) for k in sd_want)
    latest = CheckpointManager(str(tmp_path / "logs" / "remat" / "checkpoints")).latest()
    resumed = train(remat, "remat", "--ckpt", latest["path"])
    assert resumed.step == 6
    capsys.readouterr()
    metrics = {}
    for cfg in (remat, plain):
        metrics[cfg] = test_torch.main(["-c", cfg, "--ckpt", latest["path"], "--device", "cpu"])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics[cfg]
    assert metrics[remat] == metrics[plain]
    assert set(metrics[remat]) == {"ADE_T", "FDE_T", "MR_T"}
    assert all(np.isfinite(v) for v in metrics[remat].values())


def test_remat_engine_and_forward_ood_are_the_plain_path_bit_for_bit():
    """Serving runs in eval mode, where remat calls the blocks directly."""
    models = {r: torch_build_model(_cfg("sde", remat=r), device="cpu", seed=2)
              for r in (False, True)}
    rng = np.random.default_rng(0)
    scenes = [make_raw_scene(rng, s % 2, num_actors=4, num_lanes=5) for s in range(3)]
    answers = {}
    for r, m in models.items():
        engine = ServingEngine(m, device="cpu", num_actors=A, num_lanes=L,
                               batch_buckets=(1, 2, 4), seed=5)
        try:
            answers[r] = engine.predict(scenes)
        finally:
            engine.close()
    assert len(answers[True]) == len(answers[False]) == 3
    for got, want in zip(answers[True], answers[False]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scene = _scene()
    ood = {r: m.eval().encoder.forward_ood(scene, generator=torch.Generator().manual_seed(1))
           for r, m in models.items()}
    assert all(torch.equal(a, b) for a, b in zip(ood[True], ood[False]))
