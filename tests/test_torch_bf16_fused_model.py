"""``FLAGSHIP_BF16_FUSED`` (``configs/nusargo/*_tpu.yml`` with its fallback
``encoder.fused: true``) and the HiVT baseline with a fused bf16 encoder vs
the JAX package's models on the CPU: the forward and one train step of
each family, at small width, with a flax init bridged into the port and
every draw pinned (dropout 0: the keep mask is held to JAX in
``tests/test_torch_aa_fused_bf16.py``).  The JAX side runs the fused AA
block through the interpret-mode Pallas op with ``dtype: bfloat16`` and
its default ``ln_mm``, compiled with XLA's excess precision off
(``_torch_helpers.jit_exact``); the port runs the plain versions of K3b
and K4b.

Bars (``tests/test_torch_bf16_model.py`` and ``test_torch_bf16_train.py``
give the measures): the forward within ``MODEL_BAR`` = max 2e-2 of
max|JAX| and mean 2e-3 of mean|JAX|; the loss of one step within rtol
5e-6; the gradient within ``GRAD_BAR`` (each leaf 0.1 of its scale plus
1e-3 of the largest leaf's scale, the whole within 0.06 in relative L2).
The port in f32 on the same weights fails the forward's mean bar (the
planted-fault cases).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax

from _torch_helpers import (bf16_cfg, bf16_distance, check_bf16, check_grads_bf16, jit_exact,
                            model_pair, noise_for, scene_pair, small_baseline_cfg, small_cfg, t,
                            torch_build_model)

torch.set_num_threads(1)
MODEL_BAR = (2e-2, 2e-3)
LOSS_RTOL = 5e-6
GRAD_BAR = dict(leaf_rel=0.1, floor=1e-3, l2_rel=0.06)
B, A, L, D, H, TF, K = 2, 4, 6, 32, 4, 12, 3


def _fused_bf16(cfg):
    cfg = bf16_cfg(cfg)
    cfg["encoder"]["kwargs"]["fused"] = True
    for sec in ("encoder", "aggregator"):
        cfg[sec]["kwargs"]["dropout"] = 0.0
    return cfg


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _sde_jax(jm, params, js, en, tw, de):
    """(loss, forward outputs, grads) of L2 + DiffBCE through the JAX model."""
    def loss_fn(p):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        y = y[:, :, -TF:]
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out), out

    (loss, out), grads = jit_exact(jax.value_and_grad(loss_fn, has_aux=True), params)(params)
    return float(loss), {k: np.asarray(v, np.float32) for k, v in out.items()}, \
        params_from_flax(jax.tree.map(np.asarray, grads))


def _sde_port(model, ts, en, tw, de):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(ts, enc_noise=en, twin_noise=tw, dec_noise=de)
    y = out["y"][:, :, -TF:]
    loss = tlosses.l2_loss(y, out) + tlosses.diff_bce_loss(y, out)
    loss.backward()
    return loss.item(), out, _grads(model)


def _baseline_jax(jm, params, js):
    def loss_fn(p):
        out = jm.apply(p, js)
        return jlosses.l2_loss(out["y"][:, :, -TF:], out), out

    (loss, out), grads = jit_exact(jax.value_and_grad(loss_fn, has_aux=True), params)(params)
    return float(loss), {k: np.asarray(v, np.float32) for k, v in out.items()}, \
        params_from_flax(jax.tree.map(np.asarray, grads))


def _baseline_port(model, ts):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(ts)
    loss = tlosses.l2_loss(out["y"][:, :, -TF:], out)
    loss.backward()
    return loss.item(), out, _grads(model)


@pytest.fixture(scope="module", params=["sde", "baseline"])
def family(request):
    """One family's JAX step (loss, forward, gradients), its bridged bf16
    port, and the port in f32 on the same weights."""
    if request.param == "sde":
        f32_cfg = small_cfg(D=D, H=H, Tf=TF, K=K)
        for sec in ("encoder", "aggregator"):
            f32_cfg[sec]["kwargs"]["dropout"] = 0.0
        f32_cfg["encoder"]["kwargs"]["fused"] = True
        cfg = _fused_bf16(small_cfg(D=D, H=H, Tf=TF, K=K))
        js, ts = scene_pair(8, B, A, L)
        jm, params, tm = model_pair(cfg, js)
        en, tw, de = noise_for(cfg, B, A, seed=4)
        want = _sde_jax(jm, params, js, en, tw, de)
        noise = (t(en), t(tw), t(de))
        step = lambda m: _sde_port(m, ts, *noise)  # noqa: E731
    else:
        f32_cfg = small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0, fused=True)
        cfg = _fused_bf16(small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0))
        js, ts = scene_pair(6, B, A, L)
        jm, params, tm = model_pair(cfg, js)
        want = _baseline_jax(jm, params, js)
        step = lambda m: _baseline_port(m, ts)  # noqa: E731
    f32 = torch_build_model(f32_cfg, device="cpu")
    f32.load_state_dict(tm.state_dict())
    aa = tm.encoder.aa_encoder
    assert aa.fused and aa.chain_dtype == "bfloat16" and aa.ln_mm
    return dict(tm=tm, f32=f32, step=step, want=want)


def test_flagship_bf16_fused_is_the_tpu_yaml_with_its_fallback():
    want = copy.deepcopy(tconfig.FLAGSHIP_BF16)
    want["encoder"]["kwargs"]["fused"] = True
    assert tconfig.FLAGSHIP_BF16_FUSED == want
    assert tconfig.FLAGSHIP_BF16_FUSED["decoder"] == tconfig.FLAGSHIP_BF16["decoder"]
    model = tconfig.build_model(tconfig.FLAGSHIP_BF16_FUSED, device="cpu")
    aa = model.encoder.aa_encoder
    assert aa.fused and aa.chain_dtype == "bfloat16" and aa.ln_mm is True
    assert model.encoder.compute_dtype is torch.bfloat16
    dense = tconfig.build_model(tconfig.FLAGSHIP_BF16, device="cpu").state_dict()
    assert list(model.state_dict()) == list(dense)


def test_fused_bf16_forward_matches_jax(family):
    _, out, _ = family["step"](copy.deepcopy(family["tm"]))
    want = family["want"][1]
    for k in ("loc", "pi"):
        assert out[k].dtype == torch.float32, k
        print(k, check_bf16(out[k].detach(), want[k], MODEL_BAR, k))


def test_fused_bf16_train_step_matches_jax(family):
    loss, _, grads = family["step"](copy.deepcopy(family["tm"]))
    want_loss, _, want_grads = family["want"]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    print("worst leaf / scale, relative L2:", check_grads_bf16(grads, want_grads, **GRAD_BAR))
    assert all(g is None or g.dtype == torch.float32 for g in grads.values())


def test_fused_model_in_f32_fails_the_bf16_bar(family):
    """The planted fault: the same weights and draws through the port in f32."""
    _, out, _ = family["step"](family["f32"])
    dists = [bf16_distance(out[k].detach(), family["want"][1][k]) for k in ("loc", "pi")]
    assert all(d[1] > MODEL_BAR[1] for d in dists), dists
