"""One bf16 train step of each family vs ``jax.value_and_grad`` of the JAX
package's bf16 model on the CPU: the SDE flagship through the loop rollout
and through the fused decoder (the plain K1 forward and K2 backward here,
JAX's interpret-mode ``sde_rollout_train`` on the other side, the same
decoder noise), and the HiVT baseline.  Dropout 0, pinned noise, a flax init
bridged into the port; the JAX side is compiled with XLA's excess precision
off (``jit_exact``).  Then the port's own train step on the bf16 model:
parameters, gradients and AdamW moments stay f32.

Bars: the loss within rtol 5e-6 (the bf16 forward meets JAX's bits, so
the loss is within 1.3e-7; the port in f32 is 2.4e-5 to 1e-4 off and fails
it: the planted-fault cases); every gradient leaf within 0.1 x its scale
plus 1e-3 x the largest leaf's scale, and the whole gradient within 0.06 in
relative L2.  A bf16 backward rounds every cotangent, and torch's autograd
and XLA's VJPs round in other places (a sigmoid's derivative, a bias
summed over rows), so single leaves drift by percents (worst 3.9e-2 of
scale, 3.4e-2 in L2), and a leaf whose true gradient is 0 (a key bias under
the softmax) is bf16 noise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu.ops.pallas.sde_rollout import rollout_params_from_linen, sde_rollout_train
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import build_losses
from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

from _torch_helpers import (bf16_cfg, check_grads_bf16, jit_exact, model_pair, noise_for,
                            scene_pair, small_baseline_cfg, small_cfg, t, torch_build_model)

torch.set_num_threads(1)
LOSS_RTOL = 5e-6
GRAD_BAR = dict(leaf_rel=0.1, floor=1e-3, l2_rel=0.06)
B, A, L, D, H, TF, K = 2, 4, 6, 32, 4, 12, 3   # B*K*A = 24 rows, 3 tiles of 8


def _sde_cfg(fused=False, dtype="bfloat16"):
    cfg = small_cfg(D=D, H=H, Tf=TF, K=K)
    for sec in ("encoder", "aggregator"):
        cfg[sec]["kwargs"]["dropout"] = 0.0
    cfg["decoder"]["kwargs"]["fused"] = fused
    return bf16_cfg(cfg) if dtype == "bfloat16" else cfg


def _jax_sde_step(jm, params, js, en, tw, de, fused):
    """(loss, grads) of L2 + DiffBCE; ``fused``: the decoder rolls out through
    the interpret-mode Pallas training rollout on ``de`` as its noise, as
    ``SDEDecoder._fused_rollout`` does with a drawn one."""
    def loss_fn(p):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            dec = m.decoder
            if fused:
                y0 = dec.fuse(scene, local, glob)
                t0s, dts = dec.time_grid()
                kp = rollout_params_from_linen(dec.sde_rollout_params())
                ys = sde_rollout_train(y0.reshape(-1, D).astype(jnp.float32), kp, t0s, dts,
                                       jnp.int32(0), num_steps=TF, block_rows=8, interpret=True,
                                       noise=de.reshape(TF, -1, D))
                ys = ys.reshape((TF,) + y0.shape).astype(y0.dtype)
                out = dec.decode(scene, jnp.transpose(ys, (1, 2, 3, 0, 4)), local, glob)
            else:
                out = dec(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        y = y[:, :, -TF:]
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    loss, grads = jit_exact(jax.value_and_grad(loss_fn), params)(params)
    return float(loss), params_from_flax(jax.tree.map(np.asarray, grads))


def _port_sde_step(model, ts, en, tw, de, fused):
    model.train()
    model.zero_grad(set_to_none=True)
    if fused:
        local, d_in, d_out, l_in, l_out = model.encoder(ts, sde_noise=en, twin_noise=tw)
        glob = model.aggregator(ts, local)
        dec = model.decoder
        y0 = dec.fuse(ts, local, glob)
        ys = dec.fused_rollout(y0, 0, noise=de.reshape(TF, -1, D))
        out = dec.decode(ts, ys.permute(1, 2, 3, 0, 4), local, glob)
        out.update(y=model.rotated_y(ts), diff_in=d_in, diff_out=d_out, label_in=l_in,
                   label_out=l_out)
    else:
        out = model(ts, enc_noise=en, twin_noise=tw, dec_noise=de)
    y = out["y"][:, :, -TF:]
    loss = tlosses.l2_loss(y, out) + tlosses.diff_bce_loss(y, out)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=[False, True], ids=["loop", "fused_decoder"])
def sde_step(request):
    fused = request.param
    js, ts = scene_pair(8, B, A, L)
    jm, params, tm = model_pair(_sde_cfg(fused), js)
    en, tw, de = noise_for(_sde_cfg(), B, A, seed=4)
    loss, grads = _jax_sde_step(jm, params, js, en, tw, de, fused)
    return dict(fused=fused, ts=ts, tm=tm, noise=(t(en), t(tw), t(de)), loss=loss, grads=grads)


def _check_step(loss, grads, want):
    np.testing.assert_allclose(loss, want["loss"], rtol=LOSS_RTOL)
    check_grads_bf16(grads, want["grads"], **GRAD_BAR)


def test_sde_train_step_in_bf16_matches_jax(sde_step):
    r = sde_step
    loss, grads = _port_sde_step(copy.deepcopy(r["tm"]), r["ts"], *r["noise"], r["fused"])
    _check_step(loss, grads, r)
    assert all(g is None or g.dtype == torch.float32 for g in grads.values())


def test_sde_train_step_in_f32_fails_the_bf16_bar(sde_step):
    """The planted fault: the same weights and noise through the port in f32."""
    r = sde_step
    f32 = torch_build_model(_sde_cfg(r["fused"], dtype="float32"), device="cpu")
    f32.load_state_dict(r["tm"].state_dict())
    with pytest.raises(AssertionError):
        _check_step(*_port_sde_step(f32, r["ts"], *r["noise"], r["fused"]), r)


@pytest.fixture(scope="module")
def baseline_step():
    cfg = bf16_cfg(small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0))
    js, ts = scene_pair(6, B, A, L)
    jm, params, tm = model_pair(cfg, js)

    def loss_fn(p):
        out = jm.apply(p, js)
        return jlosses.l2_loss(out["y"][:, :, -TF:], out)

    loss, grads = jit_exact(jax.value_and_grad(loss_fn), params)(params)
    return dict(ts=ts, tm=tm, loss=float(loss),
                grads=params_from_flax(jax.tree.map(np.asarray, grads)))


def _port_baseline_step(model, ts):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(ts)
    loss = tlosses.l2_loss(out["y"][:, :, -TF:], out)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def test_baseline_train_step_in_bf16_matches_jax(baseline_step):
    r = baseline_step
    _check_step(*_port_baseline_step(copy.deepcopy(r["tm"]), r["ts"]), r)


def test_baseline_train_step_in_f32_fails_the_bf16_bar(baseline_step):
    r = baseline_step
    f32 = torch_build_model(small_baseline_cfg(D=D, H=H, Tf=TF, K=K, drop=0.0), device="cpu")
    f32.load_state_dict(r["tm"].state_dict())
    with pytest.raises(AssertionError):
        _check_step(*_port_baseline_step(f32, r["ts"]), r)


@pytest.mark.parametrize("fused", [False, True], ids=["loop", "fused_decoder"])
def test_the_train_step_keeps_parameters_gradients_and_moments_f32(fused):
    """Three steps of the port's own train step (dropout live) on the bf16
    flagship: the losses are finite and every parameter, gradient and AdamW
    moment is f32."""
    cfg = bf16_cfg(small_cfg(D=D, H=H, Tf=60, K=K))   # the losses read 60 steps
    cfg["decoder"]["kwargs"]["fused"] = fused
    model = torch_build_model(cfg, device="cpu", seed=2)
    _, ts = scene_pair(3, B, A, L)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=3, seed=0)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           torch.device("cpu"))
    for i in range(3):
        logs = step(ts, i, 0)
        assert np.isfinite(float(logs["train/total"])) and logs["train/step_skipped"] == 0.0
    for p in model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    moments = [v for s in state.optimizer.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.float32 for m in moments)
