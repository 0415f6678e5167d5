"""The fused AA pair chain's backward (kernel K4's plain version), its
``torch.autograd.Function`` and training with ``encoder.fused: true`` vs
the JAX package on the CPU.

The JAX side runs as ``tests/test_aa_fused.py`` runs it: the Pallas op and
its custom VJP (``_bwd_call``) in interpret mode, at the JAX tests' width
(D 16, 4 heads) and the kernels' own (D 64 at 8 and 4 heads).
Tolerances: the plain K4 rtol 1e-4 / atol 1e-5 for ``dq`` and 1e-4 / 1e-4
for the weight gradients (``tests/test_aa_fused.py``'s, the same f32 chain
differentiated in another order); one ``AAEncoder``'s gradients rtol 1e-3
/ atol 1e-4 (1e-5 for ``x_q``), as ``tests/test_aa_fused.py`` holds the
fused encoder to the dense one; one whole train step: the loss rtol 2e-4
and every gradient leaf max|diff| <= 2e-3 x leaf scale + 1e-6
(``tests/test_torch_train.py``'s).
"""
import copy
import ctypes
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu.models.local_encoder import AAEncoder as JaxAAEncoder
from trajsde_tpu.ops.pallas import aa_fused as jax_k3
from trajsde_tpu.ops.pallas.aa_attention import pack_aa_params as jax_pack_aa_params
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import build_losses, build_metrics
from trajsde_tpu_torch.models.local_encoder import AAEncoder
from trajsde_tpu_torch.ops import aa_fused as K3
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import Trainer, create_train_state, make_train_step

from _torch_helpers import (check_leaves, model_pair, noise_for, scene_pair, small_cfg, t,
                            torch_build_model)

torch.set_num_threads(1)
TOL_DQ = dict(rtol=1e-4, atol=1e-5)
TOL_DW = dict(rtol=1e-4, atol=1e-4)
TOL_ENC = dict(rtol=1e-3, atol=1e-4)
TOL_ENC_X = dict(rtol=1e-3, atol=1e-5)
B, A, L = 2, 5, 6


def _aa_inputs(r, Bq=2, T=3, Aq=5, Ak=4):
    """numpy AAEncoder inputs with one receiver that has no sender."""
    x_q = r.normal(0, 2, (Bq, T, Aq, 2)).astype(np.float32)
    x_k = r.normal(0, 2, (Bq, T, Ak, 2)).astype(np.float32)
    ang = r.uniform(-np.pi, np.pi, (Bq, Aq))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2).astype(np.float32)
    bos = r.uniform(size=(Bq, Aq, T)) < 0.2
    mask = r.uniform(size=(Bq, T, Aq, Ak)) < 0.6
    mask[0, 1, 2] = False
    edge = r.normal(0, 10, (Bq, T, Aq, Ak, 2)).astype(np.float32)
    return x_q, x_k, rot, bos, mask, edge


def _model_ws(D=16, H=4, T=3):
    r = np.random.default_rng(0)
    inputs = _aa_inputs(r, T=T)
    jenc = JaxAAEncoder(historical_steps=T, embed_dim=D, num_heads=H, fused=True)
    params = jenc.init(jax.random.key(0), *map(jnp.asarray, inputs))["params"]
    packed = jax_pack_aa_params(params)
    return tuple(np.asarray(packed[k], np.float32) for k in K3.W_ORDER)


def _random_ws(r, D=16):
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wkv=(D, 2 * D), bkv=(1, 2 * D))
    return tuple((r.standard_normal(shapes[k]) * (0.3 if k[0] == "w" else 1.0))
                 .astype(np.float32) for k in K3.W_ORDER)


def _op_case(weights, with_keep, seed=2, D=16, H=4):
    """Aq != Ak, T*Aq = 15 rows in backward tiles of 4 (the last one
    padded by JAX), a receiver with no sender; numpy inputs, the cotangent
    and the JAX op's (dq, dws) from ``jax.vjp`` of the interpret-mode op."""
    Bq, T, Aq, Ak, p = 2, 3, 5, 4, 0.1
    r = np.random.default_rng(seed)
    ws = _model_ws(D, H, T) if weights == "model" else _random_ws(r, D)
    q = r.standard_normal((Bq, T, Aq, D)).astype(np.float32)
    u = (r.standard_normal((Bq, T, Aq, Ak, 4)) * 3).astype(np.float32)
    mask = (r.uniform(size=(Bq, T, Aq, Ak)) < 0.6).astype(np.float32)
    mask[1, 2, 4] = 0.0
    keep = (r.uniform(size=(Bq, T, Aq, Ak, H)) >= p).astype(np.float32) if with_keep else None
    g = r.standard_normal((Bq, T, Aq, D)).astype(np.float32)
    cfg = jax_k3.FusedCfg(Aq=Aq, Ak=Ak, D=D, H=H, rows_fwd=8, rows_bwd=4, dropout_rate=p,
                          dtype="float32", interpret=True)
    jkeep = None if keep is None else jnp.asarray(keep)
    _, vjp = jax.vjp(lambda q_, ws_: jax_k3.fused_pair_attention(
        cfg, q_, jnp.asarray(u), jnp.asarray(mask), jkeep, ws_), jnp.asarray(q),
        tuple(map(jnp.asarray, ws)))
    jdq, jdws = vjp(jnp.asarray(g))
    want = (np.asarray(jdq), [np.asarray(d) for d in jdws])
    args = (t(q), t(u), t(mask), None if keep is None else t(keep), tuple(map(t, ws)))
    return args, t(g), H, p, want


def _assert_grads(dq, dws, want, ws):
    np.testing.assert_allclose(dq.numpy(), want[0], **TOL_DQ)
    assert len(dws) == len(want[1]) == len(K3.W_ORDER)
    for name, got, w, x in zip(K3.W_ORDER, dws, want[1], ws):
        assert got.shape == x.shape, name
        np.testing.assert_allclose(got.numpy(), w, **TOL_DW, err_msg=name)


# --------------------------------------------------------------------------
# (a) the plain K4 vs the JAX backward
# --------------------------------------------------------------------------
# (weights, with_keep, D, H): the JAX tests' width (D 16, 4 heads), then
# the kernels' own, D 64 at the flagship's 8 heads and the baseline's 4
CHAIN_CASES = [pytest.param(w, k, d, h, id=f"{w}-{k}" + ("" if d == 16 else f"-D{d}-H{h}"))
               for d, h in ((16, 4), (64, 8), (64, 4))
               for w in ("model", "random") for k in (False, True)]


@pytest.mark.parametrize("weights,with_keep,D,H", CHAIN_CASES)
def test_plain_k4_matches_jax_vjp(weights, with_keep, D, H):
    (q, u, mask, keep, ws), g, H, p, want = _op_case(weights, with_keep, D=D, H=H)
    dq, dws = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, p)
    _assert_grads(dq, dws, want, ws)
    assert torch.all(dq[1, 2, 4] == 0.0)          # no sender: no gradient, not NaN
    # the CPU wrapper is the plain version and launches nothing
    before = K3.fused_pair_attention_bwd.launches
    dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p)
    assert K3.fused_pair_attention_bwd.launches == before
    assert torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))


# --------------------------------------------------------------------------
# (b) the autograd Function's wiring
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_keep", [False, True])
def test_function_gives_the_jax_gradients_and_none_to_the_constants(with_keep):
    (q, u, mask, keep, ws), g, H, p, want = _op_case("random", with_keep, seed=5)
    q = q.requires_grad_()
    ws = tuple(w.requires_grad_() for w in ws)
    consts = [u.requires_grad_(), mask.requires_grad_()]
    if keep is not None:
        consts.append(keep.requires_grad_())
    before = (K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
    out = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
    assert type(out.grad_fn).__name__ == "FusedPairAttentionFnBackward"
    out.backward(g)
    assert (K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches) == before
    _assert_grads(q.grad, [w.grad for w in ws], want, ws)
    assert all(x.grad is None for x in consts)    # JAX's zero cotangent


def test_no_grad_and_detached_calls_record_nothing():
    (q, u, mask, keep, ws), _, H, p, _ = _op_case("model", False)
    with torch.no_grad():
        assert K3.fused_pair_attention(q.requires_grad_(), u, mask, keep, ws, H, p).grad_fn is None
    out = K3.fused_pair_attention(q.detach(), u, mask, keep, ws, H, p)
    assert out.grad_fn is None
    want = K3.fused_pair_attention_reference(q.detach(), u, mask, keep, ws, H, p)
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["width", "dtype", "contiguity", "keep shape"])
def test_kernel_checks_raise_before_any_launch(bad):
    """K3's and K4's shared argument checks, reached without a card."""
    D, H = K3.KERNEL_DIM, K3.KERNEL_HEADS
    r = np.random.default_rng(1)
    ws = [w for w in _random_ws(r, D)]
    q, u = torch.zeros(1, 2, 3, D), torch.zeros(1, 2, 3, 4, 4)
    mask, keep = torch.ones(1, 2, 3, 4), torch.ones(1, 2, 3, 4, H)
    ws = tuple(map(t, ws))
    if bad == "width":
        q, H = torch.zeros(1, 2, 3, 16), 4
        err = ValueError
    elif bad == "dtype":
        u, err = u.double(), TypeError
    elif bad == "contiguity":
        u, err = torch.zeros(1, 2, 3, 4, 4).transpose(1, 2).contiguous().transpose(1, 2), ValueError
    else:
        keep, err = torch.ones(1, 2, 3, 4, 2), ValueError
    with pytest.raises(err):
        K3._common_checks(q, u, mask, keep, ws, H, sum(w.numel() for w in ws))


@pytest.mark.parametrize("D,H,ok", [(64, 8, True), (64, 4, True), (64, 2, False),
                                    (32, 4, False), (16, 4, False)])
def test_kernel_checks_take_the_kernels_widths_only(D, H, ok):
    """K3 and K4 take D 64 at the flagship's 8 heads and the baseline's 4;
    any other width is refused before a launch, naming the widths."""
    r = np.random.default_rng(3)
    ws = tuple(map(t, _random_ws(r, D)))
    q, u = torch.zeros(1, 2, 3, D), torch.zeros(1, 2, 3, 4, 4)
    mask, keep = torch.ones(1, 2, 3, 4), torch.ones(1, 2, 3, 4, H)
    floats = sum(w.numel() for w in ws)
    if ok:
        R, Ak, w = K3._common_checks(q, u, mask, keep, ws, H, floats)
        assert (R, Ak, w.numel()) == (6, 4, floats)
    else:
        with pytest.raises(ValueError, match=r"D=64 at H in \(8, 4\)"):
            K3._common_checks(q, u, mask, keep, ws, H, floats)


def test_kernel_entry_points_are_picked_by_head_count():
    """The 8-head entry points keep the flagship's names, the 4-head ones
    have their own; a build without a head count's entry points (of an
    older source) is declared for the others and refused for it."""
    class Fn:  # stands in for a C function: takes argtypes and restype
        pass

    lib = types.SimpleNamespace(_name="libold.so", aa_fused_weight_floats=Fn(),
                                aa_fused_launch=Fn(), aa_fused_receivers_per_group=Fn())
    K3.configure_fwd(lib)
    assert lib.aa_fused_launch.restype is ctypes.c_int and len(lib.aa_fused_launch.argtypes) == 12
    assert K3.has_heads(lib, "aa_fused", 8) and not K3.has_heads(lib, "aa_fused", 4)
    assert K3._entry(lib, "aa_fused", "launch", 8) is lib.aa_fused_launch
    with pytest.raises(ValueError, match="no 4-head entry point aa_fused_h4_launch"):
        K3._entry(lib, "aa_fused", "receivers_per_group", 4)
    lib.aa_fused_h4_launch, lib.aa_fused_h4_receivers_per_group = Fn(), Fn()
    K3.configure_fwd(lib)
    assert K3._entry(lib, "aa_fused", "launch", 4) is lib.aa_fused_h4_launch
    assert lib.aa_fused_h4_receivers_per_group.restype is ctypes.c_int
    bwd = types.SimpleNamespace(_name="libaa_fused_bwd.so", aa_fused_bwd_weight_floats=Fn(),
                                **{f"aa_fused_bwd{s}_{w}": Fn() for s in ("", "_h4")
                                   for w in ("launch", "receivers_per_group")})
    K3.configure_bwd(bwd)
    assert len(K3._entry(bwd, "aa_fused_bwd", "launch", 4).argtypes) == 16


# --------------------------------------------------------------------------
# (c) the fused encoder's gradients
# --------------------------------------------------------------------------
def test_fused_aa_encoder_gradients_match_jax_and_the_dense_path():
    D, H, T = 16, 4, 3
    r = np.random.default_rng(0)
    inputs = _aa_inputs(r, T=T)
    jenc = JaxAAEncoder(historical_steps=T, embed_dim=D, num_heads=H, fused=True, rows_fwd=8,
                        rows_bwd=4)
    params = jenc.init(jax.random.key(0), *map(jnp.asarray, inputs))["params"]
    ct = r.standard_normal((2, T, 5, D)).astype(np.float32)

    def loss(p, xq):
        return jnp.sum(jenc.apply({"params": p}, xq, *map(jnp.asarray, inputs[1:])) * ct)

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(inputs[0]))
    want = params_from_flax(jax.tree.map(np.asarray, jg_p))

    fused = AAEncoder(T, D, H, fused=True)
    fused.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    dense = AAEncoder(T, D, H)
    dense.load_state_dict(fused.state_dict())
    grads = {}
    for name, enc in (("fused", fused), ("dense", dense)):
        x_q = t(inputs[0]).requires_grad_()
        out = enc.eval()(x_q, *[t(a) for a in inputs[1:]])
        (out * t(ct)).sum().backward()
        grads[name] = ({n: p.grad for n, p in enc.named_parameters()}, x_q.grad)
    np.testing.assert_allclose(grads["fused"][1].numpy(), np.asarray(jg_x), **TOL_ENC_X)
    np.testing.assert_allclose(grads["fused"][1].numpy(), grads["dense"][1].numpy(), **TOL_ENC_X)
    assert set(grads["fused"][0]) == set(want)
    for name, w in want.items():
        got = grads["fused"][0][name]
        np.testing.assert_allclose(got.numpy(), w.numpy(), **TOL_ENC, err_msg=name)
        np.testing.assert_allclose(got.numpy(), grads["dense"][0][name].numpy(), **TOL_ENC,
                                   err_msg=name)


# --------------------------------------------------------------------------
# the config, one train step vs JAX, and the Trainer
# --------------------------------------------------------------------------
def test_flagship_train_fused_is_flagship_train_with_the_fused_encoder():
    want = copy.deepcopy(tconfig.FLAGSHIP_TRAIN)
    want["encoder"]["kwargs"]["fused"] = True
    assert tconfig.FLAGSHIP_TRAIN_FUSED == want
    assert tconfig.FLAGSHIP_TRAIN_FUSED["decoder"]["kwargs"]["fused"] is True
    assert "fused" not in tconfig.FLAGSHIP["encoder"]["kwargs"]
    assert "fused" not in tconfig.FLAGSHIP_TRAIN["encoder"]["kwargs"]
    model = tconfig.build_model(tconfig.FLAGSHIP_TRAIN_FUSED, device="cpu")
    assert model.encoder.aa_encoder.fused and model.decoder.fused


def _train_fused_cfg(Tf=12, drop=0.1, lr=None):
    """``FLAGSHIP_TRAIN_FUSED`` at the tiny width of ``small_cfg``."""
    cfg = small_cfg(Tf=Tf)
    cfg["encoder"]["kwargs"].update(dropout=drop, fused=True)
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = True
    if lr is not None:
        cfg["training_specific"]["lr"] = lr
    return cfg


def test_train_step_grads_match_jax_with_the_fused_encoder():
    """The port's fused encoder (plain K3 + plain K4 through the Function)
    and fused rollout (plain K1 + K2) vs ``jax.value_and_grad`` of the JAX
    model with ``encoder.fused: true`` (interpret-mode op) and its scan
    decoder, the same decoder noise pinned in both."""
    cfg = _train_fused_cfg(drop=0.0)
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["decoder"]["kwargs"]["fused"] = False
    js, ts = scene_pair(8, B, A, L)
    jm, params, _ = model_pair(jax_cfg, js)
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
        y = y[:, :, -Tf:]
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    model = torch_build_model(cfg, device="cpu").train()
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    assert model.encoder.aa_encoder.fused and model.decoder.fused
    en, tw, de = t(en), t(tw), t(de)
    dec = model.decoder
    local, d_in, d_out, l_in, l_out = model.encoder(ts, sde_noise=en, twin_noise=tw)
    glob = model.aggregator(ts, local)
    y0 = dec.fuse(ts, local, glob)
    ys = dec.fused_rollout(y0, 0, noise=de.reshape(Tf, -1, y0.shape[-1]))
    out = dec.decode(ts, ys.permute(1, 2, 3, 0, 4), local, glob)
    out.update(y=model.rotated_y(ts), diff_in=d_in, diff_out=d_out, label_in=l_in,
               label_out=l_out)
    y = out["y"][:, :, -Tf:]
    loss = tlosses.l2_loss(y, out) + tlosses.diff_bce_loss(y, out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    check_leaves({n: p.grad for n, p in model.named_parameters()},
                 params_from_flax(jax.tree.map(np.asarray, jgrads)))


def test_trainer_fits_the_fused_encoder_and_restores_into_the_dense_one(tmp_path):
    cfg = _train_fused_cfg(Tf=60, lr=0.01)
    batches = [scene_pair(s, B, A, L)[1] for s in (20, 21)]
    state = create_train_state(torch_build_model(cfg, device="cpu", seed=1),
                               cfg["training_specific"], steps_per_epoch=2, seed=1)
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu")
    trainer.fit(state, lambda: batches, lambda: [], max_epochs=1)
    assert state.step == 2 and trainer.epoch_logs[-1]["train/steps_skipped"] == 0.0

    step = make_train_step(state.model, state.optimizer, state.scheduler, build_losses(cfg), "cpu")
    totals = [float(step(batches[0], state.step + k, 0)["train/total"]) for k in range(8)]
    assert all(math.isfinite(x) for x in totals)
    assert np.mean(totals[-3:]) < totals[0], totals
    state.step += 8

    ckpt = CheckpointManager(str(tmp_path), save_top_k=1)
    ckpt.save(state, metric=1.0, step=state.step)
    dense_cfg = copy.deepcopy(cfg)
    dense_cfg["encoder"]["kwargs"]["fused"] = False
    other = create_train_state(torch_build_model(dense_cfg, device="cpu", seed=9),
                               dense_cfg["training_specific"], steps_per_epoch=2)
    assert not other.model.encoder.aa_encoder.fused
    CheckpointManager(str(tmp_path)).restore(other)
    a, b = state.model.state_dict(), other.model.state_dict()
    assert other.step == state.step and list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
