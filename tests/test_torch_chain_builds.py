"""The chained train step (``train_torch.py --chain C``) on every shipped
build beside the f32 flagship, on the CPU, where the chained update runs
uncaptured (on a card each update is one replay of its CUDA graph): the bf16
recipes ``_tpu.yml`` (``FLAGSHIP_BF16``) and ``_tpu_fast.yml``
(``FLAGSHIP_BF16_CAPPED``), the ``encoder.fused: true`` fallback
(``FLAGSHIP_BF16_FUSED``, the plain K3b / K4b here), and the HiVT baseline
dense and fused (``BASELINE``, ``BASELINE_TRAIN``, the plain K3 / K4 at its
heads), each at a small size.

* a chain of 2 against 2 eager steps, dropout and ``ts_drop`` live, bit for
  bit, on each build as written and, for the SDE builds, with the fused
  decoder (the plain K1 / K2), so within the card's bar in the build's
  measure (``optim.chain_eager_gap``), which an unchanged state and a
  chain of the wrong sign fail; the key-bias entries
  (``optim.noise_entries``) are every softmax attention's key bias, rows
  D:2D of the baseline's packed ``in_proj.bias`` included, and nothing else;
* a capped build's ``aa_overflow_edges`` after a chained update: None;
* against JAX in f32, the baseline and the capped flagship: a chain of 3
  against three sequential ``jax.value_and_grad`` + optax updates with
  pinned noise and dropout 0, at ``tests/test_torch_chain.py``'s bars
  (Adam's eps 1e-4: losses rtol 2e-4, every leaf within 2e-3 x scale +
  1e-6; the configured eps: the same outside the key-bias entries, whose
  JAX gradient is rounding noise, below ``optim.NOISE_GRAD``, and every
  other leaf's above it);
* against JAX in bf16 (``_tpu.yml``'s small form, JAX compiled with XLA's
  excess precision off, Adam's eps at 1 on both sides, see BF16_EPS): a
  chain of 2, update 1's loss within rtol 5e-6 and the trained leaves'
  changes over the chain, outside the key-bias entries, within 0.06 in
  relative L2 and each within 0.3 x its scale + 1e-3 x the largest leaf's,
  which the port in f32 fails; a NaN planted in update 2 gives JAX's
  guarded update.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from trajsde_tpu import losses as jlosses
from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
from trajsde_tpu.train.optim import decay_mask as jax_decay_mask
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import build_dtype, build_losses
from trajsde_tpu_torch.models.layers import EdgeAttention, MultiheadSelfAttention
from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state, make_train_step
from trajsde_tpu_torch.train.optim import (NOISE_GRAD, chain_eager_bound, chain_eager_gap,
                                           grad_split, noise_entries)

from _torch_helpers import (bf16_cfg, check_leaves, jit_exact, noise_for, scene_pair,
                            small_baseline_cfg, small_cfg, t, torch_build_model)

torch.set_num_threads(1)
B, A, L = 2, 5, 6
D, H, K = 32, 4, 3
CAP = 2   # below the 5 senders, so the gather drops some
TRAINING = {"lr": 0.003, "weight_decay": 0.01, "T_max": 1, "nodecay": True}
EPS, CONFIGURED_EPS = 1e-4, 1e-8   # as tests/test_torch_chain.py (see its comment)
# the bf16 comparison with JAX: tests/test_torch_bf16_train.py's loss bar,
# and on each leaf's change over the chain its gradient bar's relative L2
# (0.06) and a leaf bar of CHANGE_REL x the leaf's change + CHANGE_FLOOR x
# the largest, at Adam's eps BF16_EPS on both sides.  At a small eps Adam's
# step is lr sign(g) wherever |g| >> eps, so an entry whose bf16 gradient
# lies near 0 steps by lr either way (130 of 244 leaves part by more than
# 0.1 of their change at eps 1e-4, the port in f32 182); at eps 1 the step
# follows the gradient, and the bf16 chain reads 1.4e-2 / 1.9e-2 in L2 after
# 1 / 2 updates (f32 1.4e-1 / 1.3e-1), its worst leaves 0.25 and 0.24 of
# their change (g_nus' output bias, the neighbour embedding's first bias:
# bf16 rounding over the 60 rollout steps, which a single step's gradient
# bar absorbs in its floor of 1e-3 x the largest gradient, where Adam's
# largest step is about lr), the f32 port 1.7
LOSS_RTOL_BF16, BF16_EPS, CHANGE_L2, CHANGE_REL, CHANGE_FLOOR = 5e-6, 1.0, 0.06, 0.3, 1e-3


def _sde(dtype="bfloat16", cap=0, fused=False, dec_fused=False, drop=0.1):
    cfg = small_cfg(D=D, H=H, Tf=60, K=K)
    cfg["encoder"]["kwargs"].update(dropout=drop, neighbor_cap=cap, fused=fused)
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = dec_fused
    cfg["training_specific"].update(TRAINING)
    return bf16_cfg(cfg) if dtype == "bfloat16" else cfg


def _baseline(fused=False, drop=0.1):
    cfg = small_baseline_cfg(D=D, H=H, Tf=60, K=K, drop=drop, fused=fused)
    cfg["training_specific"].update(TRAINING)
    return cfg


# the small form of each build, as written and (SDE builds) with the fused decoder
BUILDS = {
    "FLAGSHIP_BF16": lambda: _sde(),
    "FLAGSHIP_BF16+fused_decoder": lambda: _sde(dec_fused=True),
    "FLAGSHIP_BF16_CAPPED": lambda: _sde(cap=CAP),
    "FLAGSHIP_BF16_CAPPED+fused_decoder": lambda: _sde(cap=CAP, dec_fused=True),
    "FLAGSHIP_BF16_FUSED": lambda: _sde(fused=True),
    "FLAGSHIP_BF16_FUSED+fused_decoder": lambda: _sde(fused=True, dec_fused=True),
    "BASELINE": lambda: _baseline(),
    "BASELINE_TRAIN": lambda: _baseline(fused=True),
}


def _states_equal(a, b) -> bool:
    """Two ``TrainState``s' weights, AdamW state and schedule bit for bit."""
    wa, wb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (all(torch.equal(wa[k], wb[k]) for k in wa)
            and oa["state"].keys() == ob["state"].keys()
            and all(torch.equal(oa["state"][i][k], ob["state"][i][k])
                    for i in oa["state"] for k in oa["state"][i])
            and oa["param_groups"] == ob["param_groups"]
            and a.scheduler.state_dict() == b.scheduler.state_dict())


def _key_biases(model: nn.Module) -> dict:
    """Every softmax attention's key bias, found by module type."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, EdgeAttention):
            for lin in ("lin_k", "lin_k_edge"):
                if hasattr(m, lin):
                    out[f"{name}.{lin}.bias"] = slice(None)
        elif isinstance(m, MultiheadSelfAttention):
            d = m.in_proj.bias.shape[0] // 3
            out[f"{name}.in_proj.bias"] = slice(d, 2 * d)
    return out


@pytest.mark.parametrize("build", list(BUILDS))
def test_chain_of_2_is_two_eager_steps_bit_for_bit(build):
    """Dropout, ts_drop and any kernel's in-kernel noise live: two chained
    updates give the eager steps' weights, moments, schedule and logs bit
    for bit; the build's key-bias entries are its attentions' key biases."""
    cfg = BUILDS[build]()
    base = torch_build_model(cfg, device="cpu", seed=5)
    noise = noise_entries(dict(base.named_parameters()))
    assert noise == _key_biases(base) and noise
    if build.startswith("BASELINE"):
        assert {n: sl for n, sl in noise.items() if "in_proj" in n} == {
            n: slice(D, 2 * D) for n, _ in base.named_parameters() if n.endswith("in_proj.bias")}
    scenes = [scene_pair(s, B, A, L)[1] for s in (81, 82)]
    states = [create_train_state(copy.deepcopy(base), cfg["training_specific"],
                                 steps_per_epoch=2, seed=9) for _ in range(2)]
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
    torch.testing.assert_close(chained.chain_logs, want, rtol=0, atol=0)
    assert logs["train/step_skipped"] == 0.0 and logs["scenes"] == 2 * B
    assert all(p.dtype == torch.float32 for p in states[1].model.parameters())
    # the card's bar in the build's measure: the CPU's 0 meets it; a chain
    # that left every weight where it started, or stepped each the other
    # way, fails it
    dtype = build_dtype(cfg)
    bound = chain_eager_bound(cfg["training_specific"]["lr"], 2, dtype)
    start, after = base.state_dict(), states[0].model.state_dict()
    assert chain_eager_gap(states[1].model.state_dict(), after, start, dtype)[0] == 0.0
    assert chain_eager_gap(start, after, start, dtype)[0] > bound
    flipped = {k: 2 * v - after[k] for k, v in start.items()}
    assert chain_eager_gap(flipped, after, start, dtype)[0] > bound


def test_aa_overflow_edges_after_a_chained_update_is_that_updates_count():
    """``_tpu_fast.yml``'s small form: the eager step's forward leaves the
    capped block's ``aa_overflow_edges`` set to its batch's count; after a
    chained update it is None (JAX's train step does not log it, and on
    the card a count written under a CUDA graph would lie in its pool),
    however it read before the chain."""
    cfg = _sde(cap=CAP)
    model = torch_build_model(cfg, device="cpu", seed=5)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=4)
    chained = ChainedStep(model, state.optimizer, state.scheduler, build_losses(cfg), "cpu",
                          accum_steps=1)
    aa = model.encoder.aa_encoder
    for k, seed in enumerate((81, 82)):
        scene = scene_pair(seed, B, A, L)[1]
        model(scene, generator=torch.Generator().manual_seed(0), rollout_seed=0)
        assert int(aa.aa_overflow_edges) > 0
        chained([scene], k, 0)
        assert aa.aa_overflow_edges is None


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------
class _Pinned(nn.Module):
    """The model with each scene's noise pinned (looked up by the scene
    object), called as the train steps call a model; the baseline draws
    nothing at dropout 0."""

    def __init__(self, model, noise):
        super().__init__()
        self.model, self.noise = model, noise

    def forward(self, scene, generator=None, rollout_seed=None):
        if id(scene) not in self.noise:
            return self.model(scene, generator=generator, rollout_seed=rollout_seed)
        en, tw, de = self.noise[id(scene)]
        return self.model(scene, enc_noise=en, twin_noise=tw, dec_noise=de)


def _model_pair(cfg, js, seed=0):
    """(JAX model, its params, the port's model with the same weights),
    without the ``diagnostics`` that a capped model sows at init."""
    jm = jax_build_model(ExperimentConfig(cfg))
    variables = jax.jit(jm.init)({"params": jax.random.key(seed), "sde": jax.random.key(1)}, js)
    params = {"params": variables["params"]}
    tm = torch_build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _jax_loss(jm, baseline):
    """The config's losses of JAX's model: the baseline's L2, the flagship's
    L2 + DiffBCE with every draw pinned."""
    if baseline:
        def loss(p, js, *noise):
            out = jm.apply(p, js)
            return jlosses.l2_loss(out["y"], out)
        return loss

    def loss(p, js, en, tw, de):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, en, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd)
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)
    return loss


def _jax_updates(vg, params, tx, batches, noises):
    """Sequential updates with JAX's NaN guard: (losses, params after each
    update, each entry's largest |gradient| and its least non-zero one, by
    the port's names)."""
    opt_state = tx.init(params)
    losses, after, largest, least = [], [], {}, {}
    for js, n in zip(batches, noises):
        loss, grads = vg(params, js, *n)
        losses.append(float(loss))
        for k, g in params_from_flax(jax.tree.map(np.asarray, grads)).items():
            g = torch.as_tensor(g).abs()
            largest[k] = torch.maximum(largest.get(k, g), g)
            # each entry's least non-zero |g| over the updates
            g = torch.where(g > 0, g, torch.inf)
            least[k] = torch.minimum(least.get(k, g), g)
        finite = np.isfinite(float(loss)) and all(
            bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))
        if finite:
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        after.append(params_from_flax(jax.tree.map(np.asarray, params)))
    return losses, after, largest, least


def _tx(tr, n, eps):   # trajsde_tpu/train/optim.py's cosine_adamw at Adam's eps
    return optax.adamw(optax.cosine_decay_schedule(tr["lr"], tr["T_max"] * n, 0.0),
                       weight_decay=tr["weight_decay"], eps=eps, mask=jax_decay_mask)


def _port_chain(tm, cfg, scenes, noise, eps, n):
    """The port's chain of ``scenes`` on a copy of ``tm`` at Adam's ``eps``
    (the schedule sized for ``n`` updates): (model, state, step, logs)."""
    model = copy.deepcopy(tm)
    pinned = _Pinned(model, {id(s): x for s, x in zip(scenes, noise)})
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=n)
    for group in state.optimizer.param_groups:
        group["eps"] = eps
    chained = ChainedStep(pinned, state.optimizer, state.scheduler, build_losses(cfg), "cpu",
                          accum_steps=1)
    return model, state, chained, chained(scenes, 0, 0)


F32_BUILDS = {"BASELINE": lambda: _baseline(drop=0.0),
              "FLAGSHIP_CAPPED": lambda: _sde("float32", cap=CAP, drop=0.0)}


@pytest.fixture(scope="module", params=list(F32_BUILDS))
def jax_f32(request):
    """A build in JAX and the port, three batches with their pinned noise,
    and JAX's three updates at Adam's eps 1e-4 and at the configured eps."""
    cfg, n = F32_BUILDS[request.param](), 3
    baseline = request.param == "BASELINE"
    pairs = [scene_pair(s, B, A, L) for s in (61, 62, 63)]
    jm, params, tm = _model_pair(cfg, pairs[0][0])
    noises = [() if baseline else noise_for(cfg, B, A, seed=s) for s in (71, 72, 73)]
    vg = jax.jit(jax.value_and_grad(_jax_loss(jm, baseline)))
    js = [j for j, _ in pairs]
    tr = cfg["training_specific"]
    return dict(cfg=cfg, tm=tm, scenes=[s for _, s in pairs],
                noise=[tuple(t(a) for a in x) for x in noises] if not baseline else [],
                clean=_jax_updates(vg, params, _tx(tr, n, EPS), js, noises),
                configured=_jax_updates(vg, params, _tx(tr, n, CONFIGURED_EPS), js, noises))


def test_f32_chain_of_3_meets_three_sequential_jax_updates(jax_f32):
    jc = jax_f32
    model, state, chained, logs = _port_chain(jc["tm"], jc["cfg"], jc["scenes"], jc["noise"],
                                              EPS, 3)
    losses, after, _, _ = jc["clean"]
    np.testing.assert_allclose(chained.chain_logs[:, -2].tolist(), losses, rtol=2e-4)
    check_leaves({n: p.detach() for n, p in model.named_parameters()}, after[-1])
    assert logs["train/step_skipped"] == 0.0 and state.scheduler.last_epoch == 3


def test_f32_chain_of_3_meets_jax_at_the_configured_eps_outside_the_key_biases(jax_f32):
    """The key-bias entries by structure are where JAX's gradient is
    rounding noise (below NOISE_GRAD over the three updates; every other
    leaf's largest above it), and every other entry meets JAX by
    ``check_leaves``' bar (2e-3 x its leaf's scale + 1e-6), but where JAX's
    gradient is rounding noise at some update (0 < |g| < NOISE_GRAD): a
    gradient 0 in exact arithmetic at that update, which Adam at 1e-8 turns
    into a step of up to lr of either sign (on the capped flagship one
    aggregator entry at update 2, where the port reads -2.7e-8 and JAX
    4.1e-9; on the baseline none)."""
    jc = jax_f32
    model, _, chained, _ = _port_chain(jc["tm"], jc["cfg"], jc["scenes"], jc["noise"],
                                       CONFIGURED_EPS, 3)
    losses, after, largest, least = jc["configured"]
    np.testing.assert_allclose(chained.chain_logs[:, -2].tolist(), losses, rtol=2e-4)
    noise = noise_entries(dict(model.named_parameters()))
    on_noise, smallest, leaf = grad_split(largest, noise)
    assert 0.0 < on_noise < NOISE_GRAD <= smallest, (on_noise, smallest, leaf)
    parted = []
    for n, p in model.named_parameters():
        if noise.get(n) == slice(None):
            continue
        got, want = p.detach().double(), torch.as_tensor(after[-1][n]).double()
        scale = max(float(want.abs().max()), float(got.abs().max()), 1e-12)
        bad = (got - want).abs() > 2e-3 * scale + 1e-6
        if n in noise:
            bad[noise[n]] = False
        parted += [(n, i, float(least[n].flatten()[i])) for i in bad.flatten().nonzero()[:, 0]]
    assert all(g < NOISE_GRAD for _, _, g in parted), parted[:10]
    assert len(parted) <= 1, parted


@pytest.fixture(scope="module")
def jax_bf16():
    """``_tpu.yml``'s small form (dense AA, loop decoder, dropout 0) in JAX,
    compiled with excess precision off, and the port; two batches with
    pinned noise; JAX's two updates clean and with a NaN in batch 2."""
    cfg = _sde(drop=0.0)
    pairs = [scene_pair(s, B, A, L) for s in (64, 65)]
    jm, params, tm = _model_pair(cfg, pairs[0][0])
    noises = [noise_for(cfg, B, A, seed=s) for s in (74, 75)]
    js = [j for j, _ in pairs]
    vg = jit_exact(jax.value_and_grad(_jax_loss(jm, False)), params, js[0], *noises[0])
    tx = _tx(cfg["training_specific"], 2, BF16_EPS)
    bad = copy.deepcopy(pairs[1][1])
    bad.y[0, 0, 0, 0] = float("nan")
    js_bad = [js[0], js[1].replace(y=jnp.asarray(bad.y.numpy()))]
    return dict(cfg=cfg, tm=tm, scenes=[s for _, s in pairs], bad=bad,
                noise=[tuple(t(a) for a in x) for x in noises],
                start=params_from_flax(jax.tree.map(np.asarray, params)),
                clean=_jax_updates(vg, params, tx, js, noises),
                guarded=_jax_updates(vg, params, tx, js_bad, noises))


def _check_changes(model, start, want, noise):
    """The leaves the port trains, outside the key-bias entries: the whole
    change over the chain within CHANGE_L2 of JAX's in relative L2, and
    each leaf's within CHANGE_REL x its JAX change's scale + CHANGE_FLOOR x
    the largest leaf's.  Returns (the worst leaf's distance over its
    scale, the relative L2 distance)."""
    def change(after, n):
        d = torch.as_tensor(after).double() - torch.as_tensor(start[n]).double()
        if n in noise:
            d[noise[n]] = 0.0
        return d

    names = [n for n, p in model.named_parameters()
             if p.grad is not None and noise.get(n) != slice(None)]
    got = {n: change(p.detach(), n) for n, p in model.named_parameters() if n in names}
    ref = {n: change(want[n], n) for n in names}
    top = max(float(r.abs().max()) for r in ref.values())
    failures, worst, num, den = [], 0.0, 0.0, 0.0
    for n in names:
        scale, diff = float(ref[n].abs().max()), float((got[n] - ref[n]).abs().max())
        worst = max(worst, diff / max(scale, 1e-30))
        num += float(((got[n] - ref[n]) ** 2).sum())
        den += float((ref[n] ** 2).sum())
        if diff > CHANGE_REL * scale + CHANGE_FLOOR * top:
            failures.append((n, diff, scale))
    l2 = (num / den) ** 0.5
    assert not failures and l2 <= CHANGE_L2, (failures[:10], l2)
    return worst, l2


def _check_bf16_chain(model, chained, jc):
    losses, after, _, _ = jc["clean"]
    np.testing.assert_allclose(chained.chain_logs[0, -2].item(), losses[0], rtol=LOSS_RTOL_BF16)
    return _check_changes(model, jc["start"], after[-1],
                          noise_entries(dict(model.named_parameters())))


def test_bf16_chain_of_2_meets_jax_bf16_updates(jax_bf16):
    jc = jax_bf16
    model, _, chained, logs = _port_chain(jc["tm"], jc["cfg"], jc["scenes"], jc["noise"],
                                          BF16_EPS, 2)
    _check_bf16_chain(model, chained, jc)
    assert logs["train/step_skipped"] == 0.0


def test_bf16_chain_in_f32_fails_the_bf16_bar(jax_bf16):
    """The planted fault: the same weights and noise through the port in f32."""
    jc = jax_bf16
    f32 = torch_build_model(_sde("float32", drop=0.0), device="cpu")
    f32.load_state_dict(jc["tm"].state_dict())
    model, _, chained, _ = _port_chain(f32, jc["cfg"], jc["scenes"], jc["noise"], BF16_EPS, 2)
    with pytest.raises(AssertionError):
        _check_bf16_chain(model, chained, jc)
    with pytest.raises(AssertionError):   # and on the changes alone
        _check_changes(model, jc["start"], jc["clean"][1][-1],
                       noise_entries(dict(model.named_parameters())))


def test_a_nan_in_bf16_update_2_is_jax_guarded_update(jax_bf16):
    """Update 2 skipped: one skip, the schedule at 1, and the weights JAX's
    update 1 alone by the bf16 bar."""
    jc = jax_bf16
    scenes = [jc["scenes"][0], jc["bad"]]
    model, state, chained, logs = _port_chain(jc["tm"], jc["cfg"], scenes, jc["noise"],
                                              BF16_EPS, 2)
    assert logs["train/step_skipped"] == 1.0 and chained.chain_logs[:, -1].tolist() == [0.0, 1.0]
    assert state.scheduler.last_epoch == 1
    losses, after, _, _ = jc["guarded"]
    np.testing.assert_allclose(chained.chain_logs[0, -2].item(), losses[0], rtol=LOSS_RTOL_BF16)
    assert all(np.array_equal(after[0][n], after[1][n]) for n in after[0])
    _check_changes(model, jc["start"], after[-1], noise_entries(dict(model.named_parameters())))
