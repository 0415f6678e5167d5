"""The chained train step (``train_torch.py --chain C``) with the encoder's
two options, ``remat: true`` and ``adaptive: true``, on the CPU, where the
chained update runs uncaptured (on a card each update is one replay of its
CUDA graph; there a remat block's recompute draws from a replay state of
its own, ``models/remat.py`` ``ReplayTape``).

Each build at a small size (D 32, 4 heads, 2 scenes of 5 actors and 6
lanes), dropout and ``ts_drop`` live:

* remat on every build that trains with it (``chip_smoke.py``'s U10): the
  dense and fused flagship with the fused decoder (``FLAGSHIP_TRAIN``,
  ``FLAGSHIP_TRAIN_FUSED``: the plain K1-K4 here), the HiVT baseline dense
  and fused, and the bf16 recipe dense and fused (plain K3b / K4b): a chain
  of 2 against 2 eager steps bit for bit; the remat chain bit for bit the
  plain chain of the same build (``tests/test_torch_remat.py``'s identity,
  across a chain); each AA and AL block run twice an update (forward and
  recompute);
* adaptive (U11): ``FLAGSHIP_H100`` (both fused paths),
  ``FLAGSHIP_TRAIN`` (dense AA) and one build with remat as well: a chain
  of 2 against 2 eager steps bit for bit;
* where a fused decoder is in the build, the chain within the card's bar
  (``optim.chain_eager_gap``), which an unchanged state and a chain of the
  wrong sign fail;
* against JAX, adaptive: a chain of 2 against two sequential
  ``jax.value_and_grad`` + optax updates with JAX's tree nodes pinned in
  the port (``sde_nodes``), at ``tests/test_torch_adaptive_encoder.py``'s
  gradient bars (loss rtol 1e-5, every leaf 2e-3 x scale + 1e-6).  Its JAX
  compile takes about 40 s, so it is ``slow``.  Remat against JAX is
  ``tests/test_torch_chain.py``'s chain of 3, parametrized over remat.
"""
import copy
import functools

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from trajsde_tpu import losses as jlosses
from trajsde_tpu.train.optim import decay_mask as jax_decay_mask
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import build_dtype, build_losses
from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state, make_train_step
from trajsde_tpu_torch.train.optim import chain_eager_bound, chain_eager_gap

from _torch_helpers import (bf16_cfg, capture_adaptive_nodes, check_leaves, model_pair,
                            noise_for, scene_pair, small_baseline_cfg, small_cfg, t,
                            torch_build_model)

torch.set_num_threads(1)
B, A, L = 2, 5, 6
D, H, K = 32, 4, 3
TRAINING = {"lr": 0.003, "weight_decay": 0.01, "T_max": 1, "nodecay": True}


def _sde(dtype="float32", fused=False, dec_fused=True, drop=0.1, **enc):
    cfg = small_cfg(D=D, H=H, Tf=60, K=K)
    cfg["encoder"]["kwargs"].update(dropout=drop, fused=fused, **enc)
    cfg["aggregator"]["kwargs"]["dropout"] = drop
    cfg["decoder"]["kwargs"]["fused"] = dec_fused
    cfg["training_specific"].update(TRAINING)
    return bf16_cfg(cfg) if dtype == "bfloat16" else cfg


def _baseline(fused=False):
    cfg = small_baseline_cfg(D=D, H=H, Tf=60, K=K, drop=0.1, fused=fused)
    cfg["encoder"]["kwargs"]["remat"] = True
    cfg["training_specific"].update(TRAINING)
    return cfg


# the small form of each build with encoder.remat: true (the bf16 recipes as
# written, with the scan decoder)
REMAT = {
    "FLAGSHIP_TRAIN": lambda: _sde(remat=True),
    "FLAGSHIP_TRAIN_FUSED": lambda: _sde(fused=True, remat=True),
    "BASELINE": lambda: _baseline(),
    "BASELINE_TRAIN": lambda: _baseline(fused=True),
    "FLAGSHIP_BF16": lambda: _sde("bfloat16", dec_fused=False, remat=True),
    "FLAGSHIP_BF16_FUSED": lambda: _sde("bfloat16", fused=True, dec_fused=False, remat=True),
}
# ... and with encoder.adaptive: true
ADAPTIVE = {
    "FLAGSHIP_H100": lambda: _sde(fused=True, adaptive=True),
    "FLAGSHIP_TRAIN": lambda: _sde(adaptive=True),
    "FLAGSHIP_TRAIN_FUSED+remat": lambda: _sde(fused=True, adaptive=True, remat=True),
}
BUILDS = {"remat": REMAT, "adaptive": ADAPTIVE}
CASES = [(kind, name) for kind, builds in BUILDS.items() for name in builds]


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


def _calls(model: nn.Module) -> dict:
    """Count the forwards of the encoder's AA and AL blocks (pre-hooks)."""
    calls = {"aa_encoder": 0, "al_encoder": 0}
    for name in calls:
        def hook(module, args, name=name):
            calls[name] += 1
        getattr(model.encoder, name).register_forward_pre_hook(hook)
    return calls


@functools.lru_cache(maxsize=None)
def _run(kind: str, name: str) -> dict:
    """Build ``name`` once (seed 5) and train copies of it from one state on
    2 scenes (seed 9, steps 4 and 5, ts_drop 0.2): 2 eager steps, a chain of
    2 and, for a remat build, a chain of 2 of the same weights with remat
    off; each chained model's block calls."""
    cfg = BUILDS[kind][name]()
    base = torch_build_model(cfg, device="cpu", seed=5)
    assert base.encoder.remat == bool(cfg["encoder"]["kwargs"].get("remat"))
    assert getattr(base.encoder, "adaptive", False) == (kind == "adaptive")
    scenes = [scene_pair(s, B, A, L)[1] for s in (81, 82)]
    models = {"eager": copy.deepcopy(base), "chained": copy.deepcopy(base)}
    if kind == "remat":
        models["plain"] = copy.deepcopy(base)
        models["plain"].encoder.remat = False
    states = {k: create_train_state(m, cfg["training_specific"], steps_per_epoch=2, seed=9)
              for k, m in models.items()}
    losses = build_losses(cfg)
    s = states["eager"]
    eager = make_train_step(s.model, s.optimizer, s.scheduler, losses, "cpu", ts_drop_rate=0.2)
    eager_logs = [eager(x, 4 + k, 9) for k, x in enumerate(scenes)]
    chain_logs, calls = {}, {}
    for k in states.keys() - {"eager"}:
        s = states[k]
        calls[k] = _calls(s.model)
        chained = ChainedStep(s.model, s.optimizer, s.scheduler, losses, "cpu",
                              ts_drop_rate=0.2, accum_steps=1)
        logs = chained(scenes, 4, 9)
        assert logs["train/step_skipped"] == 0.0 and logs["scenes"] == 2 * B
        chain_logs[k] = chained.chain_logs
    want = torch.stack([torch.stack([*(l[n] for n in chained.names),
                                     torch.tensor(l["train/step_skipped"])]) for l in eager_logs])
    return dict(cfg=cfg, base=base, states=states, eager_logs=want, chain_logs=chain_logs,
                calls=calls)


@pytest.mark.parametrize("kind,name", CASES)
def test_chain_of_2_is_two_eager_steps_bit_for_bit(kind, name):
    """The chained updates give the eager steps' weights, moments, schedule
    and logs bit for bit, dropout, ts_drop and the tree nodes drawn from the
    chain's generators."""
    r = _run(kind, name)
    assert _states_equal(r["states"]["chained"], r["states"]["eager"])
    torch.testing.assert_close(r["chain_logs"]["chained"], r["eager_logs"], rtol=0, atol=0)
    assert all(p.dtype == torch.float32 for p in r["states"]["chained"].model.parameters())


@pytest.mark.parametrize("name", list(REMAT))
def test_remat_chain_is_the_plain_chain_bit_for_bit(name):
    r = _run("remat", name)
    assert _states_equal(r["states"]["chained"], r["states"]["plain"])
    torch.testing.assert_close(r["chain_logs"]["chained"], r["chain_logs"]["plain"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", list(REMAT) + ["FLAGSHIP_TRAIN_FUSED+remat"])
def test_remat_chain_runs_each_block_again_in_the_backward(name):
    """Forward and recompute: each AA and AL block twice an update under
    remat, once without."""
    r = _run("remat" if name in REMAT else "adaptive", name)
    assert r["calls"]["chained"] == {"aa_encoder": 4, "al_encoder": 4}
    if "plain" in r["calls"]:
        assert r["calls"]["plain"] == {"aa_encoder": 2, "al_encoder": 2}


FUSED_DECODER = [(kind, name) for kind, name in CASES
                 if BUILDS[kind][name]()["decoder"]["kwargs"].get("fused")]


@pytest.mark.parametrize("kind,name", FUSED_DECODER)
def test_chain_meets_the_cards_bar_which_a_still_or_reversed_chain_fails(kind, name):
    """The card's bar in the build's measure (``chain_eager_gap`` against
    ``chain_eager_bound``): the CPU's chain reads 0; a chain that left every
    weight where it started, or stepped each the other way, fails it."""
    r = _run(kind, name)
    dtype = build_dtype(r["cfg"])
    bound = chain_eager_bound(r["cfg"]["training_specific"]["lr"], 2, dtype)
    start, after = r["base"].state_dict(), r["states"]["eager"].model.state_dict()
    got = r["states"]["chained"].model.state_dict()
    assert chain_eager_gap(got, after, start, dtype)[0] == 0.0
    assert chain_eager_gap(start, after, start, dtype)[0] > bound
    flipped = {k: 2 * v - after[k] for k, v in start.items()}
    assert chain_eager_gap(flipped, after, start, dtype)[0] > bound


# ---------------------------------------------------------------------------
# adaptive against JAX
# ---------------------------------------------------------------------------
class _Pinned(nn.Module):
    """The model with each scene's twin noise, tree nodes and decoder noise
    pinned (looked up by the scene object), called as the train steps call
    a model; the forward of ``PredictionModelSDENet`` with ``sde_nodes``."""

    def __init__(self, model, noise):
        super().__init__()
        self.model, self.noise = model, noise

    def forward(self, scene, generator=None, rollout_seed=None):
        m = self.model
        tw, nodes, de = self.noise[id(scene)]
        local, d_in, d_out, l_in, l_out = m.encoder(scene, twin_noise=tw, sde_nodes=nodes)
        glob = m.aggregator(scene, local)
        out = m.decoder(scene, local, glob, sde_noise=de)
        out["y"] = m.rotated_y(scene)
        out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
        return out


@pytest.mark.slow
def test_adaptive_chain_of_2_meets_two_sequential_jax_updates():
    """The adaptive flagship (loop decoder, dropout 0): a chain of 2 against
    two ``value_and_grad`` + optax AdamW / cosine updates (Adam's eps 1e-4
    on both sides, as ``tests/test_torch_chain.py``), JAX's tree nodes of
    each update recorded in its program and pinned in the port: each
    update's loss within rtol 1e-5 and every leaf after the chain within
    2e-3 x scale + 1e-6."""
    cfg = _sde(dec_fused=False, drop=0.0, adaptive=True)
    pairs = [scene_pair(s, B, A, L) for s in (61, 62)]
    jm, params, tm = model_pair(cfg, pairs[0][0])
    tr = cfg["training_specific"]
    tx = optax.adamw(optax.cosine_decay_schedule(tr["lr"], tr["T_max"] * 2, 0.0),
                     weight_decay=tr["weight_decay"], eps=1e-4, mask=jax_decay_mask)

    def jax_loss(p, js, tw, de, key):
        def fwd(m, scene):
            local, d_in, d_out, l_in, l_out = m.encoder(scene, True, None, tw)
            glob = m.aggregator(scene, local, True)
            out = m.decoder(scene, local, glob, True, de)
            out.update(diff_in=d_in, diff_out=d_out, label_in=l_in, label_out=l_out)
            return out, m._rotated_y(scene)

        out, y = jm.apply(p, js, method=fwd, rngs={"sde": key})
        return jlosses.l2_loss(y, out) + jlosses.diff_bce_loss(y, out)

    vg = jax.jit(jax.value_and_grad(jax_loss))
    opt_state, losses, pinned = tx.init(params), [], {}
    with capture_adaptive_nodes() as rec:
        for k, (js, ts) in enumerate(pairs):
            _, tw, de = noise_for(cfg, B, A, seed=71 + k)
            rec.records.clear()
            loss, grads = vg(params, js, tw, de, jax.random.key(20 + k))
            grads = jax.tree.map(np.asarray, grads)
            (nodes,) = rec.stacked()
            assert nodes.shape == (21, 256, B, A + 1, D)
            pinned[id(ts)] = (t(tw), t(nodes), t(de))
            losses.append(float(loss))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)

    model = copy.deepcopy(tm)
    state = create_train_state(model, tr, steps_per_epoch=2)
    for group in state.optimizer.param_groups:
        group["eps"] = 1e-4
    chained = ChainedStep(_Pinned(model, pinned), state.optimizer, state.scheduler,
                          build_losses(cfg), "cpu", accum_steps=1)
    logs = chained([ts for _, ts in pairs], 0, 0)
    np.testing.assert_allclose(chained.chain_logs[:, -2].tolist(), losses, rtol=1e-5)
    assert logs["train/step_skipped"] == 0.0 and state.scheduler.last_epoch == 2
    check_leaves({n: p.detach() for n, p in model.named_parameters()},
                 params_from_flax(jax.tree.map(np.asarray, params)))
