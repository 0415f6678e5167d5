"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
scene, weights and noise go through the JAX package and the PyTorch port."""
from __future__ import annotations

import contextlib
import copy
import json

import jax
import numpy as np
import torch

from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
from trajsde_tpu.data.synthetic import make_scene_batch as jax_make_scene_batch
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.config import BASELINE, FLAGSHIP, build_model as torch_build_model
from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.ops.aa_fused import W_ORDER

SCENE_FIELDS = ("x", "y", "positions", "padding_mask", "bos_mask", "rotate_angles",
                "actor_valid", "agent_index", "av_index", "source", "lane_positions",
                "lane_paddings", "lane_valid")


def small_cfg(D=16, H=2, Tf=12, K=3):
    """The flagship config at another width / horizon / mode count."""
    cfg = copy.deepcopy(FLAGSHIP)
    cfg["encoder"]["kwargs"].update(embed_dim=D, num_heads=H)
    cfg["aggregator"]["kwargs"].update(embed_dim=D, num_heads=H, num_modes=K)
    cfg["decoder"]["kwargs"].update(local_channels=D, global_channels=D, num_modes=K,
                                    future_steps=Tf, max_fut_t=Tf / 10)
    return cfg


def small_baseline_cfg(D=32, H=2, layers=2, Tf=12, K=3, drop=0.1, fused=False):
    """The HiVT baseline config at another width / depth / horizon / mode
    count, its AA pair chain dense or fused (K3 / K4)."""
    cfg = copy.deepcopy(BASELINE)
    cfg["encoder"]["kwargs"].update(embed_dim=D, num_heads=H, num_temporal_layers=layers,
                                    dropout=drop, fused=fused)
    cfg["aggregator"]["kwargs"].update(embed_dim=D, num_heads=H, num_modes=K, dropout=drop)
    cfg["decoder"]["kwargs"].update(local_channels=D, global_channels=D, num_modes=K,
                                    future_steps=Tf)
    return cfg


def scene_pair(seed, B=2, A=5, L=6, sources=(0, 1)):
    """A JAX ``SceneBatch`` and the port's copy of the same arrays."""
    js = jax_make_scene_batch(np.random.default_rng(seed), batch_size=B, num_actors=A,
                              num_lanes=L, sources=list(sources))
    ts = SceneBatch.from_numpy(**{f: np.asarray(getattr(js, f)) for f in SCENE_FIELDS})
    return js, ts


def model_pair(cfg, js, seed=0):
    """(JAX model, its params, port model on the CPU with the same weights)."""
    jm = jax_build_model(ExperimentConfig(cfg))
    params = jax.jit(jm.init)({"params": jax.random.key(seed), "sde": jax.random.key(1)}, js)
    tm = torch_build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def noise_for(cfg, B, A, seed=3):
    """Unit normals: encoder [Th, B, A+1, D], twin [B, 1, Th, 2],
    decoder [Tf, B, K, A, D] (float32 numpy)."""
    enc, dec = cfg["encoder"]["kwargs"], cfg["decoder"]["kwargs"]
    Th, D, Tf, K = enc["historical_steps"], enc["embed_dim"], dec["future_steps"], dec["num_modes"]
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(Th, B, A + 1, D), f(B, 1, Th, 2), f(Tf, B, K, A, D)


def jax_forward(jm, params, js, enc_noise, twin_noise, dec_noise):
    """The JAX model's forward with every draw pinned."""
    def fwd(m, scene):
        local, d_in, d_out, _, _ = m.encoder(scene, True, enc_noise, twin_noise)
        glob = m.aggregator(scene, local, True)
        out = m.decoder(scene, local, glob, True, dec_noise)
        out["y"] = m._rotated_y(scene)
        out["diff_in"], out["diff_out"] = d_in, d_out
        return out

    out = jm.apply(params, js, method=fwd)
    return {k: np.asarray(v) for k, v in out.items()}


def t(a):
    return torch.from_numpy(np.array(a))


def check_leaves(got, want):
    """Every gradient leaf: max|diff| <= 2e-3 * leaf scale + 1e-6
    (``tests/test_reference_grad_parity.py``'s criterion).  A leaf the loss
    does not reach (the pi head under L2 + DiffBCE) has no torch grad; JAX
    gives it zeros."""
    failures = []
    for name, w in want.items():
        w = w.numpy().astype(np.float64)
        g = np.zeros_like(w) if got[name] is None else got[name].numpy().astype(np.float64)
        scale = max(np.abs(w).max(), np.abs(g).max(), 1e-12)
        diff = np.abs(g - w).max()
        if diff > 2e-3 * scale + 1e-6:
            failures.append((name, float(diff), float(scale)))
    assert not failures, failures[:10]


def packed_aa_weights(r: np.random.Generator, dense: bool, D: int = 64):
    """The 14 packed AA pair-chain weights (``W_ORDER``) at width D, from
    ``r``: matrices N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.04), other
    vectors N(0, 0.04).  ``dense=False`` keeps the model's block-diagonal wu
    and w1 (two branches); ``dense=True`` fills their off-diagonal blocks."""
    shapes = dict(wu=(4, 2 * D), bu=(1, 2 * D), ln0s=(1, 2 * D), ln0b=(1, 2 * D),
                  w1=(2 * D, 2 * D), b1=(1, 2 * D), lna0s=(1, D), lna0b=(1, D), wagg=(D, D),
                  bagg=(1, D), lna1s=(1, D), lna1b=(1, D), wkv=(D, 2 * D), bkv=(1, 2 * D))
    ws = {}
    for k, s in shapes.items():
        if k[0] == "w":
            x = r.standard_normal(s) / np.sqrt(s[0] if k != "wu" else 2)
            if not dense and k in ("wu", "w1"):
                half = s[0] // 2
                x[:half, D:] = 0.0
                x[half:, :D] = 0.0
        else:
            x = (1.0 if k.endswith("s") and k.startswith("ln") else 0.0) \
                + 0.2 * r.standard_normal(s)
        ws[k] = torch.from_numpy(x.astype(np.float32))
    return tuple(ws[k] for k in W_ORDER)


def kernel_head_logits(qh: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``aa_fused._head_logits`` in K3's order (``aa_common.cuh``'s
    ``head_logit``, which K4's recompute shares): per lane of 4 columns
    q0 k0 rounded, then three FMAs (each exact in f64, then rounded once to
    f32), the lanes of a head summed pairwise in f32 by the butterfly (2
    lanes at 8 heads; (l0 + l1) + (l2 + l3) at 4), times 1/sqrt(hd)."""
    R, Ak, H, hd = k.shape
    q4 = qh.expand_as(k).reshape(R, Ak, H, hd // 4, 4).double()
    k4 = k.reshape(R, Ak, H, hd // 4, 4).double()
    part = (q4[..., 0] * k4[..., 0]).float()
    for c in range(1, 4):
        part = (q4[..., c] * k4[..., c] + part.double()).float()
    while part.shape[-1] > 1:   # xor 1, then xor 2
        part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0] * (1.0 / hd ** 0.5)


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the body on at most ``n`` intra-op threads: the emulated
    tensor-core products are large f64 element-wise passes that slow to a
    crawl when several test workers each run them on every core."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(n, old))
    try:
        yield
    finally:
        torch.set_num_threads(old)


def write_run(tmp_path, n_train=6, batch=4, actors=6, lanes=8):
    """npz scenes of both sources (train) and nuScenes (val), written from
    the port's synthetic scenes under ``tmp_path``, and a JSON config of the
    small flagship (both fused paths, their plain versions on the CPU) over
    them at ``batch``; returns the config's path."""
    rng = np.random.default_rng(0)
    root = tmp_path / "scenes"
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        for split, n in (("train", n_train), ("val", 4 if src == 0 else 0)):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(n):
                raw = make_raw_scene(rng, src, num_actors=int(rng.integers(3, actors + 1)),
                                     num_lanes=int(rng.integers(4, lanes + 1)))
                np.savez(d / f"scene_{i:06d}.npz", **raw)
    cfg = small_cfg(Tf=60)
    for sec in ("encoder", "decoder"):
        cfg[sec]["kwargs"]["fused"] = True
    cfg["datamodule_specific"]["kwargs"].update(
        train_batch_size=batch, val_batch_size=batch, num_actors=actors, num_lanes=lanes,
        num_workers=1, nu_dir=str(root / "nuScenes"), Argo_dir=str(root / "Argoverse"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


# ---------------------------------------------------------------------------
# bf16 mixed precision (``dtype: bfloat16``)
# ---------------------------------------------------------------------------
def bf16_cfg(cfg):
    """``cfg`` with ``dtype: bfloat16`` on the encoder, the aggregator and the
    decoder, as ``configs/nusargo/*_tpu.yml`` set it."""
    cfg = copy.deepcopy(cfg)
    for sec in ("encoder", "aggregator", "decoder"):
        cfg[sec]["kwargs"]["dtype"] = "bfloat16"
    return cfg


def jit_exact(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's excess precision off.
    On the CPU XLA may otherwise keep a bf16 intermediate in f32 inside a
    fusion (an ``exp`` before a division, a tanh before a product), so the
    program flax writes, each op rounded to its dtype, is what the port is
    held to."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def bf16_distance(got, want):
    """(max|got - want| / max|want|, mean|got - want| / mean|want|), in f64."""
    g = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want, np.float32).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    d = np.abs(g - w)
    return float(d.max() / max(np.abs(w).max(), 1e-30)), \
        float(d.mean() / max(np.abs(w).mean(), 1e-30))


def check_bf16(got, want, bar, what=""):
    """Hold ``got`` to ``want`` within ``bar = (max_rel, mean_rel)`` (see
    :func:`bf16_distance`); returns the two distances."""
    dist = bf16_distance(got, want)
    assert dist[0] <= bar[0] and dist[1] <= bar[1], f"{what}: {dist} past {bar}"
    return dist


def check_grads_bf16(got, want, leaf_rel, floor, l2_rel):
    """bf16 gradient leaves: each within ``leaf_rel`` x its leaf's scale plus
    ``floor`` x the largest leaf's scale (a leaf whose true gradient is 0,
    such as a key bias under a softmax, is bf16 noise), and the whole
    gradient within ``l2_rel`` in relative L2.  Returns (the worst leaf's
    distance over its scale, the relative L2 distance)."""
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    failures, worst, num, den = [], 0.0, 0.0, 0.0
    for name, w in want.items():
        w = w.numpy().astype(np.float64)
        g = np.zeros_like(w) if got[name] is None else got[name].numpy().astype(np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        diff = np.abs(g - w).max()
        worst = max(worst, diff / scale)
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
        if diff > leaf_rel * scale + floor * top:
            failures.append((name, float(diff), float(scale)))
    l2 = (num / den) ** 0.5
    assert not failures and l2 <= l2_rel, (failures[:10], l2)
    return worst, l2


# ---------------------------------------------------------------------------
# the adaptive solver's noise (``adaptive: true``)
# ---------------------------------------------------------------------------
def tree_nodes(key, shape, depth):
    """The node normals JAX's ``BrownianTree(key, ..., shape, depth=depth)``
    draws, node c = 1 .. 2**depth at row c - 1: ``normal(fold_in(key, c))``
    in f32 (a JAX array)."""
    import jax.numpy as jnp

    counters = jnp.arange(1, 2 ** depth + 1)
    return jax.vmap(lambda c: jax.random.normal(jax.random.fold_in(key, c), tuple(shape),
                                                jnp.float32))(counters)


class AdaptiveNodes:
    """Records the tree nodes of every ``sdeint_adaptive`` call the JAX
    package makes while installed (:func:`capture_adaptive_nodes`): the
    wrapper draws them from the call's key with :func:`tree_nodes` and sends
    them out through ``jax.debug.callback``, tagged by the trace that made
    the call (one per ``nn.scan`` of the encoder) and the segment's start."""

    def __init__(self):
        self.records = {}
        self.traces = 0

    def wrap(self, original):
        def sdeint_adaptive(f, g, y0, ts, key, **kw):
            tag = self.traces
            self.traces += 1
            nodes = tree_nodes(key, y0.shape, kw.get("depth", 12))

            def record(n, t0):
                self.records[(tag, float(t0))] = np.asarray(n)

            jax.debug.callback(record, nodes, ts[0])
            return original(f, g, y0, ts, key, **kw)

        return sdeint_adaptive

    def stacked(self):
        """The nodes of every recorded call in (trace, start) order, one
        trace's calls (the segments of one ODE-RNN run) per entry:
        ``[[Th, 2**depth, ...], ...]``."""
        tags = sorted({tag for tag, _ in self.records})
        return [np.stack([self.records[k] for k in sorted(self.records) if k[0] == tag])
                for tag in tags]


@contextlib.contextmanager
def capture_adaptive_nodes():
    """Patch ``trajsde_tpu.ops.sdeint.sdeint_adaptive`` (the JAX step
    imports it at call time) with a recording wrapper; yields the
    :class:`AdaptiveNodes`."""
    import trajsde_tpu.ops.sdeint as jax_sdeint

    rec = AdaptiveNodes()
    original = jax_sdeint.sdeint_adaptive
    jax_sdeint.sdeint_adaptive = rec.wrap(original)
    try:
        yield rec
    finally:
        jax_sdeint.sdeint_adaptive = original
