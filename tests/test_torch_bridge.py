"""Weight bridge, configuration and package boundary of the port."""
import ast
import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import trajsde_tpu_torch
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax

from _torch_helpers import ExperimentConfig, FLAGSHIP, jax_build_model, scene_pair, small_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(trajsde_tpu_torch.__file__)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("size", ["tiny", "shipped"])
def test_flax_torch_round_trip_is_exact(size):
    """The flax tree's structure (from ``eval_shape``, no compute) filled
    with random values -> state_dict -> flax again, leaf for leaf; the
    state_dict loads strictly into the port's model."""
    cfg = small_cfg() if size == "tiny" else FLAGSHIP
    js, _ = scene_pair(0, B=1, A=3, L=4)
    jm = jax_build_model(ExperimentConfig(cfg))
    shapes = jax.eval_shape(jm.init, {"params": jax.random.key(0), "sde": jax.random.key(1)}, js)
    r = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: r.standard_normal(s.shape).astype(np.float32), shapes)
    sd = params_from_flax(tree)
    model = tconfig.build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    back = params_to_flax(model.state_dict())
    want = dict(_flatten(tree["params"]))
    got = dict(_flatten(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def test_flagship_dict_equals_yaml():
    raw = tconfig.load_config(os.path.join(REPO, "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec.yml"))
    assert tconfig.FLAGSHIP == {k: raw[k] for k in tconfig.FLAGSHIP}
    assert {"training_specific", "losses_module", "loss_weights", "loss_args", "metrics_module",
            "metric_args"} <= set(tconfig.FLAGSHIP)
    train = copy.deepcopy(raw)
    train["decoder"]["kwargs"]["fused"] = True
    assert tconfig.FLAGSHIP_TRAIN == {k: train[k] for k in tconfig.FLAGSHIP_TRAIN}


def test_registry_aliases_filtering_and_guards():
    cfg = copy.deepcopy(FLAGSHIP)
    enc = tconfig.build(cfg["encoder"]["module_name"], dict(cfg["encoder"]["kwargs"], bogus=1))
    assert type(enc).__name__ == "LocalEncoderSDESep"
    kw = cfg["encoder"]["kwargs"]
    # the fused AA encoder builds; the JAX package's tiling knobs of its kernel are
    # dropped, ln_mm reaches it (it changes the chain's statistics in bf16)
    fused = tconfig.build("LocalEncoderSDESep", dict(kw, fused=True, rows_fwd=128, rows_bwd=24,
                                                     ln_mm=False))
    assert fused.aa_encoder.fused and fused.aa_encoder.ln_mm is False
    # and in bf16 (once refused): the pair chain computes in bf16 (K3b / K4b)
    fused16 = tconfig.build("LocalEncoderSDESep", dict(kw, fused=True, dtype="bfloat16"))
    assert fused16.aa_encoder.chain_dtype == "bfloat16" and fused16.aa_encoder.ln_mm
    # adaptive: true builds with the config's rtol / atol, and refuses explicit sde_noise
    adaptive = tconfig.build("LocalEncoderSDESep", dict(kw, adaptive=True))
    assert adaptive.sde_rnn.adaptive and (adaptive.sde_rnn.rtol, adaptive.sde_rnn.atol) == (
        kw["rtol"], kw["atol"])
    _, scene = scene_pair(0, B=1, A=3, L=4)
    Th, D = kw["historical_steps"], kw["embed_dim"]
    with pytest.raises(NotImplementedError, match="sde_noise"):
        adaptive(scene, sde_noise=torch.zeros(Th, 1, 4, D))
    for bad, err in [({"neighbor_cap": 24, "fused": True}, NotImplementedError),
                     ({"dtype": "float16"}, ValueError),
                     ({"ref_time": 10}, ValueError),
                     ({"method": "milstein"}, NotImplementedError)]:
        with pytest.raises(err):
            tconfig.build("LocalEncoderSDESep", dict(kw, **bad))
    # remat: true builds (the AA and AL calls rematerialize) with the plain keys
    remat = tconfig.build("LocalEncoderSDESep", dict(kw, remat=True))
    assert remat.remat and list(remat.state_dict()) == list(
        tconfig.build("LocalEncoderSDESep", kw).state_dict())
    # the fused training rollout builds; the JAX package's TPU knobs are dropped
    dec = tconfig.build("SDEDecoder", dict(cfg["decoder"]["kwargs"], fused=True, rollout_rows=512,
                                           rollout_unroll=3, scan_unroll=2, packed=True))
    assert dec.fused
    with pytest.raises(NotImplementedError, match="sde_layers=2"):
        tconfig.build("SDEDecoder", dict(cfg["decoder"]["kwargs"], fused=True, sde_layers=3))
    with pytest.raises(KeyError):
        tconfig.resolve("NoSuchModule")


def test_seeded_init_is_deterministic():
    a = tconfig.build_model(small_cfg(), device="cpu", seed=5).state_dict()
    b = tconfig.build_model(small_cfg(), device="cpu", seed=5).state_dict()
    c = tconfig.build_model(small_cfg(), device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.sde_rollout.f_func.dense0.weight"],
                           c["decoder.sde_rollout.f_func.dense0.weight"])


def _forbidden(name: str) -> bool:
    return name in ("jax", "flax", "trajsde_tpu") or name.startswith(
        ("jax.", "flax.", "trajsde_tpu."))


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, trajsde_tpu_torch\n"
        "for m in pkgutil.walk_packages(trajsde_tpu_torch.__path__, 'trajsde_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.split()
    assert "trajsde_tpu_torch.server" in out
    assert not [m for m in out if _forbidden(m)]


def test_port_sources_import_no_jax():
    bad = []
    for root, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad
