"""bf16 mixed precision (``dtype: bfloat16``) in the port's dense modules vs
the JAX package's on the CPU, one case per module, and the configs that
use it.

Parameters stay f32 in both packages; the modules compute in bf16.  flax's
``nn.Dense`` rounds its product and then adds the bias in bf16 (two
roundings), and the port's ``Linear`` mirrors that rather than rounding
once as ``F.linear`` does; LayerNorm's f32 steps, the sigmoid, the
softmax and the weakly typed constants (``sqrt(head_dim)``, dropout's
``1 - rate``) follow flax's steps too.  The JAX side is compiled with XLA's
excess precision off (``jit_exact``), so each of its ops rounds to bf16 as
flax writes it.

The bf16 bar of a module, ``MODULE_BAR``: max|port - JAX| <= 8e-3 of
max|JAX| (two bf16 ulps) and mean|port - JAX| <= 5e-4 of mean|JAX|.  Most
modules meet it bit for bit; the worst, the temporal encoder, sits at
(2.7e-3, 1.1e-4), where a sum in another order lands one bf16 rounding on
the other side.  Each case is also run with the port in f32 on the same
weights and inputs, which must fail the bar: that planted fault shows the
bf16 path is the one held to JAX's bf16 output (f32 sits about half a bf16
ulp off everywhere: a mean of 1.7e-3 to 1.1e-2).
"""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.models import aggregator as jagg, decoders as jdec, embedding as jemb
from trajsde_tpu.models import layers as jlayers, local_encoder as jloc, sde as jsde
from trajsde_tpu_torch import config as tconfig
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.models import aggregator as tagg, decoders as tdec, embedding as temb
from trajsde_tpu_torch.models import graph as tgraph, layers as tlayers, local_encoder as tloc
from trajsde_tpu_torch.models import sde as tsde
from trajsde_tpu_torch.models.sde_encoder import LocalEncoderSDESep

from _torch_helpers import (FLAGSHIP, bf16_cfg, bf16_distance, check_bf16, jit_exact,
                            model_pair, scene_pair, small_cfg, t, torch_build_model)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_BAR = (8e-3, 5e-4)
BF = jnp.bfloat16
D, H, T, A, L = 32, 4, 4, 5, 6     # head_dim 8, the shipped model's; T steps of a sequence


def _r(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _bf(a):
    """f32 numpy values that are bf16 numbers: what a bf16 activation holds."""
    return np.asarray(jnp.asarray(a).astype(BF).astype(jnp.float32))


class Act:
    """A bf16 activation input: bf16 for JAX and the bf16 port, its exact
    values in f32 for the port in f32."""

    def __init__(self, a):
        self.a = _bf(a)


def _jax_arg(a):
    return jnp.asarray(a.a).astype(BF) if isinstance(a, Act) else jnp.asarray(a)


def _port_arg(a, bf16):
    if isinstance(a, Act):
        x = t(a.a)
        return x.bfloat16() if bf16 else x
    return t(a) if isinstance(a, np.ndarray) else a


def _perturbed(params, seed):
    """The flax init plus N(0, 0.1) on every leaf, so biases and LayerNorm
    scales are not 0 / 1 and the bias rounding shows."""
    leaves, tree = jax.tree.flatten(params)
    r = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [np.asarray(x) + 0.1 * r.standard_normal(x.shape).astype(
        np.float32) for x in leaves])


def _scene_aa_inputs(seed=3, B=2):
    """AAEncoder inputs from a synthetic scene (the baseline's call)."""
    _, ts = scene_pair(seed, B, A, L)
    x_t = ts.x.permute(0, 2, 1, 3)
    return ts, [x_t.numpy(), x_t.numpy(), ts.rotate_mat().numpy(), ts.bos_mask.numpy(),
                tgraph.aa_masks(ts, 50.0).numpy(), tgraph.aa_edge_vectors(ts).numpy()]


# ---------------------------------------------------------------------------
# cases: (JAX module, JAX call args, port constructor of a dtype, port call
# args, how to read the outputs)
# ---------------------------------------------------------------------------
def _mask(seed, shape):
    m = np.random.default_rng(seed).uniform(size=shape) < 0.6
    m[..., 0, :] = False  # one receiver with no incoming edge
    return m


def case_masked_softmax():
    logits, mask = Act(_r(0, 3, 4, 6, scale=3)), _mask(1, (3, 4, 6))
    return (None, [logits, mask], None, lambda f, a: f(*a))


def case_single_embedding():
    x = _r(0, 2, 5, 2, scale=3)
    return (jemb.SingleInputEmbedding(D, dtype=BF), [x],
            lambda dt: temb.SingleInputEmbedding(2, D, dtype=dt), None)


def case_multiple_embedding():
    x0, x1 = _r(0, 2, 5, 6, 2, scale=3), _r(1, 2, 5, 6, 2, scale=20)
    return (jemb.MultipleInputEmbedding(D, dtype=BF), [[x0, x1]],
            lambda dt: temb.MultipleInputEmbedding([2, 2], D, dtype=dt), None)


def case_mlp_block():
    return (jlayers.MlpBlock(D, 0.0, dtype=BF), [Act(_r(0, 2, 5, D))],
            lambda dt: tlayers.MlpBlock(D, 0.0, dtype=dt), None)


def case_edge_attention_pair():
    c, kv, mask = Act(_r(0, 2, 5, D)), Act(_r(1, 2, 5, 7, D)), _mask(2, (2, 5, 7))
    return (jlayers.EdgeAttention(D, H, 0.0, dtype=BF), [c, mask, kv],
            lambda dt: tlayers.EdgeAttention(D, H, dtype=dt), None)


def case_edge_attention_node_edge():
    c, e, mask = Act(_r(0, 2, 5, D)), Act(_r(1, 2, 5, 5, D)), _mask(2, (2, 5, 5))
    return (jlayers.EdgeAttention(D, H, 0.0, dtype=BF), [c, mask, None, c, e],
            lambda dt: tlayers.EdgeAttention(D, H, edge_stream=True, dtype=dt),
            lambda m, a: m(a[0], a[1], kv_node=a[3], kv_edge=a[4]))


def _causal(S):
    """The temporal encoder's additive causal mask in bf16 (``finfo.min``)."""
    return np.where(np.tril(np.ones((S, S), bool)), 0.0,
                    float(jnp.finfo(BF).min)).astype(np.float32)[None]


def case_multihead_self_attention():
    x = Act(_r(0, 2, 5, T + 1, D))
    mask = Act(_causal(T + 1))
    return (jlayers.MultiheadSelfAttention(D, H, 0.0, dtype=BF), [x, mask],
            lambda dt: tlayers.MultiheadSelfAttention(D, H, dtype=dt), None)


def case_gru_unit():
    h, x, m = Act(_r(0, 6, D)), Act(_r(1, 6, D)), np.array([1, 1, 0, 1, 0, 1], bool)
    return (jlayers.GRUUnit(D, D, dtype=BF), [h, x, m],
            lambda dt: tlayers.GRUUnit(D, D, dtype=dt), None)


def case_ffunc():
    return (jsde.FFunc(D, 2, dtype=BF), [np.float32(0.7), Act(_r(0, 6, D))],
            lambda dt: tsde.FFunc(D, 2, dtype=dt),
            lambda m, a: m(torch.tensor(0.7), a[1]))


def case_gfunc():
    return (jsde.GFunc(D, 2, dtype=BF), [np.float32(0.7), Act(_r(0, 6, D))],
            lambda dt: tsde.GFunc(D, 2, dtype=dt),
            lambda m, a: m(torch.tensor(0.7), a[1]))


def case_sde_step():
    """One decoder Euler step: dt 0.1 and its sqrt in bf16, eps cast."""
    y, eps = Act(_r(0, 6, D)), _r(1, 6, D)
    return (jsde.SDEStep(D, 2, dtype=BF), [y, (np.float32(0.3), np.float32(0.1), eps)],
            lambda dt: tsde.SDEStep(D, 2, dtype=dt),
            lambda m, a: m(a[0], torch.tensor(0.3), torch.tensor(0.1), t(eps)))


def case_sde_gru_step():
    """One ODE-RNN step (packed in JAX, one MLP at a time in the port): the
    state and the diffusion tap."""
    h, obs, eps = Act(_r(0, 6, D)), Act(_r(1, 6, D)), _r(2, 6, D)
    nus, obs_mask = np.array([1, 0, 1, 0, 1, 1], bool), np.array([1, 1, 0, 1, 1, 0], bool)
    args = [(h, nus), (obs, obs_mask, np.float32(-0.01), np.float32(0.01), eps)]
    return (jsde.SDEGRUStep(D, 2, dtype=BF), args,
            lambda dt: tsde.SDEGRUStep(D, 2, dtype=dt),
            lambda m, a: m(a[0][0], t(nus), a[1][0], t(obs_mask), torch.tensor(-0.01),
                           torch.tensor(0.01), t(eps)))


def _aa_case(cap):
    _, inputs = _scene_aa_inputs()
    Th = inputs[0].shape[1]
    if cap:   # a cap below the largest in-radius degree, so edges drop
        cap = max(1, int(inputs[4].sum(-1).max()) - 1)
    return (jloc.AAEncoder(Th, D, H, 0.0, dtype=BF, neighbor_cap=cap), inputs,
            lambda dt: tloc.AAEncoder(Th, D, H, neighbor_cap=cap, dtype=dt), None)


def case_aa_encoder_dense():
    return _aa_case(0)


def case_aa_encoder_capped():
    return _aa_case(1)


def case_al_encoder():
    ts, _ = _scene_aa_inputs()
    al_mask, al_vec = tgraph.al_edges(ts, ts.x.shape[2] - 1, 50.0)
    args = [Act(_r(0, 2, A, D)), tgraph.lane_features(ts).numpy(), al_vec.numpy(),
            al_mask.numpy(), ts.rotate_mat().numpy()]
    return (jloc.ALEncoder(D, H, 0.0, dtype=BF), args,
            lambda dt: tloc.ALEncoder(D, H, dtype=dt), None)


def case_temporal_encoder_layer():
    return (jloc.TemporalEncoderLayer(D, H, 0.0, dtype=BF),
            [Act(_r(0, 2, A, T + 1, D)), Act(_causal(T + 1))],
            lambda dt: tloc.TemporalEncoderLayer(D, H, dtype=dt), None)


def case_temporal_encoder():
    pad = np.random.default_rng(1).uniform(size=(2, A, T)) < 0.3
    return (jloc.TemporalEncoder(T, D, H, 2, 0.0, dtype=BF), [Act(_r(0, 2, A, T, D)), pad],
            lambda dt: tloc.TemporalEncoder(T, D, H, 2, dtype=dt), None)


def _small_scene():
    return scene_pair(5, 2, A, L)


def case_local_encoder():
    """The baseline's encoder at its historical length: f32 out."""
    js, ts = _small_scene()
    Th = js.x.shape[2]
    return (jloc.LocalEncoder(Th, D, H, 0.0, num_temporal_layers=2, dtype=BF), [js],
            lambda dt: tloc.LocalEncoder(Th, D, H, 0.0, num_temporal_layers=2, dtype=dt),
            lambda m, a: m(ts))


def case_global_interactor_layer():
    x, e, mask = Act(_r(0, 2, A, D)), Act(_r(1, 2, A, A, D)), _mask(2, (2, A, A))
    return (jagg.GlobalInteractorLayer(D, H, 0.0, dtype=BF), [x, mask, e],
            lambda dt: tagg.GlobalInteractorLayer(D, H, dtype=dt), None)


def case_global_interactor():
    """f32 local embeddings in, cast to bf16 inside, f32 out."""
    js, ts = _small_scene()
    Th = js.x.shape[2]
    local = _r(0, 2, A, D)
    return (jagg.GlobalInteractor(Th, D, 3, H, 2, 0.0, dtype=BF), [js, local],
            lambda dt: tagg.GlobalInteractor(Th, D, 3, H, 2, 0.0, dtype=dt),
            lambda m, a: m(ts, t(local)))


def case_mlp_decoder():
    js, ts = _small_scene()
    local, glob = _r(0, 2, A, D), _r(1, 2, 3, A, D)
    return (jdec.MLPDecoder(D, D, 12, 3, dtype=BF), [js, local, glob],
            lambda dt: tdec.MLPDecoder(D, D, 12, 3, dtype=dt),
            lambda m, a: m(ts, t(local), t(glob)))


def case_sde_decoder():
    """fuse, the loop rollout on the bf16 state with pinned noise, decode."""
    js, ts = _small_scene()
    local, glob, noise = _r(0, 2, A, D), _r(1, 2, 3, A, D), _r(2, 6, 2, 3, A, D)
    return (jdec.SDEDecoder(D, D, 6, 3, max_fut_t=0.6, dtype=BF),
            [js, local, glob, True, noise],
            lambda dt: tdec.SDEDecoder(D, D, 6, 3, max_fut_t=0.6, dtype=dt),
            lambda m, a: m(ts, t(local), t(glob), sde_noise=t(noise)))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def _outputs(out):
    """A module's outputs as a flat list of (name, array)."""
    if isinstance(out, dict):
        return [(k, out[k]) for k in ("loc", "pi")]
    if isinstance(out, (tuple, list)):
        flat = jax.tree.leaves(out) if not isinstance(out[0], torch.Tensor) else list(out)
        return [(str(i), o) for i, o in enumerate(flat)]
    return [("out", out)]


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX outputs, bridged state_dict) of a case."""
    jm, args, _, _ = CASES[name]()
    if jm is None:   # a function, not a module
        fn = lambda *a: jlayers.masked_softmax(*a)  # noqa: E731
        out = jit_exact(fn, *map(_jax_arg, args))(*map(_jax_arg, args))
        return [(k, np.asarray(v.astype(jnp.float32))) for k, v in _outputs(out)], None
    jargs = jax.tree.map(_jax_arg, args, is_leaf=lambda a: isinstance(a, Act))
    params = _perturbed({"params": jm.init(jax.random.key(0), *jargs)["params"]}, 1)
    if isinstance(jm, jsde.SDEGRUStep):      # (carry, (h, g)): the state and the tap
        fn = lambda p, *a: jm.apply(p, *a)[1]  # noqa: E731
    elif isinstance(jm, jsde.SDEStep):       # (y1, y1)
        fn = lambda p, *a: jm.apply(p, *a)[0]  # noqa: E731
    else:
        fn = lambda p, *a: jm.apply(p, *a)  # noqa: E731
    out = jit_exact(fn, params, *jargs)(params, *jargs)
    outs = [(k, np.asarray(jnp.asarray(v).astype(jnp.float32))) for k, v in _outputs(out)]
    return outs, params_from_flax(jax.tree.map(np.asarray, params))


@torch.no_grad()
def _port_side(name, bf16):
    _, args, ctor, call = CASES[name]()
    pargs = [_port_arg(a, bf16) if not isinstance(a, (list, tuple)) else
             type(a)(_port_arg(x, bf16) for x in a) for a in args]
    if ctor is None:
        return _outputs(tlayers.masked_softmax(*pargs))
    module = ctor("bfloat16" if bf16 else None).eval()
    module.load_state_dict(_jax_side(name)[1])
    out = call(module, pargs) if call is not None else module(*pargs)
    return _outputs(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_in_bf16_matches_jax(name):
    want = _jax_side(name)[0]
    got = _port_side(name, True)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype in (torch.bfloat16, torch.float32)
        check_bf16(g, w, MODULE_BAR, f"{name}.{k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_in_f32_fails_the_bf16_bar(name):
    """The planted fault: the port in f32 on the same weights and inputs."""
    want = _jax_side(name)[0]
    got = _port_side(name, False)
    dists = [bf16_distance(g, w) for (_, g), (_, w) in zip(got, want)]
    assert any(d[0] > MODULE_BAR[0] or d[1] > MODULE_BAR[1] for d in dists), dists


@pytest.mark.parametrize("name", ["local_encoder", "global_interactor", "mlp_decoder",
                                  "sde_decoder"])
def test_model_level_modules_return_f32(name):
    for _, g in _port_side(name, True):
        assert g.dtype == torch.float32


def test_every_parameter_stays_f32_and_linear_rounds_twice():
    """The compute dtype changes no parameter, and a bf16 ``Linear`` rounds
    its product before adding the bias, as flax's Dense does."""
    lin = tlayers.Linear(D, D, "bfloat16")
    assert all(p.dtype == torch.float32 for p in lin.parameters())
    x = torch.from_numpy(_r(0, 64, D)).bfloat16()
    with torch.no_grad():
        lin.weight.normal_()
        lin.bias.normal_()
        once = torch.nn.functional.linear(x.float(), lin.weight.bfloat16().float(),
                                          lin.bias.bfloat16().float()).bfloat16()
        twice = (x @ lin.weight.bfloat16().t()) + lin.bias.bfloat16()
        got = lin(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, twice)
    assert not torch.equal(once, twice)
    ln = tlayers.layer_norm(D, torch.bfloat16)
    assert ln.weight.dtype == torch.float32 and ln(x).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float16", "bf16", torch.float64, jnp.bfloat16])
def test_an_unknown_dtype_raises(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tlayers.compute_dtype(dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tconfig.build_model(_with_dtype(small_cfg(), dtype), device="cpu")


def _with_dtype(cfg, dtype):
    cfg = copy.deepcopy(cfg)
    cfg["aggregator"]["kwargs"]["dtype"] = dtype
    return cfg


@pytest.mark.parametrize("dtype", [None, "float32", torch.float32, "bfloat16", torch.bfloat16])
def test_accepted_dtypes(dtype):
    want = torch.bfloat16 if dtype in ("bfloat16", torch.bfloat16) else None
    assert tlayers.compute_dtype(dtype) is want
    agg = tconfig.build("GlobalInteractor", dict(historical_steps=T, embed_dim=D, num_modes=3,
                                                 num_heads=H, dtype=dtype))
    assert agg.compute_dtype is want and agg.multihead_proj.compute_dtype is want


@pytest.mark.parametrize("cls,kwargs", [
    ("LocalEncoderSDESep", dict(historical_steps=21, embed_dim=D)),
    ("LocalEncoder", dict(historical_steps=21, embed_dim=D))])
def test_a_fused_encoder_in_bf16_builds_and_takes_ln_mm(cls, kwargs):
    """A fused encoder in bf16 (once refused) builds through the registry;
    its AA chain computes in bf16, and ``ln_mm`` (the JAX modules'
    default, True) reaches its ``AAEncoder`` instead of being dropped."""
    enc = tconfig.build(cls, dict(kwargs, fused=True, dtype="bfloat16"))
    aa = enc.aa_encoder
    assert aa.fused and aa.chain_dtype == "bfloat16" and aa.ln_mm is True
    off = tconfig.build(cls, dict(kwargs, fused=True, dtype="bfloat16", ln_mm=False))
    assert off.aa_encoder.ln_mm is False
    f32 = tconfig.build(cls, dict(kwargs, fused=True, dtype="float32"))
    assert f32.aa_encoder.chain_dtype == "float32" and f32.aa_encoder.ln_mm is True


@pytest.mark.parametrize("cls", ["LocalEncoderSDESep", "LocalEncoder"])
def test_remat_builds_on_either_encoder_and_rematerializes(cls):
    """``config.build`` drops the kwargs a constructor does not take, so the
    SDE encoder once built a model without rematerialization, silently;
    then ``remat`` raised.  Now it reaches both constructors, in bf16 too,
    and a training backward runs the AA block's forward again."""
    kw = dict(FLAGSHIP["encoder"]["kwargs"], embed_dim=D, num_heads=2, dtype="bfloat16")
    enc = tconfig.build(cls, dict(kw, remat=True))
    assert enc.remat and not tconfig.build(cls, dict(kw, remat=False)).remat
    calls = []
    enc.aa_encoder.register_forward_pre_hook(lambda *_: calls.append(1))
    _, scene = scene_pair(0, B=2, A=3, L=4)
    out = enc.train()(scene, generator=torch.Generator().manual_seed(0))
    (out[0] if isinstance(out, tuple) else out).float().square().sum().backward()
    assert len(calls) == 2


@pytest.mark.parametrize("name,path", [
    ("FLAGSHIP_BF16", "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu.yml"),
    ("FLAGSHIP_BF16_CAPPED", "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu_fast.yml")])
def test_bf16_configs_are_their_yamls_and_build_as_written(name, path):
    raw = tconfig.load_config(os.path.join(REPO, path))
    assert getattr(tconfig, name) == raw
    model = tconfig.build_model(raw, device="cpu")
    enc, agg, dec = model.encoder, model.aggregator, model.decoder
    assert isinstance(enc, LocalEncoderSDESep) and enc.compute_dtype is torch.bfloat16
    assert enc.aa_encoder.neighbor_cap == (24 if name.endswith("CAPPED") else 0)
    assert not enc.aa_encoder.fused and not dec.fused
    for mod in (enc.aa_encoder.nbr_embed.aggr_dense, enc.sde_rnn.gru.new_state_1,
                enc.al_encoder.norm2, agg.multihead_proj, dec.aggr_ln, dec.sde_rollout.f_func.dense0,
                dec.loc_layers_2):
        assert mod.compute_dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bridge_loads_one_flax_tree_into_the_f32_and_the_bf16_model():
    js, _ = scene_pair(2, 2, A, L)
    cfg = small_cfg(D=D, H=H)
    _, params, f32 = model_pair(cfg, js)
    bf16 = torch_build_model(bf16_cfg(cfg), device="cpu")
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    bf16.load_state_dict(sd, strict=True)
    a, b = f32.state_dict(), bf16.state_dict()
    assert list(a) == list(b) and set(a) == set(sd)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
