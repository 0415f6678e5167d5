"""Port layers vs the JAX package on the CPU, one case per module.

Weights come from a flax init and are carried across with the bridge.
Tolerance: f32 single layers agree to atol 1e-5 (LayerNorm variance is
computed in two passes by torch and as E[x^2] - E[x]^2 by flax; sums run
in another order); masks and index results are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.models import embedding as jemb, graph as jgraph, layers as jlayers, sde as jsde
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.models import embedding as temb, graph as tgraph, layers as tlayers, sde as tsde

from _torch_helpers import scene_pair, t

torch.set_num_threads(1)
ATOL = 1e-5
D, H = 16, 2


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bridged(jmod, tmod, *args):
    params = jmod.init(jax.random.key(0), *args)
    tmod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return params


def _mask(seed, shape):
    m = np.random.default_rng(seed).uniform(size=shape) < 0.6
    m[..., 0, :] = False  # one receiver with no incoming edge
    return m


def case_masked_softmax():
    logits, mask = _r(0, 3, 4, 6), _mask(1, (3, 4, 6))
    a = jlayers.masked_softmax(jnp.asarray(logits), jnp.asarray(mask))
    b = tlayers.masked_softmax(t(logits), t(mask))
    assert np.all(b.numpy()[:, 0] == 0.0)  # all-masked rows are exactly 0
    return [(a, b)]


def case_edge_attention_pair():
    center, kv, mask = _r(0, 2, 5, D), _r(1, 2, 5, 7, D), _mask(2, (2, 5, 7))
    jm, tm = jlayers.EdgeAttention(D, H), tlayers.EdgeAttention(D, H)
    p = _bridged(jm, tm, center, mask, kv)
    return [(jm.apply(p, center, mask, kv_pair=kv), tm(t(center), t(mask), kv_pair=t(kv)))]


def case_edge_attention_node_edge():
    center, edge, mask = _r(0, 2, 5, D), _r(1, 2, 5, 5, D), _mask(2, (2, 5, 5))
    jm, tm = jlayers.EdgeAttention(D, H), tlayers.EdgeAttention(D, H, edge_stream=True)
    p = _bridged(jm, tm, center, mask, None, center, edge)
    return [(jm.apply(p, center, mask, kv_node=center, kv_edge=edge),
             tm(t(center), t(mask), kv_node=t(center), kv_edge=t(edge)))]


def case_gru():
    h, x = _r(0, 4, D), _r(1, 4, D)
    mask = np.array([True, False, True, True])
    jm, tm = jlayers.GRUUnit(D, D), tlayers.GRUUnit(D, D)
    p = _bridged(jm, tm, h, x, mask)
    out = tm(t(h), t(x), t(mask))
    np.testing.assert_array_equal(out.numpy()[1], h[1])  # masked rows keep h
    return [(jm.apply(p, h, x, mask), out)]


def case_single_embedding():
    x = _r(0, 3, 4, 2)
    jm, tm = jemb.SingleInputEmbedding(D), temb.SingleInputEmbedding(2, D)
    p = _bridged(jm, tm, x)
    return [(jm.apply(p, x), tm(t(x)))]


def case_multiple_embedding():
    a, b = _r(0, 3, 4, 2), _r(1, 3, 4, 2)
    jm, tm = jemb.MultipleInputEmbedding(D), temb.MultipleInputEmbedding([2, 2], D)
    p = _bridged(jm, tm, [a, b])
    return [(jm.apply(p, [a, b]), tm([t(a), t(b)]))]


def case_sde_gru_step():
    h, obs, eps = _r(0, 2, 3, D), _r(1, 2, 3, D), _r(2, 2, 3, D)
    nus = np.array([[True] * 3, [False] * 3])
    obs_mask = np.array([[True, False, True], [True, True, False]])
    t0, dt = np.float32(0.3), np.float32(0.1)
    jm, tm = jsde.SDEGRUStep(D), tsde.SDEGRUStep(D)
    p = _bridged(jm, tm, (h, nus), (obs, obs_mask, t0, dt, eps))
    (jh, _), (_, jg) = jm.apply(p, (h, nus), (obs, obs_mask, t0, dt, eps))
    th, tg = tm(t(h), t(nus), t(obs), t(obs_mask), torch.tensor(t0), torch.tensor(dt), t(eps))
    return [(jh, th), (jg, tg)]


def case_sde_step():
    y, eps = _r(0, 5, D), _r(1, 5, D)
    t0, dt = np.float32(1.2), np.float32(0.1)
    jm, tm = jsde.SDEStep(D), tsde.SDEStep(D)
    p = _bridged(jm, tm, y, (t0, dt, eps))
    return [(jm.apply(p, y, (t0, dt, eps))[0], tm(t(y), torch.tensor(t0), torch.tensor(dt), t(eps)))]


def case_time_grids():
    je, te = jsde.encoder_time_grid(21, 2.0, 0.1), tsde.encoder_time_grid(21, 2.0)
    jd, td = jsde.decoder_time_grid(60, 6.0), tsde.decoder_time_grid(60, 6.0)
    return list(zip(je, te)) + list(zip(jd, td))


def case_graph():
    js, ts = scene_pair(3, B=2, A=6, L=9)
    pairs = [
        (jgraph.aa_masks(js, 50.0), tgraph.aa_masks(ts, 50.0)),
        (jgraph.aa_edge_vectors(js), tgraph.aa_edge_vectors(ts)),
        (jgraph.lane_features(js), tgraph.lane_features(ts)),
        *zip(jgraph.al_edges(js, 20, 50.0), tgraph.al_edges(ts, 20, 50.0)),
        *zip(jgraph.global_edges(js, 20), tgraph.global_edges(ts, 20)),
        (js.rotate_mat(), ts.rotate_mat()),
    ]
    return pairs


CASES = {f.__name__[5:]: f for f in (
    case_masked_softmax, case_edge_attention_pair, case_edge_attention_node_edge, case_gru,
    case_single_embedding, case_multiple_embedding, case_sde_gru_step, case_sde_step,
    case_time_grids, case_graph,
)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    with torch.no_grad():
        pairs = CASES[name]()
    for a, b in pairs:
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=ATOL)
