"""The port's SDE / ODE solvers (``trajsde_tpu_torch/ops/brownian.py``,
``sdeint.py`` and ``odeint.py``) vs the JAX package's on the CPU.

JAX's Brownian tree draws node c as ``normal(fold_in(key, c))``; the port
takes the same normals as one pinned tensor (``tree_nodes``), so both
trees are built from one set of nodes.  The fixed-grid solvers get JAX's
per-step draws ``normal(fold_in(key, i))`` as ``eps``.

Tolerances: tree values within 1e-6 x sqrt(span) of JAX's (the bridge's
arithmetic in another compiler: measured 2.4e-7 at a span of 0.8);
additivity within 1e-6, as JAX's own test; query order and the leaf build
against a per-query descent bit for bit.  ``sdeint_adaptive``: JAX's exact
accept / reject counts and convergence, ``ys`` within 1e-5 of max|JAX|.
Euler-Maruyama, its KL form and both ODE solvers within rtol 1e-6 / atol
1e-6; ``get_timesteps`` bit for bit.  JAX's own solver cases
(``tests/test_adaptive.py``) run on the port with their own tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.ops import odeint as jode, sdeint as jsde
from trajsde_tpu.ops.brownian import BrownianTree as JaxTree
from trajsde_tpu_torch.ops import odeint as tode, sdeint as tsde
from trajsde_tpu_torch.ops.brownian import BrownianTree

from _torch_helpers import t, tree_nodes

torch.set_num_threads(1)
N, D = 16, 8


def _descent(nodes: torch.Tensor, t0: float, t1: float, idx: int) -> torch.Tensor:
    """W at leaf ``idx`` by JAX's per-query Lévy-bridge descent, in f32."""
    n = nodes.shape[0]
    span = torch.tensor(t1, dtype=torch.float32) - torch.tensor(t0, dtype=torch.float32)
    lo, hi = 0, n
    w_lo, w_hi = torch.zeros_like(nodes[0]), nodes[n - 1] * torch.sqrt(span)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        half_dt = (hi - lo) * (span / n) * 0.5
        w_mid = 0.5 * (w_lo + w_hi) + torch.sqrt(half_dt * 0.5) * nodes[mid - 1]
        if idx <= mid:
            hi, w_hi = mid, w_mid
        else:
            lo, w_lo = mid, w_mid
    return w_lo if idx <= lo else w_hi


# ---------------------------------------------------------------------------
# the Brownian tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t0,t1,depth", [(0.0, 1.0, 6), (0.3, 1.1, 8), (-0.01, 0.0, 8)])
def test_tree_values_match_jax(t0, t1, depth):
    tt = BrownianTree(t0, t1, (5, 7), depth, t(np.asarray(tree_nodes(jax.random.key(3), (5, 7),
                                                                     depth))))
    span = t1 - t0
    qs = np.concatenate([np.linspace(t0 - 0.1 * span, t1 + 0.1 * span, 97),
                         t0 + span * (np.arange(2 ** depth + 1) + 0.5) / 2 ** depth])
    qs = qs.astype(np.float32)
    key = jax.random.key(3)

    @jax.jit
    def jax_tree(a, b, q):   # bounds traced, as in the solver: no constant folding
        tree = JaxTree(key, a, b, (5, 7), depth=depth)
        return jax.vmap(lambda x: (tree._quantize(x), tree(x)))(q)

    want_idx, want = jax_tree(np.float32(t0), np.float32(t1), qs)
    got_idx = [int(tt.index(torch.tensor(q))) for q in qs]
    np.testing.assert_array_equal(got_idx, np.asarray(want_idx))
    got = np.stack([tt(torch.tensor(q)).numpy() for q in qs])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6 * np.sqrt(span))


def test_tree_rounds_half_to_even_and_clips():
    tree = BrownianTree(0.0, 1.0, (2,), depth=3, nodes=torch.zeros(8, 2))
    got = [int(tree.index(torch.tensor(q))) for q in (0.0625, 0.1875, 0.3125, -1.0, 2.0)]
    assert got == [0, 2, 2, 0, 8]     # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, clipped


def test_tree_is_additive():
    tree = BrownianTree(0.0, 1.0, (8,), depth=10, generator=torch.Generator().manual_seed(0))
    for s, u, v in [(0.0, 0.5, 1.0), (0.125, 0.25, 0.75), (0.0, 0.0625, 0.125),
                    (0.3, 0.41, 0.97)]:
        lhs = tree.increment(s, u) + tree.increment(u, v)
        np.testing.assert_allclose(lhs.numpy(), tree.increment(s, v).numpy(), rtol=0, atol=1e-6)


def test_tree_ignores_query_order_bit_for_bit():
    nodes = torch.randn((256, 3, 4), generator=torch.Generator().manual_seed(1))
    a, b = BrownianTree(0.0, 1.0, (3, 4), 8, nodes), BrownianTree(0.0, 1.0, (3, 4), 8, nodes)
    qs = [0.75, 0.25, 1.0, 0.5, 0.0, 0.33]
    first = [a(torch.tensor(q)) for q in qs]
    second = [b(torch.tensor(q)) for q in reversed(qs)][::-1]
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.equal(a(torch.tensor(0.75)), first[0])


@pytest.mark.parametrize("t0,t1", [(0.0, 1.0), (0.1, 0.2), (-0.01, 0.0)])
def test_tree_leaves_equal_a_per_query_descent_bit_for_bit(t0, t1):
    nodes = torch.randn((64, 5), generator=torch.Generator().manual_seed(2))
    tree = BrownianTree(t0, t1, (5,), 6, nodes)
    for idx in range(65):
        assert torch.equal(tree.leaves[idx], _descent(nodes, t0, t1, idx)), idx


def test_tree_marginals_and_generator():
    n = 20_000
    tree = BrownianTree(0.0, 2.0, (n,), 8, generator=torch.Generator().manual_seed(1))
    for q in (0.5, 1.0, 2.0):
        w = tree(torch.tensor(q)).numpy().astype(np.float64)
        assert abs(w.mean()) < 4.0 * np.sqrt(q / n)
        np.testing.assert_allclose(w.var(), q, rtol=0.05)
    same = BrownianTree(0.0, 2.0, (n,), 8, generator=torch.Generator().manual_seed(1))
    other = BrownianTree(0.0, 2.0, (n,), 8, generator=torch.Generator().manual_seed(2))
    assert torch.equal(same.leaves, tree.leaves)
    assert not torch.allclose(other.leaves, tree.leaves)
    with pytest.raises(ValueError, match="2\\*\\*depth"):
        BrownianTree(0.0, 1.0, (3,), 4, torch.zeros(8, 3))


# ---------------------------------------------------------------------------
# sdeint_adaptive vs JAX
# ---------------------------------------------------------------------------
def _nets(seed, stiff=0.0):
    """(JAX f, JAX g, port f, port g): a tanh drift and a per-row sigmoid
    diffusion magnitude, both time-dependent, from numpy weights."""
    r = np.random.default_rng(seed)
    w1 = (r.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    w2 = (r.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    wg = (r.standard_normal((D, 1)) / np.sqrt(D)).astype(np.float32)
    k = np.float32(0.5 + stiff)

    def jf(tt, y):
        return jnp.tanh(y @ w1 + jnp.sin(tt)) @ w2 - k * y

    def jg(tt, y):
        return jax.nn.sigmoid(y @ wg + jnp.cos(tt))

    tw1, tw2, twg = t(w1), t(w2), t(wg)

    def tf(tt, y):
        return torch.tanh(y @ tw1 + torch.sin(tt)) @ tw2 - float(k) * y

    def tg(tt, y):
        return torch.sigmoid(y @ twg + torch.cos(tt))

    return jf, jg, tf, tg


ADAPTIVE_CASES = {
    # name: (ts, solver kwargs, stiffness)
    "segment": ([0.0, 0.1], dict(dt0=0.05, dt_min=0.1 / 64, max_steps=8, depth=8), 0.0),
    "grid": (list(np.linspace(0.0, 1.0, 6)), dict(dt0=0.37, max_steps=64), 0.0),
    "rejects": ([0.0, 1.0], dict(dt0=0.5, rtol=3e-2, atol=3e-2, max_steps=64,
                                 dt_min=1e-3), 20.0),
    "unfinished": ([0.0, 0.3, 0.6, 1.0], dict(dt0=0.01, max_steps=5), 0.0),
    "floor": ([0.0, 0.5], dict(dt0=0.2, rtol=1e-7, atol=1e-7, max_steps=40, depth=6), 0.0),
    "sliver": ([0.0, 1.0], dict(dt0=0.45, rtol=1.0, atol=1.0, max_steps=8, dt_min=0.2,
                                depth=6), 0.0),
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE_CASES))
def test_sdeint_adaptive_matches_jax(name):
    ts, kw, stiff = ADAPTIVE_CASES[name]
    kw = dict(dict(rtol=1e-2, atol=1e-2), **kw)
    jf, jg, tf, tg = _nets(5, stiff)
    y0 = np.random.default_rng(6).standard_normal((N, D)).astype(np.float32)
    key = jax.random.key(7)
    depth = kw.get("depth", 12)
    # the grid traced, as in the encoder (a constant grid lets XLA fold the tree's division)
    want, wstats = jax.jit(lambda y, k, grid: jsde.sdeint_adaptive(jf, jg, y, grid, k, **kw))(
        jnp.asarray(y0), key, np.asarray(ts, np.float32))
    nodes = t(np.asarray(tree_nodes(key, (N, D), depth)))
    got, stats = tsde.sdeint_adaptive(tf, tg, t(y0), torch.tensor(ts, dtype=torch.float32),
                                      nodes=nodes, **kw)
    for k in ("n_accepted", "n_rejected", "converged"):
        assert int(stats[k]) == int(wstats[k]), (k, int(stats[k]), int(wstats[k]))
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(stats["final_dt"]), float(wstats["final_dt"]), rtol=1e-5)


def test_sdeint_adaptive_cases_cover_the_controller():
    """The cases above reach what they are named for (read from JAX)."""
    seen = {}
    for name, (ts, kw, stiff) in ADAPTIVE_CASES.items():
        kw = dict(dict(rtol=1e-2, atol=1e-2), **kw)
        jf, jg, tf, tg = _nets(5, stiff)
        y0 = np.random.default_rng(6).standard_normal((N, D)).astype(np.float32)
        _, st = tsde.sdeint_adaptive(tf, tg, t(y0), torch.tensor(ts, dtype=torch.float32),
                                     generator=torch.Generator().manual_seed(0), **kw)
        seen[name] = {k: float(v) for k, v in st.items()}
    assert seen["rejects"]["n_rejected"] >= 1 and seen["rejects"]["converged"]
    assert not seen["unfinished"]["converged"]
    # at the floor of two leaves (0.5 * 2 / 2**6) every step is accepted
    floor = seen["floor"]
    assert floor["converged"] and floor["n_rejected"] >= 1 and floor["final_dt"] == 2 ** -6
    # dt0 0.45 then 0.63 would leave a 0.1 sliver below dt_min 0.2: stretched, 2 steps
    sliver = seen.pop("sliver")
    assert (sliver["n_accepted"], sliver["n_rejected"], sliver["converged"]) == (2, 0, 1)


# ---------------------------------------------------------------------------
# JAX's own solver cases (tests/test_adaptive.py), on the port
# ---------------------------------------------------------------------------
def _zero(tt, y):
    return torch.zeros_like(y)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_ode_accuracy_linear_decay():
    ys, stats = tsde.sdeint_adaptive(lambda tt, y: -y, _zero, torch.ones(4),
                                     torch.tensor([0.0, 0.5, 1.0]), dt0=0.25, rtol=1e-4,
                                     atol=1e-5, generator=_gen())
    assert bool(stats["converged"])
    np.testing.assert_allclose(ys[0].numpy(), np.exp(-0.5), rtol=1e-2)
    np.testing.assert_allclose(ys[1].numpy(), np.exp(-1.0), rtol=1e-2)


def test_tighter_tolerance_takes_more_steps():
    def n_steps(rtol):
        _, stats = tsde.sdeint_adaptive(lambda tt, y: torch.sin(8.0 * tt) * y, _zero,
                                        torch.ones(2), torch.tensor([0.0, 1.0]), dt0=0.5,
                                        rtol=rtol, atol=rtol, max_steps=512, dt_min=1e-5,
                                        generator=_gen())
        assert bool(stats["converged"])
        return int(stats["n_accepted"])

    assert n_steps(1e-4) > n_steps(1e-2)


def test_ou_moments():
    theta, mu, sigma = 1.0, 0.3, 0.5
    n = 8192
    ys, stats = tsde.sdeint_adaptive(lambda tt, y: theta * (mu - y),
                                     lambda tt, y: torch.full_like(y, sigma),
                                     torch.full((n, 1), 1.5), torch.tensor([0.0, 1.0]),
                                     dt0=0.05, rtol=2e-3, atol=2e-3, max_steps=128, depth=10,
                                     generator=_gen(7))
    assert bool(stats["converged"])
    mean_ref, var_ref = tsde.ou_moments(1.5, theta, mu, sigma, 1.0)
    jmean, jvar = jsde.ou_moments(1.5, theta, mu, sigma, 1.0)
    np.testing.assert_allclose([float(mean_ref), float(var_ref)], [float(jmean), float(jvar)],
                               rtol=1e-6)
    samples = ys[0, :, 0].numpy().astype(np.float64)
    np.testing.assert_allclose(samples.mean(), float(mean_ref), atol=0.03)
    np.testing.assert_allclose(samples.var(), float(var_ref), rtol=0.15)


def test_rejections_counted_and_dt_adapts():
    _, stats = tsde.sdeint_adaptive(lambda tt, y: -50.0 * y, _zero, torch.ones(2),
                                    torch.tensor([0.0, 1.0]), dt0=0.5, rtol=1e-3, atol=1e-3,
                                    max_steps=512, dt_min=1e-5, generator=_gen())
    assert bool(stats["converged"])
    assert int(stats["n_rejected"]) >= 1


def test_differentiable():
    scale = torch.tensor(1.0, requires_grad=True)
    ys, _ = tsde.sdeint_adaptive(lambda tt, y: -scale * y, _zero, torch.ones(2),
                                 torch.tensor([0.0, 1.0]), dt0=0.2, rtol=1e-3, atol=1e-3,
                                 max_steps=64, generator=_gen())
    (grad,) = torch.autograd.grad(ys[-1].sum(), scale)
    np.testing.assert_allclose(float(grad), -2.0 * np.exp(-1.0), rtol=5e-2)


def test_output_interpolation_grid():
    ts = torch.linspace(0.0, 1.0, 11)
    ys, stats = tsde.sdeint_adaptive(lambda tt, y: torch.ones_like(y), _zero, torch.zeros(1),
                                     ts, dt0=0.37, rtol=1e-3, atol=1e-3, generator=_gen())
    assert bool(stats["converged"])
    np.testing.assert_allclose(ys[:, 0].numpy(), ts[1:].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# fixed-grid solvers and time grids vs JAX
# ---------------------------------------------------------------------------
def _step_draws(key, steps, shape):
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                                  jnp.float32)) for i in range(steps)])


GRID = np.concatenate([[0.0], np.cumsum(np.full(12, 0.1))]).astype(np.float32)


def test_euler_maruyama_matches_jax():
    jf, jg, tf, tg = _nets(8)
    y0 = np.random.default_rng(9).standard_normal((N, D)).astype(np.float32)
    key = jax.random.key(10)
    want_ys, want_gs = jax.jit(lambda y: jsde.euler_maruyama(jf, jg, y, jnp.asarray(GRID), key))(
        jnp.asarray(y0))
    eps = t(_step_draws(key, len(GRID) - 1, (N, D)))
    ys, gs = tsde.euler_maruyama(tf, tg, t(y0), t(GRID), eps=eps)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(want_gs), rtol=1e-6, atol=1e-6)
    assert gs.shape == (len(GRID) - 1, N, 1)
    a = tsde.euler_maruyama(tf, tg, t(y0), t(GRID), generator=_gen(3))[0]
    b = tsde.euler_maruyama(tf, tg, t(y0), t(GRID), generator=_gen(3))[0]
    assert torch.equal(a, b)


def test_euler_maruyama_logqp_matches_jax():
    jf, jg, tf, tg = _nets(11)
    y0 = np.random.default_rng(12).standard_normal((N, D)).astype(np.float32)
    key = jax.random.key(13)
    want_ys, want_kl = jax.jit(lambda y: jsde.euler_maruyama_logqp(
        jf, jg, lambda tt, x: 1.0 * (0.0 - x), y, jnp.asarray(GRID), key))(jnp.asarray(y0))
    eps = t(_step_draws(key, len(GRID) - 1, (N, D)))
    ys, kl = tsde.euler_maruyama_logqp(tf, tg, lambda tt, x: 1.0 * (0.0 - x), t(y0), t(GRID),
                                       eps=eps)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kl.numpy(), np.asarray(want_kl), rtol=1e-6, atol=1e-6)
    assert kl.shape == (N,)


@pytest.mark.parametrize("solver", ["odeint_euler", "odeint_rk4"])
def test_odeint_matches_jax(solver):
    jf, _, tf, _ = _nets(14)
    y0 = np.random.default_rng(15).standard_normal((N, D)).astype(np.float32)
    want = jax.jit(lambda y: getattr(jode, solver)(jf, y, jnp.asarray(GRID)))(jnp.asarray(y0))
    got = getattr(tode, solver)(tf, t(y0), t(GRID))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dataset", ["Argoverse", "nuScenes"])
def test_get_timesteps_is_jax_bit_for_bit(dataset):
    got, want = tode.get_timesteps(dataset), np.asarray(jode.get_timesteps(dataset))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if dataset == "nuScenes":   # the reference's duplicated zero stays
        assert float(got[3]) == float(got[4]) == 0.0


def test_get_timesteps_rejects_an_unknown_dataset():
    with pytest.raises(ValueError):
        tode.get_timesteps("Waymo")
