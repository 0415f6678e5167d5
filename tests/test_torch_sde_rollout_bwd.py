"""Rollout K2 (the reverse sweep) and ``SDERolloutFn`` on the CPU.

* the plain K2 (``dy0`` and all 14 weight gradients) vs ``jax.vjp`` of a
  ``lax.scan`` over the JAX package's ``_euler_step``, with explicit noise,
  at a row count that is a multiple of K2's 64-row tile and one that is no
  multiple of any tile;
* the same vs the JAX ``sde_rollout_train`` custom VJP in interpret mode,
  with a ``block_rows`` that divides N (a padded N trips fault R1 of the
  JAX package);
* ``SDERolloutFn`` vs autograd through the plain forward loop, and
  ``gradcheck`` in float64;
* in-kernel increments are regenerated in the backward, not stored;
* the differentiable packing routes each gradient to its ``nn.Linear``.

Tolerances: rtol 1e-4 / atol 1e-5 against JAX in f32 (the same arithmetic
summed in another order over 8 steps); 1e-5 between the port's own f32
paths; float64 for ``gradcheck``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.ops.pallas.sde_rollout import W_ROLLOUT_ORDER, _euler_step, sde_rollout_train
from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid
from trajsde_tpu_torch.ops import sde_rollout as K

torch.set_num_threads(1)
D, T = 16, 8
TOL_JAX = dict(rtol=1e-4, atol=1e-5)


def _problem(n, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    p = dict(wf0=f(D, D, sc=0.3), wf0t=f(2, D, sc=0.3), bf0=f(1, D, sc=0.1),
             wf1=f(D, D, sc=0.3), bf1=f(1, D, sc=0.1), wf2=f(D, D, sc=0.3), bf2=f(1, D, sc=0.1),
             wg0=f(D, D, sc=0.3), wg0t=f(2, D, sc=0.3), bg0=f(1, D, sc=0.1),
             wg1=f(D, D, sc=0.3), bg1=f(1, D, sc=0.1), wgo=f(D, 1, sc=0.3), bgo=f(1, 1, sc=0.1))
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    return dict(p=p, y0=f(n, D, sc=0.5), noise=f(T, n, D), ct=f(T, n, D),
                t0s=ts[:-1], dts=ts[1:] - ts[:-1])


def _port_grads(pr, noise=True, seed=0, increments="gaussian"):
    tp = {k: torch.from_numpy(v) for k, v in pr["p"].items()}
    y0 = torch.from_numpy(pr["y0"])
    t0s, dts = torch.from_numpy(pr["t0s"]), torch.from_numpy(pr["dts"])
    nz = torch.from_numpy(pr["noise"]) if noise else None
    w = K.pack_params(tp)
    ys = K.sde_rollout_packed(y0, w, t0s, dts, seed, T, nz, increments)
    dy0, dw = K.sde_rollout_bwd(y0, ys, torch.from_numpy(pr["ct"]), w, t0s, dts, seed, T, nz,
                                increments)
    return dy0.numpy(), {k: v.numpy() for k, v in K.unpack_params(dw, D).items()}


def _jax_scan_vjp(pr):
    ws0 = {k: jnp.asarray(v) for k, v in pr["p"].items()}

    def run(y0, p):
        ws = tuple(p[k] for k in W_ROLLOUT_ORDER)

        def step(y, inp):
            t0, dt, z = inp
            y1 = _euler_step(y, jnp.sin(t0), jnp.cos(t0), dt, jnp.sqrt(dt), z, ws)
            return y1, y1

        return jax.lax.scan(step, y0, (pr["t0s"], pr["dts"], jnp.asarray(pr["noise"])))[1]

    _, vjp = jax.vjp(run, jnp.asarray(pr["y0"]), ws0)
    dy0, dp = vjp(jnp.asarray(pr["ct"]))
    return np.asarray(dy0), {k: np.asarray(v) for k, v in dp.items()}


def _close(got, want, tol):
    dy0, dp = got
    np.testing.assert_allclose(dy0, want[0], **tol, err_msg="dy0")
    assert set(dp) == set(want[1]) == set(K.PARAM_ORDER)
    for k in K.PARAM_ORDER:
        np.testing.assert_allclose(dp[k], want[1][k], **tol, err_msg=k)


@pytest.mark.parametrize("n", [64, 13])
def test_plain_bwd_matches_jax_vjp_of_scan(n):
    pr = _problem(n)
    _close(_port_grads(pr), _jax_scan_vjp(pr), TOL_JAX)


def test_plain_bwd_matches_jax_rollout_train_interpret():
    n = 12
    pr = _problem(n, seed=1)
    ws0 = {k: jnp.asarray(v) for k, v in pr["p"].items()}

    def loss(y0, p):
        ys = sde_rollout_train(y0, p, jnp.asarray(pr["t0s"]), jnp.asarray(pr["dts"]),
                               jnp.int32(0), num_steps=T, block_rows=4, interpret=True,
                               noise=jnp.asarray(pr["noise"]), unroll=2)
        return jnp.sum(ys * pr["ct"])

    dy0, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pr["y0"]), ws0)
    want = (np.asarray(dy0), {k: np.asarray(v) for k, v in dp.items()})
    _close(_port_grads(pr), want, TOL_JAX)


def _step(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    step = SDEStep(D).to(dtype)
    for p in step.parameters():
        p.data = torch.randn(p.shape, generator=gen, dtype=dtype) * 0.3
    return step


@pytest.mark.parametrize("mode", ["explicit", "gaussian", "rademacher"])
def test_function_matches_autograd_through_plain_loop(mode):
    step = _step(torch.float32)
    t0s, dts = decoder_time_grid(T, 1.0)
    gen = torch.Generator().manual_seed(1)
    y0 = torch.randn((13, D), generator=gen)
    noise = torch.randn((T, 13, D), generator=gen) if mode == "explicit" else None
    inc = "gaussian" if mode == "explicit" else mode
    ct = torch.randn((T, 13, D), generator=gen)

    def grads(run):
        step.zero_grad()
        y = y0.clone().requires_grad_()
        (run(y) * ct).sum().backward()
        return [y.grad] + [p.grad.clone() for p in step.parameters()]

    got = grads(lambda y: K.SDERolloutFn.apply(
        y, K.pack_params(K.rollout_params_from_module(step, detach=False)), t0s, dts, 5, T,
        noise, inc))
    want = grads(lambda y: K.sde_rollout_reference(
        y, K.rollout_params_from_module(step, detach=False), t0s, dts, 5, T, noise, inc))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_gradcheck_float64():
    step = _step(torch.float64, seed=2)
    t0s, dts = decoder_time_grid(3, 0.6)
    w = K.pack_params(K.rollout_params_from_module(step)).detach().requires_grad_()
    y0 = torch.randn((3, D), generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64).requires_grad_()
    for noise, inc in ((torch.randn((3, 3, D), dtype=torch.float64), "gaussian"),
                       (None, "gaussian"), (None, "rademacher")):
        fn = lambda y, w_: K.SDERolloutFn.apply(y, w_, t0s, dts, 4, 3, noise, inc)  # noqa: E731
        assert torch.autograd.gradcheck(fn, (y0, w))


def test_backward_regenerates_the_forward_draws():
    """The in-kernel gaussian backward equals the explicit-noise backward
    fed the increments the forward drew; the same seed repeats the grads
    exactly and another seed changes them."""
    pr = _problem(40, seed=4)
    keys = K.seed_keys(9)
    drawn = torch.stack([K.draw_increments(keys, torch.arange(40), t, T, D, "gaussian")
                         for t in range(T)])
    pr_explicit = dict(pr, noise=drawn.numpy())
    in_kernel = _port_grads(pr, noise=False, seed=9)
    _close(in_kernel, _port_grads(pr_explicit, noise=True, seed=123), dict(rtol=0, atol=0))
    _close(_port_grads(pr, noise=False, seed=9), in_kernel, dict(rtol=0, atol=0))
    other = _port_grads(pr, noise=False, seed=10)
    assert np.abs(other[0] - in_kernel[0]).max() > 1e-3


def test_packing_routes_gradients_to_linear_slices():
    """d(sum(w * r))/d(weights) puts each slice of r on its Linear: dense0
    columns [:D] are wf0^T, columns D and D+1 the sin / cos rows wf0t."""
    step = _step(torch.float32, seed=5)
    w = K.pack_params(K.rollout_params_from_module(step, detach=False))
    r = torch.randn(w.shape, generator=torch.Generator().manual_seed(6))
    (w * r).sum().backward()
    rp = K.unpack_params(r, D)
    f, g = step.f_func, step.g_func
    for lin, mat, tfeat, bias in ((f.dense0, "wf0", "wf0t", "bf0"), (g.dense0, "wg0", "wg0t", "bg0")):
        torch.testing.assert_close(lin.weight.grad[:, :D], rp[mat].T, rtol=0, atol=0)
        torch.testing.assert_close(lin.weight.grad[:, D], rp[tfeat][0], rtol=0, atol=0)
        torch.testing.assert_close(lin.weight.grad[:, D + 1], rp[tfeat][1], rtol=0, atol=0)
        torch.testing.assert_close(lin.bias.grad, rp[bias][0], rtol=0, atol=0)
    for lin, mat, bias in ((f.dense1, "wf1", "bf1"), (f.dense2, "wf2", "bf2"),
                           (g.dense1, "wg1", "bg1"), (g.dense_out, "wgo", "bgo")):
        torch.testing.assert_close(lin.weight.grad, rp[mat].T, rtol=0, atol=0)
        torch.testing.assert_close(lin.bias.grad, rp[bias][0], rtol=0, atol=0)
    assert float(w[-3:].detach().abs().sum()) == 0.0   # bgo's padding


def test_bwd_wrapper_rejects_other_devices():
    pr = _problem(4)
    w = K.pack_params({k: torch.from_numpy(v) for k, v in pr["p"].items()})
    z = torch.zeros((4, D), device="meta")
    with pytest.raises(ValueError, match="meta"):
        K.sde_rollout_bwd(z, z, z, w, torch.zeros(T), torch.full((T,), 0.1), 0, T)
    with pytest.raises(ValueError, match="floats"):
        K.unpack_params(w[:-1], D)
