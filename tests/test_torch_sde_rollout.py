"""Rollout K1's plain version vs the JAX package on the CPU.

The JAX Pallas kernel runs in interpret mode with explicit noise, as its
own tests run it.  Tolerance: rtol 2e-5 / atol 2e-5 over the 12-step f32
horizon (the same arithmetic in another summation order).  The in-kernel
generator cannot replay the TPU's bits, so it is held to JAX's gaussian
path by terminal moments.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu.models.sde import SDEStep as JSDEStep, decoder_time_grid, scanned
from trajsde_tpu.ops.pallas.sde_rollout import rollout_params_from_linen, sde_rollout as jax_rollout
from trajsde_tpu_torch.bridge import params_from_flax
from trajsde_tpu_torch.models.sde import SDEStep
from trajsde_tpu_torch.ops import sde_rollout as K

torch.set_num_threads(1)
D, TF = 64, 12


@pytest.fixture(scope="module")
def ref():
    import flax.linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, y0, xs):
            return scanned(JSDEStep, "roll", embed_dim=D, sde_layers=2)(y0, xs)

    mod = M()
    t0s, dts = decoder_time_grid(TF, 1.2)
    params = mod.init({"params": jax.random.key(0), "sde": jax.random.key(9)},
                      jnp.zeros((4, D)), (t0s, dts))
    kp = {k: np.asarray(v) for k, v in rollout_params_from_linen(params["params"]["roll"]).items()}
    return dict(mod=mod, params=params, t0s=np.array(t0s), dts=np.array(dts), kp=kp)


def _tp(kp):
    return {k: torch.from_numpy(v.copy()) for k, v in kp.items()}


def test_params_from_module_match_linen_split(ref):
    step = SDEStep(D)
    step.load_state_dict(params_from_flax(jax.tree.map(np.asarray, ref["params"]["params"]["roll"])))
    got = K.rollout_params_from_module(step)
    assert set(got) == set(K.PARAM_ORDER)
    for k in K.PARAM_ORDER:
        np.testing.assert_array_equal(got[k].numpy(), ref["kp"][k], err_msg=k)


@pytest.mark.parametrize("n", [13, 16])
def test_plain_matches_jax_kernel_explicit_noise(ref, n):
    """N=13 is no multiple of the JAX tile (8) and exercises its padding."""
    r = np.random.default_rng(n)
    y0 = r.standard_normal((n, D)).astype(np.float32)
    noise = r.standard_normal((TF, n, D)).astype(np.float32)
    want = jax_rollout(jnp.asarray(y0), {k: jnp.asarray(v) for k, v in ref["kp"].items()},
                       jnp.asarray(ref["t0s"]), jnp.asarray(ref["dts"]), jnp.int32(0),
                       num_steps=TF, block_rows=8, interpret=True, noise=jnp.asarray(noise))
    got = K.sde_rollout(torch.from_numpy(y0), _tp(ref["kp"]), torch.from_numpy(ref["t0s"]),
                        torch.from_numpy(ref["dts"]), 0, TF, noise=torch.from_numpy(noise))
    assert got.shape == (TF, n, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_matches_scan_with_diffusion_silenced(ref):
    y0 = np.random.default_rng(1).standard_normal((16, D)).astype(np.float32)
    sp = flax.core.unfreeze(ref["params"])
    sp["params"]["roll"]["g_func"]["dense_out"]["bias"] = (
        sp["params"]["roll"]["g_func"]["dense_out"]["bias"] - 1e4)
    _, want = ref["mod"].apply(sp, jnp.asarray(y0), (ref["t0s"], ref["dts"]),
                               rngs={"sde": jax.random.key(3)})
    kp = _tp(ref["kp"])
    kp["bgo"] = kp["bgo"] - 1e4
    got = K.sde_rollout(torch.from_numpy(y0), kp, torch.from_numpy(ref["t0s"]),
                        torch.from_numpy(ref["dts"]), 5, TF, increments="rademacher")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("increments", ["rademacher", "gaussian"])
def test_generator_moments_match_jax_gaussian_path(ref, increments):
    """Terminal mean/std per lane over 2048 rows from y0 = 0: the Monte
    Carlo error of the mean is ~std/sqrt(2048) ~ 0.025; 4 sigma is 0.1."""
    n = 2048
    want = jax_rollout(jnp.zeros((n, D)), {k: jnp.asarray(v) for k, v in ref["kp"].items()},
                       jnp.asarray(ref["t0s"]), jnp.asarray(ref["dts"]), jnp.int32(0),
                       num_steps=TF, block_rows=256, interpret=True,
                       noise=jax.random.normal(jax.random.key(5), (TF, n, D)))[-1]
    got = K.sde_rollout(torch.zeros((n, D)), _tp(ref["kp"]), torch.from_numpy(ref["t0s"]),
                        torch.from_numpy(ref["dts"]), 7, TF, increments=increments)[-1].numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.1)
    np.testing.assert_allclose(got.std(0), want.std(0), atol=0.1)


@pytest.mark.parametrize("increments", ["rademacher", "gaussian"])
def test_draws_are_seeded_and_tile_independent(increments):
    keys = K.seed_keys(123)
    rows = torch.arange(200)
    full = K.draw_increments(keys, rows, 4, 60, D, increments)
    again = K.draw_increments(keys, rows, 4, 60, D, increments)
    torch.testing.assert_close(full, again, rtol=0, atol=0)
    # a draw depends only on (seed, global row, step, lane): any row split agrees
    part = K.draw_increments(keys, rows[37:101], 4, 60, D, increments)
    torch.testing.assert_close(part, full[37:101], rtol=0, atol=0)
    other_seed = K.draw_increments(K.seed_keys(124), rows, 4, 60, D, increments)
    other_step = K.draw_increments(keys, rows, 5, 60, D, increments)
    assert (other_seed != full).float().mean() > 0.3
    assert (other_step != full).float().mean() > 0.3
    assert abs(full.mean().item()) < 0.05 and abs(full.var().item() - 1.0) < 0.05


def test_fmix32_tensor_matches_integer_arithmetic():
    vals = np.random.default_rng(0).integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    got = K._fmix32(torch.from_numpy(vals.astype(np.int64))).tolist()
    assert got == [K._fmix32_int(int(v)) for v in vals]


def test_wrapper_rejects_bad_inputs(ref):
    kp = _tp(ref["kp"])
    with pytest.raises(ValueError, match="increments"):
        K.sde_rollout(torch.zeros(4, D), kp, torch.zeros(TF), torch.full((TF,), 0.1), 0, TF,
                      increments="uniform")
    bad = dict(kp, wf1=kp["wf1"][:, :32])
    with pytest.raises(ValueError, match="wf1"):
        K.pack_params(bad)
    with pytest.raises(ValueError, match="meta"):
        K.sde_rollout(torch.zeros(4, D, device="meta"), kp, torch.zeros(TF),
                      torch.full((TF,), 0.1), 0, TF)


def test_registered_rollout_op_takes_the_seed_as_a_host_tensor(ref):
    """``trajsde::sde_rollout`` on CPU tensors, its seed a 0-d int64 host
    tensor, gives the plain version's bits for that seed as an int (the
    wrappers take either); any other seed tensor is refused."""
    kp = _tp(ref["kp"])
    w = K.pack_params(kp)
    y0 = torch.from_numpy(np.random.default_rng(4).standard_normal((9, D)).astype(np.float32))
    t0s, dts = torch.from_numpy(ref["t0s"]), torch.from_numpy(ref["dts"])
    want = K.sde_rollout_reference(y0, kp, t0s, dts, 7, TF, increments="rademacher")
    got = torch.ops.trajsde.sde_rollout(y0, w, t0s, dts, torch.tensor(7), TF, None, "rademacher")
    assert torch.equal(got, want)
    assert torch.equal(K.sde_rollout_packed(y0, w, t0s, dts, torch.tensor(7), TF, None,
                                            "rademacher"), want)
    assert not torch.equal(K.sde_rollout_packed(y0, w, t0s, dts, 8, TF, None, "rademacher"),
                           want)
    for bad in (torch.tensor([7]), torch.tensor(7, dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int64 tensor on the host"):
            K.sde_rollout_packed(y0, w, t0s, dts, bad, TF, None, "rademacher")
