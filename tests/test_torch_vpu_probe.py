"""The elementwise-rate probe (kernel K6's plain version) vs the JAX probe's
own kernel body on the CPU.

``scripts/bench_vpu_dtype.py::_kernel`` runs here on jnp arrays, op by op,
on the probe's input (``normal(0, 0.1)`` from numpy's seed 0), and
``chained_tanh_reference`` on the same values, compared element by
element: the values span 3e-8 to 6e18 after 64 rounds.  bf16 is bit-equal
(both round a correctly rounded f32 tanh to bf16).  f32 is within
``TOL_F32_ULPS`` ulps of each JAX value: both round every operation to
f32, but XLA's and PyTorch's tanh differ in the last bit, and the rounds
carry each difference on (up to 266 ulps observed, mean 5.5).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajsde_tpu_torch.ops import vpu_probe as K6

torch.set_num_threads(1)
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_vpu_dtype.py"
TOL_F32_ULPS = 512


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe script, imported by path; it sets a compilation cache
    directory on import, which is put back."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("bench_vpu_dtype", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return module


class _Ref:
    """A stand-in for a Pallas ref: ``ref[:]`` reads and writes ``value``."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value

    def __setitem__(self, idx, value):
        self.value = value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_tanh_reference_matches_the_jax_kernel_body(jax_probe, dtype):
    x = np.random.default_rng(0).normal(0, 0.1, (256, 128))
    out = _Ref()
    jax_probe._kernel(_Ref(jnp.asarray(x, dtype)), out)
    want = np.asarray(out.value.astype(jnp.float32))
    assert K6.ROUNDS == jax_probe.ROUNDS
    got = K6.chained_tanh_reference(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e3  # the positive values grow
    want = torch.from_numpy(want.copy()).to(got.dtype)
    if dtype == "bfloat16":
        assert torch.equal(got, want)
    else:
        assert K6.ulps(got, want).max().item() <= TOL_F32_ULPS


def test_chained_tanh_on_cpu_launches_nothing():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 0.1, (16, 128)).astype(np.float32))
    before = K6.chained_tanh.launches
    y = K6.chained_tanh(x)
    assert K6.chained_tanh.launches == before
    assert torch.equal(y, K6.chained_tanh_reference(x))
    assert torch.equal(K6.chained_tanh(x, approx_f32_tanh=True), y)
    with pytest.raises(ValueError):
        K6.chained_tanh(x.bfloat16(), approx_f32_tanh=True)
    assert K6.chained_tanh.launches == before


def test_ulps_counts_in_the_last_place_of_each_value():
    want = torch.tensor([1.0, 0.75, -3.0, 1e18, 0.0])
    got = want + torch.tensor([2.0 ** -23, 2.0 ** -24, -3 * 2.0 ** -22, 2.0 ** 36, 2.0 ** -24])
    assert K6.ulps(got, want).tolist() == [1.0, 1.0, 3.0, 1.0, 1.0]
    want_bf16 = torch.tensor([1.0, 0.75, 0.0], dtype=torch.bfloat16)
    got_bf16 = torch.tensor([1.0078125, 0.7578125, 2.0 ** -8], dtype=torch.bfloat16)
    assert K6.ulps(got_bf16, want_bf16).tolist() == [1.0, 2.0, 1.0]


def test_agreement_rejects_zeroed_negatives_and_too_few_bit_equal():
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.1, (512, 128)).astype(np.float32))
    want = K6.chained_tanh_reference(x)
    assert K6.agreement(want, want, "float32") == dict(max_ulps=0.0, bit_equal=1.0, ok=True)
    assert not K6.agreement(want.clamp(min=0), want, "float32")["ok"]
    # every element within one ulp, but only 40% of them bit-equal
    _, exp = torch.frexp(want)
    nudged = want + torch.where(torch.arange(want.numel()).reshape(want.shape) % 5 < 3,
                                torch.ldexp(torch.ones_like(want), exp - 24), 0.0)
    reading = K6.agreement(nudged, want, "float32")
    assert reading["max_ulps"] == 1.0 and abs(reading["bit_equal"] - 0.4) < 1e-3
    assert not reading["ok"]
    assert K6.agreement(nudged[:4], want[:4], "float32")["ok"]  # too few elements to count
