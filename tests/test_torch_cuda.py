"""CUDA kernels of the port vs their plain versions (needs a card).

Imports no JAX, so it runs on a machine that has only the port:
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.
Tolerances: K1 1e-4 absolute over 60 f32 steps (``tanhf``, FMA
contraction and cuBLAS summation order differ from the plain version);
K2 1e-4 of each output's largest magnitude for ``dy0`` and 1e-3 for the
weight gradients, which sum every row's contribution in another order.
"""
import pytest
import torch

from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid
from trajsde_tpu_torch.ops import sde_rollout as K

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["explicit", "rademacher", "gaussian"])
@pytest.mark.parametrize("n", [1, 1000])
def test_rollout_kernel_matches_plain(cuda, mode, n):
    gen = torch.Generator().manual_seed(n)
    step = SDEStep(64)
    for p in step.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    kp = {k: v.contiguous().to(cuda) for k, v in K.rollout_params_from_module(step).items()}
    t0s, dts = decoder_time_grid(60, 6.0, device=cuda)
    y0 = torch.randn((n, 64), generator=gen).to(cuda)
    noise = torch.randn((60, n, 64), generator=gen).to(cuda) if mode == "explicit" else None
    inc = "gaussian" if mode == "explicit" else mode
    before = K.sde_rollout.launches
    got = K.sde_rollout(y0, kp, t0s, dts, 42, 60, noise=noise, increments=inc)
    torch.cuda.synchronize()
    assert K.sde_rollout.launches == before + 1
    want = K.sde_rollout_reference(y0, kp, t0s, dts, 42, 60, noise=noise, increments=inc)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["explicit", "rademacher", "gaussian"])
@pytest.mark.parametrize("n", [1, 1000])
def test_rollout_bwd_kernel_matches_plain(cuda, mode, n):
    gen = torch.Generator().manual_seed(n + 7)
    step = SDEStep(64)
    for p in step.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    kp = {k: v.contiguous().to(cuda) for k, v in K.rollout_params_from_module(step).items()}
    w = K.pack_params(kp)
    t0s, dts = decoder_time_grid(60, 6.0, device=cuda)
    y0 = torch.randn((n, 64), generator=gen).to(cuda)
    ct = torch.randn((60, n, 64), generator=gen).to(cuda)
    noise = torch.randn((60, n, 64), generator=gen).to(cuda) if mode == "explicit" else None
    inc = "gaussian" if mode == "explicit" else mode
    ys = K.sde_rollout_packed(y0, w, t0s, dts, 42, 60, noise, inc)
    before = K.sde_rollout_bwd.launches
    dy0, dw = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 42, 60, noise, inc)
    again = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 42, 60, noise, inc)
    torch.cuda.synchronize()
    assert K.sde_rollout_bwd.launches == before + 2
    assert torch.equal(dy0, again[0]) and torch.equal(dw, again[1])   # fixed-order sums
    want_dy0, want = K.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 42, 60, noise, inc)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    assert rel(dy0, want_dy0) < 1e-4
    got = K.unpack_params(dw, 64)
    for k in K.PARAM_ORDER:
        assert rel(got[k], want[k]) < 1e-3, k
