"""CUDA kernels of the port vs their plain versions (needs a card).

Imports no JAX, so it runs on a machine that has only the port:
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.
Tolerances: K1 1e-4 absolute over 60 f32 steps (``tanhf``, FMA
contraction and cuBLAS summation order differ from the plain version);
K2 1e-4 of each output's largest magnitude for ``dy0`` and 1e-3 for the
weight gradients, which sum every row's contribution in another order;
K3 1e-4 of the largest magnitude (the same f32 chain with FMA contraction,
another summation order and an online softmax).
"""
import pytest
import torch

from trajsde_tpu_torch.models.local_encoder import AAEncoder
from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid
from trajsde_tpu_torch.ops import aa_fused as K3
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


def _aa_encoder(seed):
    gen = torch.Generator().manual_seed(seed)
    enc = AAEncoder(21, 64, 8, fused=True)
    for p in enc.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.3
    return enc


@pytest.mark.gpu
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 2, 7, 70), (1, 21, 49, 48)])
def test_aa_fused_kernel_matches_plain(cuda, shape, with_keep):
    """Ragged chunks and receiver groups, Aq != Ak, a receiver with no
    sender (and the last with one); the encoder's packed weights with the
    w1 blocks off the diagonal filled in, so the full [2D, 2D] product
    counts."""
    B, T, Aq, Ak = shape
    gen = torch.Generator().manual_seed(sum(shape) + with_keep)
    packed = K3.pack_aa_params(_aa_encoder(Ak))
    packed["w1"] = packed["w1"] + 0.1 * torch.randn(packed["w1"].shape, generator=gen)
    ws = tuple(w.contiguous().to(cuda) for w in K3.weights_of(packed))
    q = torch.randn((B, T, Aq, 64), generator=gen).to(cuda)
    u = (5.0 * torch.randn((B, T, Aq, Ak, 4), generator=gen)).to(cuda)
    mask = (torch.rand((B, T, Aq, Ak), generator=gen) < 0.6).float()
    mask[0, 0, 0] = 0.0
    mask[0, 0, -1, 0] = 1.0
    mask = mask.to(cuda)
    keep, p = None, 0.0
    if with_keep:
        keep, p = (torch.rand((B, T, Aq, Ak, 8), generator=gen) >= 0.1).float().to(cuda), 0.1
    before = K3.fused_pair_attention.launches
    got = K3.fused_pair_attention(q, u, mask, keep, ws, 8, p)
    again = K3.fused_pair_attention(q, u, mask, keep, ws, 8, p)
    torch.cuda.synchronize()
    assert K3.fused_pair_attention.launches == before + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[0, 0, 0] == 0).all()                     # no sender: exactly 0
    want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, 8, p)
    assert ((got - want).abs().max() / want.abs().max()).item() < TOL


@pytest.mark.gpu
def test_aa_fused_kernel_raises_when_gradients_are_needed(cuda):
    enc = _aa_encoder(0).to(cuda)
    ws = K3.weights_of(K3.pack_aa_params(enc, detach=False))
    q = torch.randn((1, 2, 3, 64), device=cuda)
    u = torch.randn((1, 2, 3, 4, 4), device=cuda)
    mask = torch.ones((1, 2, 3, 4), device=cuda)
    before = K3.fused_pair_attention.launches
    with pytest.raises(NotImplementedError, match="K4"):
        K3.fused_pair_attention(q, u, mask, None, ws, 8)
    with pytest.raises(NotImplementedError, match="K4"):
        K3.fused_pair_attention(q.requires_grad_(), u, mask, None,
                                tuple(w.detach() for w in ws), 8)
    assert K3.fused_pair_attention.launches == before
    with torch.no_grad():
        K3.fused_pair_attention(q, u, mask, None, ws, 8)
    assert K3.fused_pair_attention.launches == before + 1
