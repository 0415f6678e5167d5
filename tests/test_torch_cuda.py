"""CUDA kernels of the port vs their plain versions (needs a card).

Imports no JAX, so it runs on a machine that has only the port:
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.
Tolerances: K1 1e-4 absolute over 60 f32 steps (``tanhf``, FMA
contraction and cuBLAS summation order differ from the plain version), and
``chip_smoke.TOL_K1_TIGHT`` of the largest magnitude (its products in
3xTF32 on the tensor cores), with its in-kernel increments held to the
plain version's draws;
K2 1e-4 of each output's largest magnitude for ``dy0`` and 1e-3 for the
weight gradients, which sum every row's contribution in another order;
K3 1e-4 of the largest magnitude (the same chain with its products in
3xTF32 on the tensor cores, another summation order and an online softmax); K4 as K2: 1e-4 of the
largest magnitude for ``dq`` and 1e-3 for the weight gradients; K5 as K3;
K6 per element, by ``vpu_probe.agreement``: in ulps of each plain value
within ``TOL_ULPS``, and a least share of bit-equal elements.  K4 and K2 are also held against their plain versions in f64.
K4's recomputed logits are held to K3's bit for bit, through check copies
of both built to write them.  K3 and K4 are tested at both of their head
counts, the flagship's 8 and the HiVT baseline's 4.  The feed to the card (``device_prefetch``)
is held to ``.to("cuda")`` bit for bit: its batches, and a train step.
A fused build's ``remat`` train step launches K3 twice and K4 once and
equals the plain build's step bit for bit.  The registered ops
``trajsde::sde_rollout`` and ``trajsde::aa_fused_fwd`` give their
launchers' bits, a fused train step through them is the step through the
launchers, and a ``FLAGSHIP_H100`` artifact exported on the card answers
with the live scan engine's bits.  Endpoint K-means on the card gives the
CPU's assignments, and a converted reference checkpoint restores onto the
card bit for bit.  K3b and K4b, the bf16 forms of K3 and K4, are held to
their plain versions within ``chip_smoke.TOL_K3B`` / ``TOL_K4B`` (max, and
mean at the twin shape), and K4b's recomputed logits to K3b's bit for bit.
"""
import ctypes
import functools
from pathlib import Path

import pytest
import torch

from trajsde_tpu_torch.models.local_encoder import AAEncoder
from trajsde_tpu_torch.models.sde import SDEStep, decoder_time_grid
from trajsde_tpu_torch.ops import aa_attention as K5
from trajsde_tpu_torch.ops import aa_fused as K3
from trajsde_tpu_torch.ops import sde_rollout as K
from trajsde_tpu_torch.ops import vpu_probe as K6

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


def _rollout_case(cuda, n, seed):
    """K1's weights, time grid, y0 and explicit noise at ``n`` rows."""
    gen = torch.Generator().manual_seed(seed)
    step = SDEStep(64)
    for p in step.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    kp = {k: v.contiguous().to(cuda) for k, v in K.rollout_params_from_module(step).items()}
    t0s, dts = decoder_time_grid(60, 6.0, device=cuda)
    y0 = torch.randn((n, 64), generator=gen).to(cuda)
    noise = torch.randn((60, n, 64), generator=gen).to(cuda)
    return kp, t0s, dts, y0, noise


def _increments_kw(mode, noise):
    return dict(noise=noise, increments="gaussian") if mode == "explicit" else dict(increments=mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["explicit", "rademacher", "gaussian"])
@pytest.mark.parametrize("n", [1, 33, 480, 1000])
def test_rollout_kernel_within_the_tight_tolerance(cuda, mode, n):
    """K1 (its five products in 3xTF32) within ``chip_smoke.TOL_K1_TIGHT``
    of the plain version, as a fraction of max|plain|, which a copy with one
    TF32 product per term fails: one row, a ragged 32-row tile (33), bucket
    1's 480 rows (15 tiles) and 1000 (a ragged 32nd tile)."""
    from chip_smoke import TOL_K1_TIGHT

    kp, t0s, dts, y0, noise = _rollout_case(cuda, n, n + 3)
    kw = _increments_kw(mode, noise)
    got = K.sde_rollout(y0, kp, t0s, dts, 42, 60, **kw)
    torch.cuda.synchronize()
    want = K.sde_rollout_reference(y0, kp, t0s, dts, 42, 60, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < TOL
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL_K1_TIGHT


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["explicit", "rademacher", "gaussian"])
def test_rollout_kernel_runs_are_bit_equal(cuda, mode):
    kp, t0s, dts, y0, noise = _rollout_case(cuda, 1000, 17)
    kw = _increments_kw(mode, noise)
    got = K.sde_rollout(y0, kp, t0s, dts, 42, 60, **kw)
    again = K.sde_rollout(y0, kp, t0s, dts, 42, 60, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("increments", ["rademacher", "gaussian"])
def test_rollout_kernel_draws_the_plain_versions_increments(cuda, increments):
    """With the five matrices, wgo and bf2 zeroed there is no drift and
    g = sigmoid(bgo) for every row, so from y0 = 0 each step adds
    g sqrt(dt) z: (ys[t] - ys[t-1]) / (g sqrt(dt)) is the kernel's
    increment, and at N = 1000 every one equals the plain version's
    ``draw_increments`` within 1e-5 (the rounding of y and of g)."""
    kp, t0s, dts, y0, _ = _rollout_case(cuda, 1000, 5)
    for k in ("wf0", "wf1", "wf2", "wg0", "wg1", "wgo", "bf2"):
        kp[k] = torch.zeros_like(kp[k])
    y0 = torch.zeros_like(y0)
    ys = K.sde_rollout(y0, kp, t0s, dts, 42, 60, increments=increments)
    torch.cuda.synchronize()
    g = 1.0 / (1.0 + torch.exp(-kp["bgo"].double()[0, 0]))
    sdt = K.time_table(t0s, dts)[:, 3].double()
    prev = torch.cat([y0[None], ys[:-1]]).double()
    rows = torch.arange(1000, device=cuda)
    keys = K.seed_keys(42)
    for t in range(60):
        z = (ys[t].double() - prev[t]) / (g * sdt[t])
        want = K.draw_increments(keys, rows, t, 60, 64, increments).double()
        assert (z - want).abs().max().item() <= 1e-5, t


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


# the fused kernels' head counts: the flagship's 8 and the HiVT baseline's 4
HEADS = [8, 4]


def _aa_encoder(seed, heads):
    gen = torch.Generator().manual_seed(seed)
    enc = AAEncoder(21, 64, heads, fused=True)
    for p in enc.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.3
    return enc


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 2, 7, 70), (1, 21, 49, 48)])
def test_aa_fused_kernel_matches_plain(cuda, shape, with_keep, heads):
    """Ragged chunks and receiver groups, Aq != Ak, a receiver with no
    sender (and the last with one); the encoder's packed weights with the
    w1 blocks off the diagonal filled in, so the full [2D, 2D] product
    counts."""
    B, T, Aq, Ak = shape
    gen = torch.Generator().manual_seed(sum(shape) + with_keep)
    packed = K3.pack_aa_params(_aa_encoder(Ak, heads))
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
        keep, p = (torch.rand((B, T, Aq, Ak, heads), generator=gen) >= 0.1).float().to(cuda), 0.1
    before = K3.fused_pair_attention.launches
    got = K3.fused_pair_attention(q, u, mask, keep, ws, heads, p)
    again = K3.fused_pair_attention(q, u, mask, keep, ws, heads, p)
    torch.cuda.synchronize()
    assert K3.fused_pair_attention.launches == before + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[0, 0, 0] == 0).all()                     # no sender: exactly 0
    want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, heads, p)
    assert ((got - want).abs().max() / want.abs().max()).item() < TOL


def _k4_case(cuda, shape, with_keep, heads):
    """K3's test inputs (a receiver with no sender, w1 off-diagonal blocks
    filled in) plus a random cotangent."""
    B, T, Aq, Ak = shape
    gen = torch.Generator().manual_seed(sum(shape) + 2 * with_keep + 1)
    packed = K3.pack_aa_params(_aa_encoder(Ak + 1, heads))
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
        keep, p = (torch.rand((B, T, Aq, Ak, heads), generator=gen) >= 0.1).float().to(cuda), 0.1
    g = torch.randn((B, T, Aq, 64), generator=gen).to(cuda)
    return q, u, mask, keep, ws, g, p


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 2, 7, 70), (1, 21, 49, 48)])
def test_aa_fused_bwd_kernel_matches_plain(cuda, shape, with_keep, heads):
    """K4 vs autograd through the plain chain: dq within 1e-4 of max|plain|
    (plus 1e-6: with one sender the exact dq is 0), each weight gradient
    within 1e-3 of its max|plain| (summed over every pair in another
    order); bit-equal reruns; an empty receiver gets exactly 0."""
    q, u, mask, keep, ws, g, p = _k4_case(cuda, shape, with_keep, heads)
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, heads, p)
    before = K3.fused_pair_attention_bwd.launches
    dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, heads, p, out=out,
                                          stats=stats)
    dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, heads, p, out=out,
                                            stats=stats)
    torch.cuda.synchronize()
    assert K3.fused_pair_attention_bwd.launches == before + 2
    assert torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert (dq[0, 0, 0] == 0).all()
    want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, heads, p)
    assert torch.isfinite(dq).all() and all(torch.isfinite(d).all() for d in dws)
    assert (dq - want_dq).abs().max().item() <= 1e-4 * want_dq.abs().max().item() + 1e-6
    for name, got, w, x in zip(K3.W_ORDER, dws, want, ws):
        assert got.shape == x.shape, name
        assert ((got - w).abs().max() / w.abs().max()).item() < 1e-3, name


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 2, 7, 70), (1, 21, 49, 48)])
def test_aa_fused_bf16_kernel_matches_plain(cuda, shape, with_keep, heads):
    """K3b (the bf16 chain, with ln_mm) vs its plain version on K3's test
    inputs: within ``chip_smoke.TOL_K3B`` of max|plain|, and of mean|plain|
    at the twin shape (in a handful of outputs one value on the other side
    of a bf16 tie moves the mean); counted as K3b, not K3; bit-equal
    reruns; an empty receiver gives exactly 0."""
    from chip_smoke import TOL_K3B

    B, T, Aq, Ak = shape
    gen = torch.Generator().manual_seed(sum(shape) + with_keep)
    packed = K3.pack_aa_params(_aa_encoder(Ak, heads))
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
        keep, p = (torch.rand((B, T, Aq, Ak, heads), generator=gen) >= 0.1).float().to(cuda), 0.1
    before = (K3.fused_pair_attention.launches, K3.fused_pair_attention.bf16_launches)
    got = K3.fused_pair_attention(q, u, mask, keep, ws, heads, p, "bfloat16")
    again = K3.fused_pair_attention(q, u, mask, keep, ws, heads, p, "bfloat16")
    torch.cuda.synchronize()
    assert (K3.fused_pair_attention.launches,
            K3.fused_pair_attention.bf16_launches) == (before[0], before[1] + 2)
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[0, 0, 0] == 0).all()
    want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, heads, p,
                                             compute_dtype="bfloat16")
    d = (got - want).abs()
    assert (d.max() / want.abs().max()).item() <= TOL_K3B[0]
    if shape[1:] == (21, 49, 48):
        assert (d.mean() / want.abs().mean()).item() <= TOL_K3B[1]


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 2, 7, 70), (1, 21, 49, 48)])
def test_aa_fused_bwd_bf16_kernel_matches_plain(cuda, shape, with_keep, heads):
    """K4b vs autograd through the plain bf16 chain on K4's test inputs:
    each output within ``chip_smoke.TOL_K4B`` of its max|plain| (plus 1e-6:
    with one sender the exact dq is 0), and of its mean|plain| at the twin
    shape; counted as K4b; bit-equal reruns; an empty receiver gets 0."""
    from chip_smoke import TOL_K4B

    q, u, mask, keep, ws, g, p = _k4_case(cuda, shape, with_keep, heads)
    bf = dict(compute_dtype="bfloat16")
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, heads, p, **bf)
    before = (K3.fused_pair_attention_bwd.launches, K3.fused_pair_attention_bwd.bf16_launches)
    dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, heads, p, out=out,
                                          stats=stats, **bf)
    dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, heads, p, out=out,
                                            stats=stats, **bf)
    torch.cuda.synchronize()
    assert (K3.fused_pair_attention_bwd.launches,
            K3.fused_pair_attention_bwd.bf16_launches) == (before[0], before[1] + 2)
    assert torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert (dq[0, 0, 0] == 0).all()
    want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, heads, p, **bf)
    assert torch.isfinite(dq).all() and all(torch.isfinite(d).all() for d in dws)
    for name, got, w in zip(("dq", *K3.W_ORDER), (dq, *dws), (want_dq, *want)):
        assert got.shape == w.shape, name
        d = (got - w).abs()
        assert d.max().item() <= TOL_K4B[0] * w.abs().max().item() + 1e-6, name
        if shape[1:] == (21, 49, 48):
            assert d.mean().item() <= TOL_K4B[1] * w.abs().mean().item() + 1e-6, name


@functools.cache
def _logit_copies():
    """Check copies of K3 and K4 built with ``AA_WRITE_LOGITS`` defined, so
    that each writes every pair's head logits ``[R * Ak, H]`` (-inf where
    masked) to a buffer: K3 the ones its softmax takes, K4 the ones its
    recompute gives."""
    from trajsde_tpu_torch.ops import build

    out_dir = Path(build.BUILD_DIR) / "logits"
    sources = {}
    for name in ("aa_fused", "aa_fused_bwd"):
        cu = out_dir / name / f"{name}.cu"
        cu.parent.mkdir(parents=True, exist_ok=True)
        source = (Path(build.CSRC_DIR) / f"{name}.cu").read_text()
        cu.write_text("#define AA_WRITE_LOGITS\n" + source)
        sources[name] = str(cu)
    libs = build.build_copies(sources, str(out_dir))
    fwd, bwd = K3.configure_fwd(libs["aa_fused"][0]), K3.configure_bwd(libs["aa_fused_bwd"][0])
    fwd.aa_fused_set_logits.argtypes = [ctypes.c_void_p]
    bwd.aa_fused_bwd_set_logits.argtypes = [ctypes.c_void_p]
    return fwd, bwd


def _logits_of_both(cuda, heads, compute_dtype="float32"):
    """With keep, at B = 8 of the flagship's training twin shape (8 heads)
    or of the baseline's (4 heads, Aq = Ak = 48): K3's logits, K4's
    recomputed ones, K3's output and statistics (from the check copies) and
    the output of the shipped K3 on the same inputs (K3b's and K4b's in
    bf16)."""
    fwd, bwd = _logit_copies()
    shape = (8, 21, 49, 48) if heads == 8 else (8, 21, 48, 48)
    q, u, mask, keep, ws, g, p = _k4_case(cuda, shape, True, heads)
    rows = q.shape[0] * q.shape[1] * q.shape[2] * u.shape[3]
    lg3 = torch.full((rows, heads), float("nan"), device=cuda)
    lg4 = torch.full((rows, heads), float("nan"), device=cuda)
    dt = dict(compute_dtype=compute_dtype)
    assert fwd.aa_fused_set_logits(lg3.data_ptr()) == 0
    out, stats = K3.launch_fwd(fwd, q, u, mask, keep, ws, heads, p, with_stats=True, **dt)
    assert bwd.aa_fused_bwd_set_logits(lg4.data_ptr()) == 0
    K3.launch_bwd(bwd, q, u, mask, keep, ws, g, out, stats, heads, p, **dt)
    shipped = K3.fused_pair_attention(q, u, mask, keep, ws, heads, p, **dt)
    torch.cuda.synchronize()
    return lg3, lg4, out, stats, shipped


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
def test_aa_fused_bwd_recomputes_k3s_logits_bit_for_bit(cuda, heads):
    """K4's recompute (F1-F4) takes K3's products and epilogues, so every
    logit it recomputes is the one K3's softmax took, bit for bit; writing
    the logits changes nothing else (the check copy's output is the shipped
    K3's)."""
    lg3, lg4, out, _, shipped = _logits_of_both(cuda, heads)
    assert not torch.isnan(lg3).any() and not torch.isnan(lg4).any()   # every pair written
    assert torch.isinf(lg3).any() and torch.isfinite(lg3).any()
    assert torch.equal(lg3, lg4)
    assert torch.equal(out, shipped)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
def test_aa_fused_bwd_bf16_recomputes_k3bs_logits_bit_for_bit(cuda, heads):
    """K4b's recompute takes K3b's bf16 products and epilogues, so its
    logits are the ones K3b's softmax took, bit for bit, and K3b's softmax
    max is their max."""
    lg3, lg4, out, stats, shipped = _logits_of_both(cuda, heads, "bfloat16")
    assert not torch.isnan(lg3).any() and not torch.isnan(lg4).any()
    assert torch.equal(lg3, lg4)
    assert torch.equal(out, shipped)
    assert torch.equal(stats[0], lg4.view(stats.shape[1], -1, heads).amax(dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
def test_aa_fused_stats_max_is_the_max_of_k4s_recomputed_logits(cuda, heads):
    """K3's softmax statistics: the running max of each (receiver, head) is
    the largest of the logits K4 recomputes for it (-inf for a receiver
    with no sender)."""
    _, lg4, _, stats, _ = _logits_of_both(cuda, heads)
    R = stats.shape[1]
    assert torch.equal(stats[0], lg4.view(R, -1, heads).amax(dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_keep", [False, True])
def test_autograd_through_the_fused_op_on_cuda_matches_the_cpu(cuda, with_keep, heads):
    """``fused_pair_attention`` with gradients on the card (K3 + K4 through
    ``FusedPairAttentionFn``) vs the same call on the CPU (the plain
    forward and backward); no gradient reaches u, mask or keep."""
    q, u, mask, keep, ws, g, p = _k4_case(cuda, (2, 3, 9, 48), with_keep, heads)
    grads = {}
    for dev in ("cuda", "cpu"):
        qd = q.detach().to(dev).requires_grad_()
        wd = tuple(w.detach().to(dev).requires_grad_() for w in ws)
        ud = u.detach().to(dev).requires_grad_()
        kd = None if keep is None else keep.to(dev)
        before = (K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
        out = K3.fused_pair_attention(qd, ud, mask.to(dev), kd, wd, heads, p)
        out.backward(g.to(dev))
        launched = (K3.fused_pair_attention.launches - before[0],
                    K3.fused_pair_attention_bwd.launches - before[1])
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
        assert ud.grad is None
        grads[dev] = (out.detach().cpu(), qd.grad.cpu(), [w.grad.cpu() for w in wd])
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    assert rel(grads["cuda"][0], grads["cpu"][0]) < TOL
    assert rel(grads["cuda"][1], grads["cpu"][1]) < 1e-4
    for name, a, b in zip(K3.W_ORDER, grads["cuda"][2], grads["cpu"][2]):
        assert rel(a, b) < 1e-3, name


def _k5_case(cuda, shape, seed, heads=8):
    """``test_aa_kernel.py``'s input scales at ``shape``; every 7th receiver
    without a sender; the encoder's packed weights with the w1 blocks off
    the diagonal filled in."""
    B, T, Aq, Ak = shape
    gen = torch.Generator().manual_seed(seed)
    packed = K3.pack_aa_params(_aa_encoder(seed, heads))
    packed["w1"] = packed["w1"] + 0.1 * torch.randn(packed["w1"].shape, generator=gen)
    packed = {k: v.contiguous().to(cuda) for k, v in packed.items()}
    center = torch.randn((B, T, Aq, 64), generator=gen)
    x_k = torch.randn((B, T, Ak, 2), generator=gen)
    pos_q = 20.0 * torch.randn((B, T, Aq, 2), generator=gen)
    pos_k = pos_q[:, :, torch.arange(Ak) % Aq] + 5.0 * torch.randn((B, T, Ak, 2), generator=gen)
    ang = (torch.rand((B, Aq), generator=gen) * 2.0 - 1.0) * 3.14159
    rot = torch.stack([ang.cos(), -ang.sin(), ang.sin(), ang.cos()], dim=-1)
    mask = torch.rand((B, T, Aq, Ak), generator=gen) > 0.4
    mask[:, :, ::7] = False
    args = tuple(x.contiguous().to(cuda) for x in (center, x_k, pos_q, pos_k, rot, mask))
    return args, packed


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("shape", [(1, 1, 2, 1), (2, 5, 9, 8), (3, 7, 13, 11), (2, 3, 5, 70),
                                   (1, 21, 49, 48)])
def test_aa_attention_kernel_matches_plain(cuda, shape, heads):
    """K5 vs its plain version and vs K3 fed the same q and u, within
    ``chip_smoke.TOL_K3_TIGHT`` of max|plain| (K3's chain and products; q by
    the kernel's own FMAs); ragged groups and chunks, Ak > Aq; bit-equal
    reruns; empty receivers exactly 0."""
    from chip_smoke import TOL_K3_TIGHT

    args, packed = _k5_case(cuda, shape, sum(shape), heads)
    before = K5.aa_attention.launches
    got = K5.aa_attention(*args, packed, heads)
    again = K5.aa_attention(*args, packed, heads)
    torch.cuda.synchronize()
    assert K5.aa_attention.launches == before + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    assert (got[:, :, ::7] == 0).all()
    want = K5.aa_attention_reference(*args, packed, heads)
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL_K3_TIGHT
    center, x_k, pos_q, pos_k, rot, mask = args
    q = (center @ packed["wq"] + packed["bq"][0]).contiguous()
    u = K3.build_pair_features(x_k, pos_k[:, :, None] - pos_q[:, :, :, None], rot).contiguous()
    k3 = K3.fused_pair_attention(q, u, mask.float(), None, K3.weights_of(packed), heads)
    assert ((got - k3).abs().max() / want.abs().max()).item() <= TOL_K3_TIGHT


@pytest.mark.gpu
def test_aa_attention_wrapper_rejects(cuda):
    args, packed = _k5_case(cuda, (1, 2, 3, 4), 5)
    center, x_k, pos_q, pos_k, rot, mask = args
    bad = {
        "mask float": (center, x_k, pos_q, pos_k, rot, mask.float()),
        "x_k shape": (center, x_k[:, :, :3].contiguous(), pos_q, pos_k, rot, mask),
        "rot 2x2": (center, x_k, pos_q, pos_k, rot.view(1, 3, 2, 2), mask),
        "pos_q f64": (center, x_k, pos_q.double(), pos_k, rot, mask),
        "centre not contiguous": (center.transpose(1, 2).contiguous().transpose(1, 2), x_k,
                                  pos_q, pos_k, rot, mask),
        "pos_k on the cpu": (center, x_k, pos_q, pos_k.cpu(), rot, mask),
        "D 32": (center[..., :32].contiguous(), x_k, pos_q, pos_k, rot, mask),
    }
    before = K5.aa_attention.launches
    for name, case in bad.items():
        with pytest.raises((ValueError, TypeError)):
            K5.aa_attention(*case, packed, 8)
    with pytest.raises(ValueError):
        K5.aa_attention(*args, packed, 2)                  # H = 2: built for 8 and 4 only
    with pytest.raises(ValueError):
        K5.aa_attention(*bad["D 32"], packed, 4)           # D 32 at 4 heads
    with pytest.raises(NotImplementedError):
        K5.aa_attention(*args, packed, 8, compute_dtype="bfloat16")
    assert K5.aa_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(K6.VARIANTS))
@pytest.mark.parametrize("shape", [(2048, 128), (3, 8)])
def test_vpu_probe_kernel_matches_plain(cuda, variant, shape):
    """K6 vs its plain version over 64 rounds, per element, by
    ``agreement`` (its limits' comment gives the reasons)."""
    dtype, approx = K6.VARIANTS[variant]
    gen = torch.Generator().manual_seed(shape[0])
    x = (0.1 * torch.randn(shape, generator=gen)).to(device=cuda, dtype=dtype)
    before = K6.chained_tanh.launches
    got = K6.chained_tanh(x, approx)
    torch.cuda.synchronize()
    assert K6.chained_tanh.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert K6.agreement(got, K6.chained_tanh_reference(x), variant)["ok"]


@pytest.mark.gpu
def test_vpu_probe_wrapper_rejects(cuda):
    before = K6.chained_tanh.launches
    with pytest.raises(TypeError):
        K6.chained_tanh(torch.zeros(64, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        K6.chained_tanh(torch.zeros(12, device=cuda, dtype=torch.bfloat16))   # not 8 | n
    with pytest.raises(ValueError):
        K6.chained_tanh(torch.zeros((8, 16), device=cuda).t())                # not contiguous
    with pytest.raises(ValueError):
        K6.chained_tanh(torch.zeros(9, device=cuda)[1:])                      # not 16-byte aligned
    with pytest.raises(ValueError):
        K6.chained_tanh(torch.zeros(64, device=cuda, dtype=torch.bfloat16), True)  # f32 only
    assert K6.chained_tanh.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
def test_aa_fused_bwd_kernel_within_the_f64_gradient(cuda, heads):
    """K4 and the f32 plain backward against the plain backward in f64 at
    B = 8 of the flagship's training twin shape (8 heads) or the baseline's
    (4 heads, Aq = Ak = 48) with a keep mask, as a fraction of
    max|f64| per leaf.  dq and the leaves that no ReLU derivative reaches
    (wagg and everything after it) are smooth functions of the inputs: K4
    no more than 2x farther than the f32 plain version (plus 1e-7).  The
    leaves behind a ReLU's derivative jump where a pre-ReLU value is 0 to
    within rounding, and an f32 evaluation, K4's or the plain one's, may
    land on the other side than f64 for a few elements (up to 1.1e-3 of
    max|f64| seen on an H100 at this shape): both within 2e-3."""
    shape = (8, 21, 49, 48) if heads == 8 else (8, 21, 48, 48)
    q, u, mask, keep, ws, g, p = _k4_case(cuda, shape, True, heads)
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, heads, p)
    dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, heads, p, out=out,
                                          stats=stats)
    del out, stats
    p_dq, p_dws = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, heads, p)
    o_dq, o_dws = K3.fused_pair_attention_bwd_reference(
        q.double(), u.double(), mask.double(), keep.double(), [w.double() for w in ws],
        g.double(), heads, p)
    rel = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()  # noqa: E731
    errs = {name: (rel(a, o), rel(b, o)) for name, a, b, o in
            zip(("dq", *K3.W_ORDER), (dq, *dws), (p_dq, *p_dws), (o_dq, *o_dws))}
    behind_relu = set(K3.W_ORDER[:K3.W_ORDER.index("wagg")])
    assert all(max(k4, plain) < 2e-3 if name in behind_relu else k4 <= 2.0 * plain + 1e-7
               for name, (k4, plain) in errs.items()), errs


def _rollout_bwd_f64_ratios(cuda, seed: int) -> dict:
    """leaf -> (K2's distance from the f64 plain backward, the f32 plain
    version's), as fractions of max|f64|, at 2,048 rows x 60 steps with
    gaussian increments, weights, y0 and the cotangent drawn from ``seed``
    and the forward states ``ys`` made by K1."""
    gen = torch.Generator().manual_seed(seed)
    step = SDEStep(64)
    for p in step.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    kp = {k: v.contiguous().to(cuda) for k, v in K.rollout_params_from_module(step).items()}
    w = K.pack_params(kp)
    t0s, dts = decoder_time_grid(60, 6.0, device=cuda)
    y0 = torch.randn((2048, 64), generator=gen).to(cuda)
    ct = torch.randn((60, 2048, 64), generator=gen).to(cuda)
    ys = K.sde_rollout_packed(y0, w, t0s, dts, 42, 60, None, "gaussian")
    dy0, dw = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 42, 60)
    got = {"dy0": dy0, **K.unpack_params(dw, 64)}
    p_dy0, p_g = K.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 42, 60)
    o_dy0, o_g = K.sde_rollout_bwd_reference(y0.double(), ys.double(), ct.double(),
                                             {k: v.double() for k, v in kp.items()}, t0s, dts,
                                             42, 60)
    plain, oracle = {"dy0": p_dy0, **p_g}, {"dy0": o_dy0, **o_g}
    rel = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()  # noqa: E731
    return {k: (rel(got[k], oracle[k]), rel(plain[k], oracle[k])) for k in oracle}


def _within_4x_of_plain(errs: dict) -> bool:
    median = sorted(p for _, p in errs.values())[len(errs) // 2]
    return all(k2 <= 4.0 * max(p, median) for k2, p in errs.values())


@pytest.mark.gpu
def test_rollout_bwd_kernel_within_the_f64_gradient(cuda):
    """K2 and the f32 plain backward against the plain backward in f64 at
    2,048 rows x 60 steps with gaussian increments, as a fraction of
    max|f64| per output (dy0 and the 14 weight gradients): K2 no more than
    4x the f32 plain version's distance, floored at the median of its
    distances over the 15 outputs.  The floor keeps a leaf where the plain
    version lands unusually near f64 from holding K2 to a lucky draw
    (``tests/test_torch_sde_rollout_tf32.py``).  4x, not the 2x of the CPU
    model: on the card the plain version's products are cuBLAS's f32 FMA
    chains, rounded to nearest, and K2's sums run in another order.  K2's
    products run on the f64 tensor cores and it carries lambda in f64; in
    3xTF32, whose tensor cores cut
    each addend toward zero, an H100 put K2 at up to 7.8x here (bg1, at
    this seed) and at up to 4.9x at the training shape, and the earlier FMA
    build of K2 at up to 13x (``scripts/check_rollout_bwd_f64_torch.py``).
    A copy with one TF32 product per term is 100-1000x."""
    errs = _rollout_bwd_f64_ratios(cuda, 21)
    assert _within_4x_of_plain(errs), errs


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(20, 28))
def test_rollout_bwd_kernel_within_the_f64_gradient_over_seeds(cuda, seed):
    """The check above at seeds 20-27, each with ``ys`` from K1 (the states
    K2 reads in training): the CPU model of K2's arithmetic meets 2x of the
    plain distance at every one of them (``tests/test_torch_sde_rollout_tf32.py``,
    mode ``f64tc-lambda``).  K2's 3xTF32 build put 4 of these 16 readings
    past 4x, and its f64 products with lambda kept in f32 put seed 25's bgo
    at 7.6x (``scripts/check_rollout_bwd_f64_inputs_torch.py``, ys from K1
    and from the plain forward)."""
    errs = _rollout_bwd_f64_ratios(cuda, seed)
    assert _within_4x_of_plain(errs), errs


def _packed(seed, B, A, L):
    import numpy as np

    from trajsde_tpu_torch.data.grid import align_to_grid
    from trajsde_tpu_torch.data.pack import pack_scenes
    from trajsde_tpu_torch.data.synthetic import make_raw_scene

    rng = np.random.default_rng(seed)
    return pack_scenes([align_to_grid(make_raw_scene(rng, i % 2, num_actors=A, num_lanes=L))
                        for i in range(B)], A, L)


@pytest.mark.gpu
def test_device_prefetch_batches_equal_their_cpu_originals(cuda, monkeypatch):
    """Over 3 x (size + 1) batches of each of two shapes, every batch the
    feed puts on the card equals ``.to("cuda")`` of its stripped CPU
    original, read on the compute stream right after it arrives.

    The copy stream lags: each field's copy from its pinned buffer waits
    behind a 5 ms spin on that stream, while the consumer enqueues its
    reads without waiting on the host.  So the feed's thread laps the ring
    within the first batch's copies, and a slot refilled before the event
    behind all of its copies has completed shows as a batch that differs."""
    import dataclasses

    from trajsde_tpu_torch.data.scene import strip_for_device
    from trajsde_tpu_torch.train.loop import device_prefetch

    to = torch.Tensor.to

    def lagging_to(self, *args, **kwargs):
        if kwargs.get("non_blocking") and self.is_pinned():
            torch.cuda._sleep(10_000_000)   # on the current (copy) stream
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", lagging_to)
    size = 2
    bases = [_packed(1, 128, 48, 192), _packed(2, 64, 16, 64)]
    cpu = []
    for i in range(2 * 3 * (size + 1)):
        b = bases[i % 2]
        cpu.append(dataclasses.replace(b, x=b.x + i, lane_positions=b.lane_positions - i))
    seen = []
    for got in device_prefetch(cpu, cuda, size=size):
        seen.append({f.name: getattr(got, f.name).clone() for f in dataclasses.fields(got)
                     if getattr(got, f.name) is not None})
        del got
    torch.cuda.synchronize()
    assert len(seen) == len(cpu)
    for i, (got, want) in enumerate(zip(seen, cpu)):
        want = strip_for_device(want).to(cuda)
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            assert (w is None) == (f.name not in got), (i, f.name)
            if w is not None:
                assert got[f.name].is_cuda and torch.equal(got[f.name], w), (i, f.name)


@pytest.mark.gpu
def test_train_step_fed_by_the_prefetcher_equals_one_fed_by_to(cuda):
    """Two fused-encoder training steps on batches the feed copied equal,
    bit for bit, the same steps on ``.to("cuda")`` copies (same seeds)."""
    from trajsde_tpu_torch.config import FLAGSHIP_TRAIN_FUSED, build_losses, build_model
    from trajsde_tpu_torch.train.loop import (create_train_state, device_prefetch,
                                              make_train_step)

    cfg = FLAGSHIP_TRAIN_FUSED
    batches = [_packed(s, 8, 48, 192) for s in (3, 4)]
    results = []
    for fed in (True, False):
        model = build_model(cfg, device=cuda, seed=5)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=2, seed=1)
        step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), cuda)
        source = device_prefetch(batches, cuda) if fed else (b.to(cuda) for b in batches)
        totals = [step(b, k, 1)["train/total"] for k, b in enumerate(source)]
        results.append((totals, {k: v.clone() for k, v in model.state_dict().items()}))
    (ta, pa), (tb, pb) = results
    assert len(ta) == len(tb) == 2 and all(torch.equal(a, b) for a, b in zip(ta, tb))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.gpu
def test_engine_predict_and_submit_equal_a_plain_copy_path(cuda, monkeypatch):
    """The serving engine's pinned copies in and out, on the card: pipelined
    ``predict`` of 44 scenes at max_batch 8 (five batches of bucket 8, one
    of bucket 4) equals, bit for bit, the same serve function fed by
    ``.to("cuda")`` and read back by ``.cpu()`` with the same ``(seed,
    counter)`` draws; so does the serial path, and one ``submit``.  Each
    copy from a pinned buffer waits behind a 5 ms spin on the copy stream,
    so a slot refilled early, or a batch read before its copy, shows."""
    import numpy as np

    from trajsde_tpu_torch.config import FLAGSHIP_FUSED, build_model
    from trajsde_tpu_torch.data.pack import pack_scenes, pick_bucket
    from trajsde_tpu_torch.data.synthetic import make_raw_scene
    from trajsde_tpu_torch.server import ServingEngine, align_scene, mix_seed

    rng = np.random.default_rng(8)
    raws = [make_raw_scene(rng, i % 2, num_actors=48, num_lanes=192) for i in range(44)]
    model = build_model(FLAGSHIP_FUSED, device=cuda, seed=6)
    engines = [ServingEngine(model, num_actors=48, num_lanes=192, device=cuda, max_batch=8,
                             seed=3) for _ in range(3)]
    to = torch.Tensor.to

    def lagging_to(self, *args, **kwargs):
        if kwargs.get("non_blocking") and self.is_pinned():
            torch.cuda._sleep(10_000_000)   # on the current (copy) stream
        return to(self, *args, **kwargs)

    try:
        monkeypatch.setattr(torch.Tensor, "to", lagging_to)
        piped = engines[0].predict(raws)
        serial = engines[1].predict(raws, pipeline=False)
        submitted = engines[2].submit(raws[0]).result(timeout=300)
        monkeypatch.undo()
    finally:
        for e in engines:
            e.close()
    def plain(chunk, counter):
        aligned = [align_scene(r)[0] for r in chunk]
        bucket = pick_bucket(len(aligned), engines[0].buckets)
        scene = pack_scenes(aligned + [aligned[-1]] * (bucket - len(aligned)), 48, 192).to(cuda)
        seed = mix_seed(3, counter)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        with torch.inference_mode():
            post = engines[0]._post(scene, engines[0]._serve(scene, seed, generator=gen))
        post = {k: v.cpu().numpy() for k, v in post.items()}
        return [{"agent_world": post["agent_world"][j], "agent_pi": post["agent_pi"][j],
                 "loc": post["loc"][j], "pi": post["pi_all"][j]} for j in range(len(chunk))]

    want = [r for i in range(0, len(raws), 8) for r in plain(raws[i:i + 8], i // 8 + 1)]
    assert len(piped) == len(serial) == len(want) == 44
    for got, ref in ((piped, want), (serial, want), ([submitted], plain(raws[:1], 1))):
        for g, w in zip(got, ref):
            for k in w:
                assert np.array_equal(g[k], w[k]), k


@pytest.mark.gpu
def test_capped_dense_aa_at_the_largest_degree_equals_dense_and_counts_overflow(cuda):
    """``FLAGSHIP_CAPPED`` (``neighbor_cap``, the dense AA path) on the card
    at batch 16, 48 actors: at the batch's largest in-radius degree the
    forward (pinned encoder and twin noise, the same rollout seed) is the
    uncapped model's within ``chip_smoke.TOL_CAPPED`` of max|dense|; at cap 24
    ``aa_overflow_edges`` is numpy's count from the masks; a train step
    launches K1 and K2 once and K3 / K4 never."""
    import copy

    import numpy as np

    from chip_smoke import CAP, TOL_CAPPED, numpy_overflow
    from trajsde_tpu_torch.config import FLAGSHIP_CAPPED, build_losses, build_model
    from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

    cfg = copy.deepcopy(FLAGSHIP_CAPPED)
    cfg["decoder"]["kwargs"]["fused"] = True
    capped = build_model(cfg, device=cuda, seed=7)
    dense_cfg = copy.deepcopy(cfg)
    dense_cfg["encoder"]["kwargs"]["neighbor_cap"] = 0
    dense = build_model(dense_cfg, device=cuda, seed=7)
    scene = _packed(9, 16, 48, 192).to(cuda)
    overflow, _, max_deg = numpy_overflow(scene, 50.0, CAP)
    assert overflow > 0 and max_deg < 48
    gen = torch.Generator(device=cuda).manual_seed(2)
    en = torch.randn((21, 16, 49, 64), generator=gen, device=cuda)
    tw = torch.randn((16, 1, 21, 2), generator=gen, device=cuda)
    exact = copy.deepcopy(capped)
    exact.encoder.aa_encoder.neighbor_cap = max_deg
    with torch.no_grad():
        want = dense(scene, enc_noise=en, twin_noise=tw, rollout_seed=4)
        got = exact(scene, enc_noise=en, twin_noise=tw, rollout_seed=4)
        assert int(exact.encoder.aa_encoder.aa_overflow_edges) == 0
        for k in ("loc", "pi"):
            assert (got[k] - want[k]).abs().max() <= TOL_CAPPED * want[k].abs().max(), k
        capped(scene, enc_noise=en, twin_noise=tw, rollout_seed=4)
    assert int(capped.encoder.aa_encoder.aa_overflow_edges) == overflow
    state = create_train_state(capped, cfg["training_specific"], steps_per_epoch=1)
    step = make_train_step(capped, state.optimizer, state.scheduler, build_losses(cfg), cuda)
    before = (K.sde_rollout.launches, K.sde_rollout_bwd.launches,
              K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
    logs = step(scene, 0, 0)
    after = (K.sde_rollout.launches, K.sde_rollout_bwd.launches,
             K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
    assert np.isfinite(float(logs["train/total"])) and logs["train/step_skipped"] == 0.0
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)


@pytest.mark.gpu
def test_accum_update_grads_are_the_mean_of_the_micro_batches_alone_bit_for_bit(cuda):
    """One accum-2 update of ``FLAGSHIP_TRAIN_FUSED`` (K1-K4, dropout live) on
    two batches of 8 at 48 actors: its gradients are (g1 + g2) / 2 of the two
    micro-batches run alone with the same seeds, bit for bit (K2's and K4's
    weight gradients add into ``.grad``), and K1-K4 launch once per
    micro-batch."""
    from chip_smoke import _micro_alone
    from trajsde_tpu_torch.config import FLAGSHIP_TRAIN_FUSED, build_losses, build_model
    from trajsde_tpu_torch.train.loop import create_train_state, make_train_step, micro_seeds

    cfg = FLAGSHIP_TRAIN_FUSED
    losses = build_losses(cfg)
    micro = [_packed(s, 8, 48, 192).to(cuda) for s in (11, 12)]
    model = build_model(cfg, device=cuda, seed=8).train()
    alone = []
    for scene, s in zip(micro, micro_seeds(K.mix_seed(3, 5), 2)):
        model.zero_grad(set_to_none=True)
        _micro_alone(model, losses, scene, s)
        alone.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=3)
    step = make_train_step(model, state.optimizer, state.scheduler, losses, cuda)
    counters = (K.sde_rollout, K.sde_rollout_bwd, K3.fused_pair_attention,
                K3.fused_pair_attention_bwd)
    before = [c.launches for c in counters]
    step(micro, 5, 3)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2, 2]
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(alone[0]) == set(alone[1])
    for n in got:
        assert torch.equal(got[n], (alone[0][n] + alone[1][n]) / 2), n


@pytest.mark.gpu
def test_bf16_flagship_train_step_launches_k1_k2_once_and_stays_f32(cuda):
    """``FLAGSHIP_BF16`` (``configs/nusargo/*_tpu.yml``) with the fused
    decoder at batch 8, 48 actors: each of two train steps launches K1 and K2
    once (on the f32 rows the bf16 fuse is cast to) and K3 / K4 never, the
    loss is finite, and every parameter, gradient and AdamW moment is f32."""
    import copy

    import numpy as np

    from trajsde_tpu_torch.config import FLAGSHIP_BF16, build_losses, build_model
    from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

    cfg = copy.deepcopy(FLAGSHIP_BF16)
    cfg["decoder"]["kwargs"]["fused"] = True
    model = build_model(cfg, device=cuda, seed=5)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=2)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg), cuda)
    scene = _packed(13, 8, 48, 192).to(cuda)
    counters = (K.sde_rollout, K.sde_rollout_bwd, K3.fused_pair_attention,
                K3.fused_pair_attention_bwd)
    for i in range(2):
        before = [c.launches for c in counters]
        logs = step(scene, i, 0)
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
        assert np.isfinite(float(logs["train/total"])) and logs["train/step_skipped"] == 0.0
    moments = [v for s in state.optimizer.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.float32 for m in moments)
    for p in model.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["FLAGSHIP_TRAIN_FUSED", "BASELINE_TRAIN"])
def test_remat_fused_step_runs_k3_twice_and_k4_once_and_is_the_plain_step(cuda, name):
    """``encoder.remat: true`` on a fused build at batch 8, 48 actors,
    dropout live: one train step launches K3 twice (the forward and the
    recompute) and K4 once, and its loss, gradients and CUDA generator end
    where the plain build's step leaves them, bit for bit."""
    import copy

    from trajsde_tpu_torch import config as tconfig

    cfg = getattr(tconfig, name)
    remat_cfg = copy.deepcopy(cfg)
    remat_cfg["encoder"]["kwargs"]["remat"] = True
    losses = tconfig.build_losses(cfg)
    scene = _packed(14, 8, 48, 192).to(cuda)
    results = {}
    for r, c in ((False, cfg), (True, remat_cfg)):
        model = tconfig.build_model(c, device=cuda, seed=6).train()
        gen = torch.Generator(device=cuda).manual_seed(9)
        before = (K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
        out = model(scene, generator=gen, rollout_seed=4)
        loss = sum(w * fn(out["y"], out) for _, w, fn in losses)
        loss.backward()
        torch.cuda.synchronize()
        after = (K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((2, 1) if r else (1, 1))
        results[r] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                      gen.get_state())
    (loss_r, grads_r, gen_r), (loss_p, grads_p, gen_p) = results[True], results[False]
    assert torch.equal(loss_r, loss_p) and torch.equal(gen_r, gen_p)
    for n, g in grads_p.items():
        assert (g is None) == (grads_r[n] is None), n
        assert g is None or torch.equal(grads_r[n], g), n


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["explicit", "rademacher", "gaussian"])
def test_rollout_op_on_cuda_is_the_direct_launcher_bit_for_bit(cuda, mode):
    """``trajsde::sde_rollout`` on CUDA tensors, its seed a 0-d int64 host
    tensor, launches K1 once and gives the bits of the launcher called with
    the seed as an int."""
    kp, t0s, dts, y0, noise = _rollout_case(cuda, 1000, 23)
    kw = _increments_kw(mode, noise)
    w = K.pack_params(kp)
    before = K.sde_rollout.launches
    got = K.rollout_op(y0, w, t0s, dts, torch.tensor(42), 60, kw["noise"] if "noise" in kw
                       else None, kw["increments"])
    torch.cuda.synchronize()
    assert K.sde_rollout.launches == before + 1
    want = K._launch(y0, w, t0s, dts, 42, 60, kw.get("noise"), kw["increments"])
    assert torch.equal(got, want)
    assert torch.equal(K.sde_rollout(y0, kp, t0s, dts, 42, 60, **kw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("with_stats", [False, True])
def test_aa_fused_op_on_cuda_is_the_direct_launcher_bit_for_bit(cuda, heads, with_stats):
    """``trajsde::aa_fused_fwd`` on CUDA tensors launches K3 once and gives
    the launcher's ``out`` (and ``stats``) bits; without stats it returns an
    empty tensor in their place."""
    q, u, mask, keep, ws, _, p = _k4_case(cuda, (2, 3, 5, 4), True, heads)
    before = K3.fused_pair_attention.launches
    out, stats = K3.aa_fused_op(q, u, mask, keep, list(ws), heads, p, with_stats)
    torch.cuda.synchronize()
    assert K3.fused_pair_attention.launches == before + 1
    want_out, want_stats = K3.launch_fwd(K3._library(), q, u, mask, keep, ws, heads, p,
                                         with_stats)
    assert torch.equal(out, want_out)
    assert torch.equal(stats, want_stats) if with_stats else stats.numel() == 0


@pytest.mark.gpu
def test_fused_train_step_through_the_ops_is_the_direct_launchers_step(cuda, monkeypatch):
    """One ``FLAGSHIP_TRAIN_FUSED`` train step at batch 8, dropout live: the
    loss and every gradient through the registered ops equal, bit for bit,
    the same step with K1 and K3 called straight from their launchers and
    the seed an int (the path before the ops); K1-K4 launch once each."""
    from trajsde_tpu_torch import config as tconfig

    cfg = tconfig.FLAGSHIP_TRAIN_FUSED
    losses = tconfig.build_losses(cfg)
    scene = _packed(15, 8, 48, 192).to(cuda)

    def step():
        model = tconfig.build_model(cfg, device=cuda, seed=6).train()
        gen = torch.Generator(device=cuda).manual_seed(9)
        before = (K.sde_rollout.launches, K.sde_rollout_bwd.launches,
                  K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
        out = model(scene, generator=gen, rollout_seed=4)
        loss = sum(w * fn(out["y"], out) for _, w, fn in losses)
        loss.backward()
        torch.cuda.synchronize()
        after = (K.sde_rollout.launches, K.sde_rollout_bwd.launches,
                 K3.fused_pair_attention.launches, K3.fused_pair_attention_bwd.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss_op, grads_op = step()
    monkeypatch.setattr(K, "sde_rollout_packed",
                        lambda y0, w, t0s, dts, seed, n, noise=None, inc="gaussian":
                        K._launch(y0, w, t0s, dts, int(seed), n, noise, inc))
    monkeypatch.setattr(K3, "fused_pair_attention_fwd",
                        lambda q, u, mask, keep, ws, heads, p=0.0, dt="float32", ln_mm=True:
                        K3._launch(q, u, mask, keep, ws, heads, p, True, dt, ln_mm))
    loss_direct, grads_direct = step()
    assert torch.equal(loss_op, loss_direct)
    for n, g in grads_op.items():
        assert (g is None) == (grads_direct[n] is None), n
        assert g is None or torch.equal(grads_direct[n], g), n


@pytest.mark.gpu
def test_exported_fused_flagship_on_cuda_is_the_live_scan_engine(cuda, tmp_path):
    """``FLAGSHIP_H100`` (K3 and K1 inside) exported on the card at 8 actors
    and 16 lanes, buckets 1 and 2: ``from_export`` answers three scenes with
    the live scan engine's bits at the same seed, K1 and K3 once per batch."""
    import numpy as np

    from trajsde_tpu_torch.config import FLAGSHIP_H100, build_model
    from trajsde_tpu_torch.data.pack import pack_scenes
    from trajsde_tpu_torch.data.synthetic import make_raw_scene
    from trajsde_tpu_torch.deploy import export_serving
    from trajsde_tpu_torch.server import ServingEngine, align_scene

    rng = np.random.default_rng(3)
    raws = [make_raw_scene(rng, i % 2, num_actors=6, num_lanes=12) for i in range(3)]
    model = build_model(FLAGSHIP_H100, device=cuda, seed=2)
    manifest = export_serving(model, pack_scenes([align_scene(raws[0])[0]], 8, 16),
                              str(tmp_path), buckets=(1, 2))
    assert manifest["ops"] == ["trajsde::aa_fused_fwd", "trajsde::sde_rollout"]
    live = ServingEngine(model, num_actors=8, num_lanes=16, device=cuda, engine="scan",
                         batch_buckets=(1, 2), seed=4)
    exported = ServingEngine.from_export(str(tmp_path), device=cuda, seed=4)
    try:
        want = live.predict(raws)
        before = (K.sde_rollout.launches, K3.fused_pair_attention.launches)
        got = exported.predict(raws)
        after = (K.sde_rollout.launches, K3.fused_pair_attention.launches)
    finally:
        live.close()
        exported.close()
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2)
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.gpu
def test_kmeans_endpoints_on_cuda_is_the_cpu_result(cuda):
    """Endpoint K-means on a CUDA tensor, initial centres pinned: the CPU
    assignments, and centres within 1e-5 (the cluster sums add in another
    order on the card)."""
    from trajsde_tpu_torch.utils.clustering import kmeans_endpoints

    gen = torch.Generator().manual_seed(0)
    trajs = torch.randn(400, 12, 2, generator=gen) * 5
    init_idx = torch.randperm(400, generator=gen)[:6]
    want_assign, want_centers = kmeans_endpoints(trajs, k=6, init_idx=init_idx)
    assign, centers = kmeans_endpoints(trajs.to(cuda), k=6, init_idx=init_idx)
    assert assign.device.type == centers.device.type == "cuda"
    assert torch.equal(assign.cpu(), want_assign)
    torch.testing.assert_close(centers.cpu(), want_centers, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_converted_checkpoint_loads_onto_the_card_bit_for_bit(cuda, tmp_path):
    """``FLAGSHIP_H100``'s seeded weights under the reference's names,
    converted on the CPU and written as a weights-only step, restore into a
    model on the card with the seeded bits."""
    from trajsde_tpu_torch.config import FLAGSHIP_H100, build_model
    from trajsde_tpu_torch.train.checkpoint import CheckpointManager, save_weights
    from trajsde_tpu_torch.utils.convert import convert_state_dict, to_reference

    seeded = build_model(FLAGSHIP_H100, device="cpu", seed=2).state_dict()
    ref = to_reference(seeded, FLAGSHIP_H100)
    weights, report = convert_state_dict(ref, FLAGSHIP_H100,
                                         build_model(FLAGSHIP_H100, device="cpu"))
    assert report == {"skipped": [], "unused": []}
    path = save_weights(weights, str(tmp_path / "step_00000000"))
    model = build_model(FLAGSHIP_H100, device=cuda, seed=7)
    CheckpointManager(str(tmp_path)).restore_params(model, path)
    got = model.state_dict()
    assert all(got[k].device.type == "cuda" and torch.equal(got[k].cpu(), v)
               for k, v in seeded.items())


@pytest.mark.gpu
@pytest.mark.parametrize("increments", ["rademacher", "gaussian"])
def test_rollout_kernels_with_device_keys_are_the_host_key_launches_bit_for_bit(cuda,
                                                                                increments):
    """K1 and K2 reading their keys from a device ``rollout_keys`` buffer
    (the chained step's form) give the host-key launches' bits at the
    training shape (61,440 rows x 60 steps), and each launch counts once."""
    kp, t0s, dts, y0, _ = _rollout_case(cuda, 61_440, 21)
    w = K.pack_params(kp)
    ct = torch.randn((60,) + tuple(y0.shape), device=cuda)
    seed = K.mix_seed(7, 3)
    keys = K.rollout_keys(seed, cuda)
    before = (K.sde_rollout.launches, K.sde_rollout_bwd.launches)
    ys = K.sde_rollout_packed(y0, w, t0s, dts, seed, 60, increments=increments)
    ys_keys = K.sde_rollout_packed(y0, w, t0s, dts, keys, 60, increments=increments)
    bwd = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, seed, 60, increments=increments)
    bwd_keys = K.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, keys, 60, increments=increments)
    torch.cuda.synchronize()
    assert (K.sde_rollout.launches - before[0], K.sde_rollout_bwd.launches - before[1]) == (2, 2)
    assert torch.equal(ys, ys_keys)
    assert torch.equal(bwd[0], bwd_keys[0]) and torch.equal(bwd[1], bwd_keys[1])


def _chained_states(cuda, cfg, chains, accum, graphs):
    """``chains`` (a list of chains, each a list of groups) through one
    chained step of a seeded ``cfg`` model: (each chain's logs, the
    kernels' launches, weights, AdamW state, schedule)."""
    from trajsde_tpu_torch.config import build_losses, build_model
    from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state

    model = build_model(cfg, device=cuda, seed=6)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=8, seed=4)
    step = ChainedStep(model, state.optimizer, state.scheduler, build_losses(cfg), cuda,
                       accum_steps=accum, graphs=graphs)
    counters = (K.sde_rollout, K.sde_rollout_bwd, K3.fused_pair_attention,
                K3.fused_pair_attention_bwd)
    before = [c.launches for c in counters]
    logs = []
    for chain in chains:
        step(chain, state.step, state.seed)
        state.step += len(chain)
        logs.append(step.chain_logs.clone())
    launches = [c.launches - b for c, b in zip(counters, before)]
    return (logs, launches, {k: v.clone() for k, v in model.state_dict().items()},
            state.optimizer.state_dict(), state.scheduler.state_dict(), len(step.captured))


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_graphed_chain_is_the_uncaptured_chained_step_bit_for_bit(cuda, accum):
    """``FLAGSHIP_TRAIN_FUSED`` (K1-K4, dropout live) at 48 actors: two
    chains over two batch layouts (8 and 4 scenes; each layout's first
    update runs uncaptured and is captured, the rest replay, the graphs
    share a pool), the second with a NaN planted in its second update,
    equal the uncaptured chained step's logs, weights, moments and
    schedule bit for bit, and K1-K4 count once per micro-batch under
    replay."""
    import dataclasses

    from trajsde_tpu_torch.config import FLAGSHIP_TRAIN_FUSED

    big = [_packed(s, 8, 48, 192).to(cuda) for s in range(31, 35)]
    small = [_packed(s, 4, 48, 192).to(cuda) for s in range(41, 45)]
    bad = dataclasses.replace(big[3], x=big[3].x.clone())
    bad.x[0, 1, 3, 0] = float("nan")
    if accum == 1:
        chains = [[[big[0]], [small[0]], [big[1]]], [[small[1]], [bad], [big[2]]]]
    else:
        chains = [[big[:2], small[:2], big[2:]], [small[2:], [big[0], bad], big[1:3]]]
    got = _chained_states(cuda, FLAGSHIP_TRAIN_FUSED, chains, accum, True)
    want = _chained_states(cuda, FLAGSHIP_TRAIN_FUSED, chains, accum, False)
    logs, launches, weights, opt, sched, captured = got
    assert captured == 2 and want[5] == 0
    micro = sum(len(g) for c in chains for g in c)
    assert launches == [micro] * 4 == want[1]
    assert logs[1][1, -1].item() == 1.0 and logs[0][:, -1].sum().item() == 0.0
    for a, b in zip(logs, want[0]):
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    assert all(torch.equal(weights[k], want[2][k]) for k in weights)
    assert opt["state"].keys() == want[3]["state"].keys()
    assert all(torch.equal(opt["state"][i][k], want[3]["state"][i][k])
               for i in opt["state"] for k in opt["state"][i])
    assert sched == want[4] and sched["last_epoch"] == sum(len(c) for c in chains) - 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["FLAGSHIP_BF16_CAPPED", "FLAGSHIP_BF16_FUSED", "BASELINE_TRAIN"])
def test_graphed_chain_of_every_build_is_the_uncaptured_chain_bit_for_bit(cuda, name):
    """``_tpu_fast.yml``, ``_tpu.yml``'s fused fallback (K3b / K4b) and the
    fused baseline (K3 / K4 at 4 heads), dropout live, at 48 actors: a
    chain over two batch layouts (8 and 4 scenes, each captured after its
    first update, the graphs sharing a pool) equals the uncaptured chained
    step's logs and weights bit for bit, its kernels count once per update
    under replay, and the capped block's ``aa_overflow_edges`` is None
    after each chain, also where an eager forward set it before."""
    from trajsde_tpu_torch import config
    from trajsde_tpu_torch.config import build_losses, build_model
    from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state

    cfg = getattr(config, name)
    big = [_packed(s, 8, 48, 192).to(cuda) for s in range(51, 54)]
    small = [_packed(s, 4, 48, 192).to(cuda) for s in range(61, 64)]
    chains = [[big[0], small[0], big[1]], [small[1], big[2], small[2]]]
    counters = (K3.fused_pair_attention, K3.fused_pair_attention_bwd)
    runs = []
    for graphs in (True, False):
        model = build_model(cfg, device=cuda, seed=6)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=8, seed=4)
        step = ChainedStep(model, state.optimizer, state.scheduler, build_losses(cfg), cuda,
                           accum_steps=1, graphs=graphs)
        before = [getattr(c, a) for c in counters for a in ("launches", "bf16_launches")]
        logs = []
        for chain in chains:
            step(chain, state.step, state.seed)
            state.step += len(chain)
            logs.append(step.chain_logs.clone())
            aa = model.encoder.aa_encoder
            if aa.neighbor_cap:
                assert aa.aa_overflow_edges is None
                with torch.no_grad():   # an eager forward sets it; the next chain clears it
                    model.eval()(chain[-1])
                assert int(aa.aa_overflow_edges) > 0
        after = [getattr(c, a) for c in counters for a in ("launches", "bf16_launches")]
        runs.append((logs, {k: v.clone() for k, v in model.state_dict().items()},
                     [b - a for a, b in zip(before, after)], len(step.captured)))
    (logs, weights, launches, captured), want = runs
    assert captured == 2 and want[3] == 0
    for a, b in zip(logs, want[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(weights[k], want[1][k]) for k in weights)
    fused = bool(cfg["encoder"]["kwargs"].get("fused"))
    bf16 = config.build_dtype(cfg) == "bfloat16"
    n = 6 * fused
    assert launches == want[2] == [0 if bf16 else n, n if bf16 else 0] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("name,options", [("FLAGSHIP_TRAIN_FUSED", ("remat",)),
                                          ("FLAGSHIP_BF16_FUSED", ("remat",)),
                                          ("FLAGSHIP_H100", ("adaptive",)),
                                          ("FLAGSHIP_TRAIN_FUSED", ("remat", "adaptive"))])
def test_graphed_chain_with_remat_or_adaptive_is_the_uncaptured_chain_bit_for_bit(cuda, name,
                                                                                    options):
    """``encoder.remat`` (the recompute's dropout from a replay state of its
    own, ``remat.ReplayTape``) and ``encoder.adaptive`` (the tree nodes from
    the chain's generators), dropout live, at 48 actors: a chain over two
    batch layouts (8 and 4 scenes, each captured after its first update)
    equals the uncaptured chained step's logs and weights bit for bit, with
    K3 (K3b) twice an update under remat and K4 (K4b) once, under replay;
    under remat each graph's tape holds the AA and the AL block."""
    import copy

    from trajsde_tpu_torch import config
    from trajsde_tpu_torch.config import build_losses, build_model
    from trajsde_tpu_torch.train.loop import ChainedStep, create_train_state

    cfg = copy.deepcopy(getattr(config, name))
    for option in options:
        cfg["encoder"]["kwargs"][option] = True
    big = [_packed(s, 8, 48, 192).to(cuda) for s in range(71, 74)]
    small = [_packed(s, 4, 48, 192).to(cuda) for s in range(81, 84)]
    chains = [[big[0], small[0], big[1]], [small[1], big[2], small[2]]]
    counters = (K3.fused_pair_attention, K3.fused_pair_attention_bwd)
    runs = []
    for graphs in (True, False):
        model = build_model(cfg, device=cuda, seed=6)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=8, seed=4)
        step = ChainedStep(model, state.optimizer, state.scheduler, build_losses(cfg), cuda,
                           accum_steps=1, graphs=graphs)
        before = [getattr(c, a) for c in counters for a in ("launches", "bf16_launches")]
        logs = []
        for chain in chains:
            step(chain, state.step, state.seed)
            state.step += len(chain)
            logs.append(step.chain_logs.clone())
        after = [getattr(c, a) for c in counters for a in ("launches", "bf16_launches")]
        runs.append((logs, {k: v.clone() for k, v in model.state_dict().items()},
                     [b - a for a, b in zip(before, after)], step))
    (logs, weights, launches, step), want = runs
    assert len(step.captured) == 2 and len(step.graph_nodes) == 2 and not want[3].captured
    assert all(len(e.tape.blocks) == 2 * ("remat" in options) for e in step.captured.values())
    for a, b in zip(logs, want[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(weights[k], want[1][k]) for k in weights)
    bf16 = config.build_dtype(cfg) == "bfloat16"
    fwd, bwd = (12 if "remat" in options else 6), 6
    assert launches == want[2] == ([0, fwd, 0, bwd] if bf16 else [fwd, 0, bwd, 0])
