"""Fused AA pair chain, forward kernel K3: wrapper, plain PyTorch version
and packed parameters.

Counterpart of ``trajsde_tpu/ops/pallas/aa_fused.py::fused_pair_attention``
(forward: ``_fwd_call`` -> ``_fwd_kernel`` -> ``pair_chain``) and of
``aa_attention.py::pack_aa_params``.  Per (receiver, sender) pair the chain
embeds the 4 rotated pair features ``u`` through the packed two-branch MLP
to keys and values, takes a masked per-head softmax over the senders and
returns the pre-gating aggregate ``[B, T, Aq, D]``.  The node-wise stages
around it (q projection, gating, ``out_proj``) stay in the encoder.

On a CUDA tensor :func:`fused_pair_attention` launches the hand-written
kernel in ``csrc/aa_fused.cu`` (built by nvcc at first use, bound with
ctypes); on a CPU tensor it runs :func:`fused_pair_attention_reference`.
Nothing falls back from one to the other.  The kernel has no backward yet:
a CUDA call that would need gradients raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch

NEG = -1e9
LN_EPS = 1e-5
# packed weight order (aa_fused.py W_ORDER); matrices [in, out], vectors [1, n]
W_ORDER = (
    "wu", "bu", "ln0s", "ln0b", "w1", "b1",
    "lna0s", "lna0b", "wagg", "bagg", "lna1s", "lna1b",
    "wkv", "bkv",
)
# the kernel's widths (csrc/aa_fused.cu)
KERNEL_DIM, KERNEL_HEADS = 64, 8


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def pack_aa_params(aa_encoder, detach: bool = True) -> Dict[str, torch.Tensor]:
    """An ``AAEncoder``'s ``nbr_embed`` / ``attn`` weights in the kernel's
    packed layout (``pack_aa_params`` of the JAX package, plus ``wq`` /
    ``bq``): ``wu [4, 2D]`` holds the two ``Linear(2 -> D)`` first layers
    block-diagonally (rows 0-1 -> lanes ``[:D]``, the sender features; rows
    2-3 -> ``[D:]``, the edge), ``w1 [2D, 2D]`` the two ``Linear(D -> D)``
    second layers, ``wkv = [lin_k | lin_v]``.  Built with ``cat`` and
    slicing, so ``detach=False`` keeps every block in the autograd graph."""
    nbr, attn = aa_encoder.nbr_embed, aa_encoder.attn
    cut = (lambda x: x.detach()) if detach else (lambda x: x)  # noqa: E731
    t = lambda lin: cut(lin.weight).t()  # noqa: E731
    b = lambda mod: cut(mod.bias)[None]  # noqa: E731
    s = lambda ln: cut(ln.weight)[None]  # noqa: E731

    def block_diag(top, bottom):
        zt = top.new_zeros((top.shape[0], bottom.shape[1]))
        zb = bottom.new_zeros((bottom.shape[0], top.shape[1]))
        return torch.cat([torch.cat([top, zt], 1), torch.cat([zb, bottom], 1)], 0)

    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    return dict(
        wu=block_diag(t(nbr.in0_dense0), t(nbr.in1_dense0)),
        bu=cat(b(nbr.in0_dense0), b(nbr.in1_dense0)),
        ln0s=cat(s(nbr.in0_ln0), s(nbr.in1_ln0)),
        ln0b=cat(b(nbr.in0_ln0), b(nbr.in1_ln0)),
        w1=block_diag(t(nbr.in0_dense1), t(nbr.in1_dense1)),
        b1=cat(b(nbr.in0_dense1), b(nbr.in1_dense1)),
        lna0s=s(nbr.aggr_ln0), lna0b=b(nbr.aggr_ln0),
        wagg=t(nbr.aggr_dense), bagg=b(nbr.aggr_dense),
        lna1s=s(nbr.aggr_ln1), lna1b=b(nbr.aggr_ln1),
        wq=t(attn.lin_q), bq=b(attn.lin_q),
        wkv=cat(t(attn.lin_k), t(attn.lin_v)),
        bkv=cat(b(attn.lin_k), b(attn.lin_v)),
    )


def weights_of(packed: Dict[str, torch.Tensor]) -> tuple:
    """The 14 pair-chain weights of a packed dict, in ``W_ORDER``."""
    return tuple(packed[k] for k in W_ORDER)


def build_pair_features(x_k: torch.Tensor, edge_vec: torch.Tensor,
                        rot: torch.Tensor) -> torch.Tensor:
    """Rotated pair features ``u [B, T, Aq, Ak, 4]``: the sender's
    displacement and the edge vector, both in the receiver's frame.

    x_k [B, T, Ak, 2] . edge_vec [B, T, Aq, Ak, 2] . rot [B, Aq, 2, 2].
    """
    r = rot.reshape(rot.shape[0], 1, rot.shape[1], 1, 4)  # [B, 1, Aq, 1, 4]
    xk = x_k[:, :, None, :, :]                            # [B, T, 1, Ak, 2]
    xl0 = r[..., 0] * xk[..., 0] + r[..., 2] * xk[..., 1]
    xl1 = r[..., 1] * xk[..., 0] + r[..., 3] * xk[..., 1]
    el0 = r[..., 0] * edge_vec[..., 0] + r[..., 2] * edge_vec[..., 1]
    el1 = r[..., 1] * edge_vec[..., 0] + r[..., 3] * edge_vec[..., 1]
    return torch.stack([xl0, xl1, el0, el1], dim=-1)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------
def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with a two-pass variance."""
    m = x.mean(-1, keepdim=True)
    xc = x - m
    v = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(v + LN_EPS) * scale + bias


def fused_pair_attention_reference(q, u, mask_f, keep, ws: Sequence[torch.Tensor],
                                   num_heads: int, dropout_rate: float = 0.0) -> torch.Tensor:
    """``pair_chain`` over the whole batch as one tile: q [B, T, Aq, D],
    u [B, T, Aq, Ak, 4], mask_f [B, T, Aq, Ak] (0/1), keep
    [B, T, Aq, Ak, H] (0/1) or None -> the pre-gating aggregate
    [B, T, Aq, D].  Holds for any ``ws``, block-diagonal or not."""
    B, T, Aq, D = q.shape
    Ak, H = u.shape[3], num_heads
    hd = D // H
    wu, bu, ln0s, ln0b, w1, b1, lna0s, lna0b, wagg, bagg, lna1s, lna1b, wkv, bkv = ws
    R = B * T * Aq
    uf = u.reshape(R * Ak, 4)

    # four rank-1 products, then one LayerNorm per D-wide branch
    h = bu[0] + sum(uf[:, k:k + 1] * wu[k:k + 1, :] for k in range(4))
    a0 = torch.relu(torch.cat([_ln(h[:, :D], ln0s[0, :D], ln0b[0, :D]),
                               _ln(h[:, D:], ln0s[0, D:], ln0b[0, D:])], dim=-1))
    z1 = a0 @ w1 + b1[0]
    a1 = torch.relu(_ln(z1[:, :D] + z1[:, D:], lna0s[0], lna0b[0]))
    nbr = _ln(a1 @ wagg + bagg[0], lna1s[0], lna1b[0])
    kv = nbr @ wkv + bkv[0]                                   # [P, 2D]

    k = kv[:, :D].reshape(R, Ak, H, hd)
    v = kv[:, D:].reshape(R, Ak, H, hd)
    qh = q.reshape(R, 1, H, hd)
    lg = (k * qh).sum(-1) * (1.0 / hd ** 0.5)                 # [R, Ak, H]
    m3 = mask_f.reshape(R, Ak, 1)
    lg = torch.where(m3 > 0, lg, torch.full_like(lg, NEG))
    e = torch.exp(lg - lg.amax(dim=1, keepdim=True)) * m3
    alpha = e / e.sum(dim=1, keepdim=True).clamp_min(1e-16)
    if keep is not None:
        alpha = alpha * (keep.reshape(R, Ak, H) * (1.0 / (1.0 - dropout_rate)))
    out = (alpha[..., None] * v).sum(dim=1)                   # [R, H, hd]
    return out.reshape(B, T, Aq, D)


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------
@functools.cache
def _library():
    from trajsde_tpu_torch.ops import build

    lib = build.load("aa_fused")
    lib.aa_fused_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.aa_fused_launch.restype = ctypes.c_int
    lib.aa_fused_weight_floats.argtypes = []
    lib.aa_fused_weight_floats.restype = ctypes.c_int
    lib.aa_fused_receivers_per_group.argtypes = []
    lib.aa_fused_receivers_per_group.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(q, u, mask_f, keep, ws, num_heads, dropout_rate) -> torch.Tensor:
    B, T, Aq, D = q.shape
    Ak = u.shape[3]
    if (D, num_heads) != (KERNEL_DIM, KERNEL_HEADS):
        raise ValueError(f"the aa_fused kernel is specialised to D={KERNEL_DIM}, "
                         f"H={KERNEL_HEADS}; got D={D}, H={num_heads}")
    if Ak < 1:
        raise ValueError("the aa_fused kernel needs at least one sender")
    dev = q.device
    lib = _library()
    _check("q", q, (B, T, Aq, D), dev)
    _check("u", u, (B, T, Aq, Ak, 4), dev)
    _check("mask_f", mask_f, (B, T, Aq, Ak), dev)
    if keep is not None:
        _check("keep", keep, (B, T, Aq, Ak, num_heads), dev)
    w = torch.cat([x.reshape(-1) for x in ws]).contiguous()
    _check("packed weights", w, (lib.aa_fused_weight_floats(),), dev)
    out = torch.empty_like(q)
    R = B * T * Aq
    if R == 0:
        return out
    # a persistent grid: one block per SM walks the receiver groups
    groups = -(-R // lib.aa_fused_receivers_per_group())
    grid = min(groups, torch.cuda.get_device_properties(dev).multi_processor_count)
    keep_scale = 1.0 / (1.0 - dropout_rate) if keep is not None else 1.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aa_fused_launch(
            q.data_ptr(), u.data_ptr(), mask_f.data_ptr(),
            None if keep is None else keep.data_ptr(), w.data_ptr(), out.data_ptr(),
            R, Ak, keep_scale, grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"aa_fused kernel launch failed: cudaError {err}")
    fused_pair_attention.launches += 1
    return out


def fused_pair_attention(q: torch.Tensor, u: torch.Tensor, mask_f: torch.Tensor,
                         keep: Optional[torch.Tensor], ws: Sequence[torch.Tensor],
                         num_heads: int, dropout_rate: float = 0.0) -> torch.Tensor:
    """Pre-gating AA aggregate.

    q      [B, T, Aq, D] f32: projected queries (``lin_q`` of the normed centre)
    u      [B, T, Aq, Ak, 4] f32: rotated pair features (:func:`build_pair_features`)
    mask_f [B, T, Aq, Ak] f32: 0/1 adjacency
    keep   [B, T, Aq, Ak, H] f32 0/1 attention-dropout keep mask, or None
    ws     the 14 packed weights in ``W_ORDER``

    Returns [B, T, Aq, D] f32.  On CUDA kernel K3 runs on the current stream
    without synchronising and ``fused_pair_attention.launches`` counts its
    launches; it computes no gradient, so a call with grad enabled and an
    input that requires one raises.  On the CPU the plain version runs
    (differentiable by autograd).
    """
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                x is not None and x.requires_grad for x in (q, u, mask_f, keep, *ws)):
            raise NotImplementedError(
                "the aa_fused CUDA kernel (K3) is forward only: its backward, kernel K4, "
                "comes with the next slice of the port (training with encoder.fused: true); "
                "run the fused encoder under torch.no_grad() / torch.inference_mode()"
            )
        return _launch(q, u, mask_f, keep, ws, num_heads, dropout_rate)
    if q.device.type == "cpu":
        return fused_pair_attention_reference(q, u, mask_f, keep, ws, num_heads, dropout_rate)
    raise ValueError(f"fused_pair_attention runs on cuda (kernel) or cpu (plain), not {q.device}")


fused_pair_attention.launches = 0


def fused_aa_aggregate(q: torch.Tensor, x_k: torch.Tensor, edge_vec: torch.Tensor,
                       rot: torch.Tensor, mask: torch.Tensor, packed: Dict[str, torch.Tensor],
                       num_heads: int, keep: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """The fused AA propagate stage behind the encoder's inputs: q
    [B, T, Aq, D], x_k [B, T, Ak, 2], edge_vec [B, T, Aq, Ak, 2], rot
    [B, Aq, 2, 2], mask [B, T, Aq, Ak] bool, ``packed`` from
    :func:`pack_aa_params` -> [B, T, Aq, D] f32."""
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    u = build_pair_features(f32(x_k), f32(edge_vec), f32(rot)).contiguous()
    ws = tuple(f32(w) for w in weights_of(packed))
    return fused_pair_attention(f32(q), u, f32(mask), None if keep is None else f32(keep),
                                ws, num_heads, dropout_rate)
