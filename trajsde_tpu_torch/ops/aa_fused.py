"""Fused AA pair chain: forward kernel K3, backward kernel K4, their
wrappers and plain PyTorch versions, and the packed parameters.

Counterpart of ``trajsde_tpu/ops/pallas/aa_fused.py::fused_pair_attention``
(forward: ``_fwd_call`` -> ``_fwd_kernel`` -> ``pair_chain``; backward, its
custom VJP: ``_bwd_call`` -> ``_bwd_kernel``) and of
``aa_attention.py::pack_aa_params``.  Per (receiver, sender) pair the chain
embeds the 4 rotated pair features ``u`` through the packed two-branch MLP
to keys and values, takes a masked per-head softmax over the senders and
returns the pre-gating aggregate ``[B, T, Aq, D]``.  The node-wise stages
around it (q projection, gating, ``out_proj``) stay in the encoder.

On a CUDA tensor :func:`fused_pair_attention` launches the hand-written
kernel in ``csrc/aa_fused.cu`` (built by nvcc at first use, bound with
ctypes), and when gradients are needed it runs as
:class:`FusedPairAttentionFn`, whose backward launches ``csrc/aa_fused_bwd.cu``.
Both kernels take D 64 at the flagship's 8 heads and the HiVT baseline's
4 (``KERNEL_HEAD_COUNTS``) and raise on any other width.  On a CPU tensor
the plain versions run, at any width.  Nothing falls back from one to
the other.  Only ``q`` and the 14 packed weights get gradients: ``u``,
``mask_f`` and ``keep`` are constants of the scene and the dropout draw,
as in the JAX op (whose zero cotangents for them this ``None`` matches).

``compute_dtype="bfloat16"`` computes as the JAX op does with
``FusedCfg(dtype="bfloat16")``: the three LayerNorm outputs and the three
matrices of the chain's products rounded to bf16, each product summed in
f32, and with ``ln_mm`` (the JAX encoders' default) each LayerNorm's
statistics taken from bf16-rounded inputs.  On CUDA its forward is kernel
K3b (``csrc/aa_fused_bf16.cu``, entry points ``aa_fused_bf16_*``) and its
backward K4b (``csrc/aa_fused_bwd_bf16.cu``, entry points
``aa_fused_bwd_bf16_*``), each a kernel of its own, counted in
``bf16_launches``; ``q``, ``u``,
the masks, the weights and the output stay f32.  In f32 ``ln_mm`` changes
nothing (it is an order of summation).  The forward is a registered op in
either type, so that ``torch.export`` records it as one call:
``trajsde::aa_fused_fwd`` (K3) and ``trajsde::aa_fused_fwd_bf16`` (K3b).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from trajsde_tpu_torch.ops import counted

NEG = -1e9
LN_EPS = 1e-5
# packed weight order (aa_fused.py W_ORDER); matrices [in, out], vectors [1, n]
W_ORDER = (
    "wu", "bu", "ln0s", "ln0b", "w1", "b1",
    "lna0s", "lna0b", "wagg", "bagg", "lna1s", "lna1b",
    "wkv", "bkv",
)
# the kernels' widths (csrc/aa_fused.cu, csrc/aa_fused_bwd.cu): D 64 at the
# head counts they are built for, the flagship's 8 (KERNEL_HEADS) and the
# HiVT baseline's 4, each with C entry points of its own
KERNEL_DIM, KERNEL_HEADS = 64, 8
KERNEL_HEAD_COUNTS = (8, 4)
# the compute dtypes, each with entry points of its own (K3 / K4, K3b / K4b)
COMPUTE_DTYPES = ("float32", "bfloat16")


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
def _check_dtype(compute_dtype: str) -> bool:
    """Whether ``compute_dtype`` is bf16; raises unless it is one of
    ``COMPUTE_DTYPES``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: the fused AA chain computes in "
                         f"{' or '.join(COMPUTE_DTYPES)}")
    return compute_dtype == "bfloat16"


class _RoundBF16(torch.autograd.Function):
    """Rounds an f32 tensor to the nearest bf16 value, kept in f32; the
    backward passes the cotangent through unrounded (JAX's ``astype`` VJP
    returns it in the input's dtype, f32 here)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        stats16: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis with a two-pass variance.  ``stats16``
    (JAX's ``_ln_mm`` in bf16): the mean of the bf16-rounded inputs and the
    variance of the bf16-rounded squares, summed in f32."""
    r = _RoundBF16.apply if stats16 else (lambda a: a)  # noqa: E731
    m = r(x).mean(-1, keepdim=True)
    xc = x - m
    v = r(xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(v + LN_EPS) * scale + bias


def _head_logits(qh: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each head's logit q_h . k_h / sqrt(hd): qh [R, 1, H, hd] and k
    [R, Ak, H, hd] -> [R, Ak, H]."""
    return (k * qh).sum(-1) * (1.0 / k.shape[-1] ** 0.5)


def fused_pair_attention_reference(q, u, mask_f, keep, ws: Sequence[torch.Tensor],
                                   num_heads: int, dropout_rate: float = 0.0,
                                   with_stats: bool = False, compute_dtype: str = "float32",
                                   ln_mm: bool = True):
    """``pair_chain`` over the whole batch as one tile: q [B, T, Aq, D],
    u [B, T, Aq, Ak, 4], mask_f [B, T, Aq, Ak] (0/1), keep
    [B, T, Aq, Ak, H] (0/1) or None -> the pre-gating aggregate
    [B, T, Aq, D].  Holds for any ``ws``, block-diagonal or not.
    ``with_stats`` returns ``(out, stats [2, B*T*Aq, H])`` as K3 writes
    them: each (receiver, head)'s largest unmasked logit (-inf without a
    sender) and its sum of exp.

    ``compute_dtype="bfloat16"`` rounds to bf16 where ``pair_chain`` casts:
    the LayerNorm outputs ``a0``, ``a1`` and ``nbr``, and ``w1``, ``wagg``
    and ``wkv`` in its ``mm``; each product of bf16 values is summed in f32
    (an f32 matmul of the rounded values: a bf16 matmul would round its
    sum), and with ``ln_mm`` each LayerNorm's statistics come from
    bf16-rounded inputs.  The rank-1 first layer, the logits, the softmax
    and the aggregate stay f32.  A rounding's derivative is 1, as JAX's
    ``astype`` VJP; in f32 ``ln_mm`` changes nothing."""
    bf = _check_dtype(compute_dtype)
    stats16 = bf and ln_mm
    r = _RoundBF16.apply if bf else (lambda a: a)  # noqa: E731
    B, T, Aq, D = q.shape
    Ak = u.shape[3]
    wu, bu, ln0s, ln0b, w1, b1, lna0s, lna0b, wagg, bagg, lna1s, lna1b, wkv, bkv = ws
    R = B * T * Aq
    uf = u.reshape(R * Ak, 4)

    # four rank-1 products, then one LayerNorm per D-wide branch
    h = bu[0] + sum(uf[:, k:k + 1] * wu[k:k + 1, :] for k in range(4))
    a0 = torch.relu(r(torch.cat([_ln(h[:, :D], ln0s[0, :D], ln0b[0, :D], stats16),
                                 _ln(h[:, D:], ln0s[0, D:], ln0b[0, D:], stats16)], dim=-1)))
    z1 = a0 @ r(w1) + b1[0]
    a1 = torch.relu(r(_ln(z1[:, :D] + z1[:, D:], lna0s[0], lna0b[0], stats16)))
    nbr = r(_ln(a1 @ r(wagg) + bagg[0], lna1s[0], lna1b[0], stats16))
    kv = nbr @ r(wkv) + bkv[0]                                # [P, 2D]
    return attend(q, kv, mask_f, keep, num_heads, dropout_rate, with_stats)


def attend(q, kv, mask_f, keep, num_heads: int, dropout_rate: float = 0.0,
           with_stats: bool = False):
    """The chain's f32 tail from ``kv [B*T*Aq*Ak, 2D]`` = [k | v]: each
    head's logit of ``q [B, T, Aq, D]`` against k, the masked softmax over
    the senders, the keep mask and the aggregate of v -> [B, T, Aq, D]
    (and the statistics, as :func:`fused_pair_attention_reference`)."""
    B, T, Aq, D = q.shape
    Ak, H = mask_f.shape[3], num_heads
    hd, R = D // H, B * T * Aq
    k = kv[:, :D].reshape(R, Ak, H, hd)
    v = kv[:, D:].reshape(R, Ak, H, hd)
    lg = _head_logits(q.reshape(R, 1, H, hd), k)              # [R, Ak, H]
    m3 = mask_f.reshape(R, Ak, 1)
    lg = torch.where(m3 > 0, lg, torch.full_like(lg, NEG))
    e = torch.exp(lg - lg.amax(dim=1, keepdim=True)) * m3
    alpha = e / e.sum(dim=1, keepdim=True).clamp_min(1e-16)
    if keep is not None:
        alpha = alpha * (keep.reshape(R, Ak, H) * (1.0 / (1.0 - dropout_rate)))
    out = (alpha[..., None] * v).sum(dim=1)                   # [R, H, hd]
    out = out.reshape(B, T, Aq, D)
    if not with_stats:
        return out
    has = m3.sum(dim=1) > 0                                   # [R, 1]
    top = torch.where(has, lg.amax(dim=1), torch.full_like(lg[:, 0], -torch.inf))
    return out, torch.stack([top, e.sum(dim=1)])


def fused_pair_attention_bwd_reference(q, u, mask_f, keep, ws: Sequence[torch.Tensor],
                                       g: torch.Tensor, num_heads: int,
                                       dropout_rate: float = 0.0,
                                       compute_dtype: str = "float32", ln_mm: bool = True):
    """``(dq, dws)`` of :func:`fused_pair_attention_reference` for the
    cotangent ``g [B, T, Aq, D]``: autograd through the plain chain with
    ``u``, ``mask_f`` and ``keep`` held constant (``_bwd_kernel``'s
    ``jax.vjp`` with them closed over).  ``dws`` is shaped like ``ws``.
    In bf16 the cotangents stay f32 (each rounding passes them through)."""
    with torch.enable_grad():
        qd = q.detach().requires_grad_()
        wd = [w.detach().requires_grad_() for w in ws]
        out = fused_pair_attention_reference(qd, u.detach(), mask_f.detach(),
                                             None if keep is None else keep.detach(), wd,
                                             num_heads, dropout_rate,
                                             compute_dtype=compute_dtype, ln_mm=ln_mm)
        grads = torch.autograd.grad(out, [qd, *wd], g)
    return grads[0], tuple(grads[1:])


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------
def _entry_name(kernel: str, what: str, num_heads: int, compute_dtype: str = "float32") -> str:
    """The C function ``what`` of ``kernel`` (``"aa_fused"`` or
    ``"aa_fused_bwd"``) at ``num_heads`` heads: ``aa_fused_launch`` at 8,
    ``aa_fused_h4_launch`` at 4, and in bf16 ``aa_fused_bf16_launch`` and
    ``aa_fused_bf16_h4_launch``."""
    bf = "_bf16" if compute_dtype == "bfloat16" else ""
    return f"{kernel}{bf}{'' if num_heads == KERNEL_HEADS else f'_h{num_heads}'}_{what}"


def has_heads(lib: ctypes.CDLL, kernel: str, num_heads: int,
              compute_dtype: str = "float32") -> bool:
    """Whether a build of ``kernel``'s source has entry points for
    ``num_heads`` in ``compute_dtype`` (a build of an older source may have
    the 8 heads' in f32 only)."""
    return hasattr(lib, _entry_name(kernel, "launch", num_heads, compute_dtype))


def _entry(lib: ctypes.CDLL, kernel: str, what: str, num_heads: int,
           compute_dtype: str = "float32"):
    if not has_heads(lib, kernel, num_heads, compute_dtype):
        raise ValueError(f"{lib._name} has no {num_heads}-head entry point "
                         f"{_entry_name(kernel, 'launch', num_heads, compute_dtype)}")
    return getattr(lib, _entry_name(kernel, what, num_heads, compute_dtype))


def _declare(lib: ctypes.CDLL, kernel: str, launch_pointers: int) -> ctypes.CDLL:
    """Declares ``kernel``'s C interface, at every compute dtype and head
    count the build has, on a loaded library and returns it.  The bf16
    launches take ``ln_mm`` (an int) after ``keep_scale``; a build may say
    how many blocks an SM holds (``*_blocks_per_sm``, else one)."""
    getattr(lib, f"{kernel}_weight_floats").argtypes = []
    getattr(lib, f"{kernel}_weight_floats").restype = ctypes.c_int
    for dt in COMPUTE_DTYPES:
        for h in KERNEL_HEAD_COUNTS:
            if not has_heads(lib, kernel, h, dt):
                continue
            fn = getattr(lib, _entry_name(kernel, "launch", h, dt))
            fn.argtypes = [ctypes.c_void_p] * launch_pointers + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                *([ctypes.c_int] if dt == "bfloat16" else []), ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            for what in ("receivers_per_group", "blocks_per_sm"):
                name = _entry_name(kernel, what, h, dt)
                if what == "receivers_per_group" or hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = [], ctypes.c_int
    return lib


def configure_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares K3's or K3b's C interface on a loaded library
    (``csrc/aa_fused.cu``, ``csrc/aa_fused_bf16.cu`` or a copy of either
    built elsewhere) and returns it."""
    return _declare(lib, "aa_fused", 7)


@functools.cache
def _library(compute_dtype: str = "float32"):
    """K3's library, or K3b's in bf16."""
    from trajsde_tpu_torch.ops import build

    bf = _check_dtype(compute_dtype)
    return configure_fwd(build.load("aa_fused_bf16" if bf else "aa_fused"))


def configure_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares K4's or K4b's C interface on a loaded library
    (``csrc/aa_fused_bwd.cu``, ``csrc/aa_fused_bwd_bf16.cu`` or a copy of
    either built elsewhere) and returns it."""
    return _declare(lib, "aa_fused_bwd", 11)


@functools.cache
def _bwd_library(compute_dtype: str = "float32"):
    """K4's library, or K4b's in bf16."""
    from trajsde_tpu_torch.ops import build

    bf = _check_dtype(compute_dtype)
    return configure_bwd(build.load("aa_fused_bwd_bf16" if bf else "aa_fused_bwd"))


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _common_checks(q, u, mask_f, keep, ws, num_heads, weight_floats):
    """Checks shared by K3 and K4 -> (R, Ak, the packed weight buffer)."""
    B, T, Aq, D = q.shape
    Ak = u.shape[3]
    if D != KERNEL_DIM or num_heads not in KERNEL_HEAD_COUNTS:
        raise ValueError(f"the aa_fused kernels are built for D={KERNEL_DIM} at "
                         f"H in {KERNEL_HEAD_COUNTS}; got D={D}, H={num_heads}")
    if Ak < 1:
        raise ValueError("the aa_fused kernels need at least one sender")
    dev = q.device
    _check("q", q, (B, T, Aq, D), dev)
    _check("u", u, (B, T, Aq, Ak, 4), dev)
    _check("mask_f", mask_f, (B, T, Aq, Ak), dev)
    if keep is not None:
        _check("keep", keep, (B, T, Aq, Ak, num_heads), dev)
    w = torch.cat([x.reshape(-1) for x in ws]).contiguous()
    _check("packed weights", w, (weight_floats,), dev)
    return B * T * Aq, Ak, w


def _keep_scale(keep, dropout_rate: float) -> float:
    return 1.0 / (1.0 - dropout_rate) if keep is not None else 1.0


def _grid(R: int, receivers_per_group: int, dev, blocks_per_sm: int = 1) -> int:
    """A persistent grid: at most ``blocks_per_sm`` blocks per SM walk the
    receiver groups."""
    groups = -(-R // receivers_per_group)
    return min(groups, blocks_per_sm * torch.cuda.get_device_properties(dev).multi_processor_count)


def _fwd_grid(lib: ctypes.CDLL, R: int, num_heads: int, compute_dtype: str, dev) -> int:
    """The grid of a forward launch from the build's own sizes: receivers
    a block walks at a time, and blocks an SM holds where the build says."""
    per_sm = _entry_name("aa_fused", "blocks_per_sm", num_heads, compute_dtype)
    blocks = getattr(lib, per_sm)() if hasattr(lib, per_sm) else 1
    return _grid(R, _entry(lib, "aa_fused", "receivers_per_group", num_heads, compute_dtype)(),
                 dev, blocks)


def _dtype_args(compute_dtype: str, ln_mm: bool) -> list:
    """The launch's ``ln_mm`` argument, which only the bf16 entry points take."""
    return [int(bool(ln_mm))] if _check_dtype(compute_dtype) else []


def launch_fwd(lib: ctypes.CDLL, q, u, mask_f, keep, ws, num_heads, dropout_rate,
               with_stats: bool = False, compute_dtype: str = "float32", ln_mm: bool = True):
    """Runs ``lib``'s ``aa_fused_launch`` (K3, or another build of its
    source configured by :func:`configure_fwd`; ``aa_fused_bf16_launch``,
    K3b or a build that has it, in bf16) on the current stream -> (out,
    stats): ``stats [2, R, H]``
    holds each (receiver, head)'s softmax max and sum of exp for K4 when
    ``with_stats``, else None.  Counts nothing (see
    :func:`fused_pair_attention`)."""
    extra = _dtype_args(compute_dtype, ln_mm)
    R, Ak, w = _common_checks(q, u, mask_f, keep, ws, num_heads, lib.aa_fused_weight_floats())
    dev = q.device
    out = torch.empty_like(q)
    stats = torch.empty((2, R, num_heads), device=dev) if with_stats else None
    if R == 0:
        return out, stats
    grid = _fwd_grid(lib, R, num_heads, compute_dtype, dev)
    launch = _entry(lib, "aa_fused", "launch", num_heads, compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            q.data_ptr(), u.data_ptr(), mask_f.data_ptr(),
            None if keep is None else keep.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            R, Ak, _keep_scale(keep, dropout_rate), *extra, grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"aa_fused ({compute_dtype}) kernel launch failed: cudaError {err}")
    return out, stats


def _count(fn, compute_dtype: str) -> None:
    """One launch of ``fn``'s kernel: K3 / K4 in ``fn.launches``, K3b / K4b
    in ``fn.bf16_launches``."""
    if compute_dtype == "bfloat16":
        fn.bf16_launches += 1
    else:
        fn.launches += 1


def _launch(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats: bool = False,
            compute_dtype: str = "float32", ln_mm: bool = True):
    """K3 (K3b in bf16) -> (out, stats), counted in
    ``fused_pair_attention.launches`` (``.bf16_launches``)."""
    out, stats = launch_fwd(_library(compute_dtype), q, u, mask_f, keep, ws, num_heads,
                            dropout_rate, with_stats, compute_dtype, ln_mm)
    if q.numel():  # no receivers: nothing was launched
        _count(fused_pair_attention, compute_dtype)
    return out, stats


def _op_forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats, compute_dtype,
                ln_mm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The registered ops' body: K3 / K3b on a CUDA tensor, the plain version
    on a CPU tensor -> ``(out, stats or an empty tensor)``."""
    if _device_kind(q, "fused_pair_attention") == "cuda":
        out, stats = _launch(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats,
                             compute_dtype, ln_mm)
    elif with_stats:
        out, stats = fused_pair_attention_reference(q, u, mask_f, keep, ws, num_heads,
                                                    dropout_rate, True, compute_dtype, ln_mm)
    else:
        out, stats = fused_pair_attention_reference(q, u, mask_f, keep, ws, num_heads,
                                                    dropout_rate, False, compute_dtype,
                                                    ln_mm), None
    return out, q.new_empty((0,)) if stats is None else stats


@torch.library.custom_op("trajsde::aa_fused_fwd", mutates_args=())
def aa_fused_op(q: torch.Tensor, u: torch.Tensor, mask_f: torch.Tensor,
                keep: Optional[torch.Tensor], ws: List[torch.Tensor], num_heads: int,
                dropout_rate: float, with_stats: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``trajsde::aa_fused_fwd``, the registered op over K3: ``(out, stats)``
    with ``stats [2, B*T*Aq, H]`` when ``with_stats`` and an empty tensor
    otherwise.  On a CUDA tensor it launches K3 (counted in
    ``fused_pair_attention.launches``), on a CPU tensor it runs the plain
    version; ``torch.export`` records it as one opaque call."""
    return _op_forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats, "float32",
                       True)


@aa_fused_op.register_fake
def _aa_fused_fake(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats):
    R = q.shape[0] * q.shape[1] * q.shape[2]
    return q.new_empty(q.shape), q.new_empty((2, R, num_heads) if with_stats else (0,))


def launch_bwd(lib: ctypes.CDLL, q, u, mask_f, keep, ws, g, out, stats, num_heads,
               dropout_rate, compute_dtype: str = "float32", ln_mm: bool = True):
    """Runs ``lib``'s ``aa_fused_bwd_launch`` (K4, or another build of its
    source configured by :func:`configure_bwd`; ``aa_fused_bwd_bf16_launch``,
    K4b, in bf16, on ``out`` and ``stats`` of K3b) on the current stream and
    returns ``(dq, dws)``; counts nothing (see :func:`fused_pair_attention_bwd`)."""
    extra = _dtype_args(compute_dtype, ln_mm)
    R, Ak, w = _common_checks(q, u, mask_f, keep, ws, num_heads,
                              lib.aa_fused_bwd_weight_floats())
    dev = q.device
    _check("g", g, q.shape, dev)
    _check("out", out, q.shape, dev)
    _check("stats", stats, (2, R, num_heads), dev)
    dq = torch.empty_like(q)
    dw = torch.empty_like(w)
    if R == 0:
        dw.zero_()
    else:
        # each block adds its groups' weight gradients into its own f64
        # slice; a second kernel sums the slices in block order (no
        # atomics, bit-equal reruns)
        grid = _grid(R, _entry(lib, "aa_fused_bwd", "receivers_per_group", num_heads,
                               compute_dtype)(), dev)
        launch = _entry(lib, "aa_fused_bwd", "launch", num_heads, compute_dtype)
        partial = torch.empty((grid, w.numel()), device=dev, dtype=torch.float64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(
                q.data_ptr(), u.data_ptr(), mask_f.data_ptr(),
                None if keep is None else keep.data_ptr(), w.data_ptr(), g.data_ptr(),
                out.data_ptr(), stats.data_ptr(), dq.data_ptr(), dw.data_ptr(),
                partial.data_ptr(), R, Ak, _keep_scale(keep, dropout_rate), *extra, grid, stream,
            )
        if err != 0:
            raise RuntimeError(f"aa_fused_bwd ({compute_dtype}) kernel launch failed: "
                               f"cudaError {err}")
    dws, off = [], 0
    for x in ws:
        dws.append(dw[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return dq, tuple(dws)


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain), not {x.device}")
    return x.device.type


@torch.library.custom_op("trajsde::aa_fused_fwd_bf16", mutates_args=())
def aa_fused_bf16_op(q: torch.Tensor, u: torch.Tensor, mask_f: torch.Tensor,
                     keep: Optional[torch.Tensor], ws: List[torch.Tensor], num_heads: int,
                     dropout_rate: float, with_stats: bool,
                     ln_mm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``trajsde::aa_fused_fwd_bf16``, the registered op over K3b: as
    :func:`aa_fused_op` with the chain in bf16 and ``ln_mm``.  On a CUDA
    tensor it launches K3b (counted in ``fused_pair_attention.bf16_launches``),
    on a CPU tensor it runs the plain bf16 version; ``out`` and ``stats``
    are f32."""
    return _op_forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats, "bfloat16",
                       ln_mm)


@aa_fused_bf16_op.register_fake
def _aa_fused_bf16_fake(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats, ln_mm):
    return _aa_fused_fake(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats)


def _forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, with_stats, compute_dtype,
             ln_mm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward through the registered op of ``compute_dtype``:
    :func:`aa_fused_op` (K3) or :func:`aa_fused_bf16_op` (K3b)."""
    if _check_dtype(compute_dtype):
        return aa_fused_bf16_op(q, u, mask_f, keep, list(ws), num_heads, dropout_rate,
                                with_stats, ln_mm)
    return aa_fused_op(q, u, mask_f, keep, list(ws), num_heads, dropout_rate, with_stats)


def fused_pair_attention_fwd(q, u, mask_f, keep, ws: Sequence[torch.Tensor], num_heads: int,
                             dropout_rate: float = 0.0, compute_dtype: str = "float32",
                             ln_mm: bool = True):
    """``(out, stats)``: the forward that a backward needs, with the
    softmax statistics ``stats [2, B*T*Aq, H]`` (K4's input): K3 (K3b in
    bf16) on CUDA, the plain version on the CPU, through :func:`aa_fused_op`
    (:func:`aa_fused_bf16_op` in bf16)."""
    # checked here: on a meta tensor the op would run its fake and return
    _device_kind(q, "fused_pair_attention_fwd")
    return _forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, True, compute_dtype, ln_mm)


def fused_pair_attention_bwd(q, u, mask_f, keep, ws: Sequence[torch.Tensor], g: torch.Tensor,
                             num_heads: int, dropout_rate: float = 0.0,
                             out: Optional[torch.Tensor] = None,
                             stats: Optional[torch.Tensor] = None,
                             compute_dtype: str = "float32", ln_mm: bool = True):
    """``(dq, dws)`` for the cotangent ``g`` of :func:`fused_pair_attention`'s
    output, ``dws`` shaped like ``ws``; ``u``, ``mask_f`` and ``keep`` get
    none.

    On CUDA kernel K4 (K4b in bf16) runs on the current stream without
    synchronising, reading ``out`` and ``stats`` of
    :func:`fused_pair_attention_fwd` on the same inputs, and
    ``fused_pair_attention_bwd.launches`` (``.bf16_launches``) counts its
    launches; its weight gradients are summed in a fixed order, so they
    are the same run after run.  On the CPU the plain version runs (and
    ``out`` / ``stats`` are not needed).
    """
    if _device_kind(q, "fused_pair_attention_bwd") == "cuda":
        if out is None or stats is None:
            raise ValueError("K4 reads the forward's output and softmax statistics: pass out "
                             "and stats of fused_pair_attention_fwd")
        dq, dws = launch_bwd(_bwd_library(compute_dtype), q, u, mask_f, keep, ws, g, out, stats,
                             num_heads, dropout_rate, compute_dtype, ln_mm)
        if q.numel():  # no receivers: nothing was launched
            _count(fused_pair_attention_bwd, compute_dtype)
        return dq, dws
    return fused_pair_attention_bwd_reference(q, u, mask_f, keep, ws, g, num_heads, dropout_rate,
                                              compute_dtype, ln_mm)


counted(fused_pair_attention_bwd, "launches", "bf16_launches")


class FusedPairAttentionFn(torch.autograd.Function):
    """The pre-gating aggregate with K3 forward and K4 backward (the port of
    ``fused_pair_attention``'s custom VJP); on the CPU the plain forward and
    the plain backward.

    ``apply(q, u, mask_f, keep, num_heads, dropout_rate, compute_dtype,
    ln_mm, *ws)``; only ``q`` and the 14 packed weights get gradients.  In
    bf16 the forward is K3b and the backward K4b.
    """

    @staticmethod
    def forward(ctx, q, u, mask_f, keep, num_heads, dropout_rate, compute_dtype, ln_mm, *ws):
        out, stats = fused_pair_attention_fwd(q, u, mask_f, keep, ws, num_heads, dropout_rate,
                                              compute_dtype, ln_mm)
        ctx.save_for_backward(q, u, mask_f, keep, out, stats, *ws)
        ctx.num_heads, ctx.dropout_rate = num_heads, dropout_rate
        ctx.compute_dtype, ctx.ln_mm = compute_dtype, ln_mm
        return out

    @staticmethod
    def backward(ctx, g):
        q, u, mask_f, keep, out, stats, *ws = ctx.saved_tensors
        dq, dws = fused_pair_attention_bwd(q, u, mask_f, keep, ws, g.contiguous(), ctx.num_heads,
                                           ctx.dropout_rate, out=out, stats=stats,
                                           compute_dtype=ctx.compute_dtype, ln_mm=ctx.ln_mm)
        return (dq, None, None, None, None, None, None, None, *dws)


def fused_pair_attention(q: torch.Tensor, u: torch.Tensor, mask_f: torch.Tensor,
                         keep: Optional[torch.Tensor], ws: Sequence[torch.Tensor],
                         num_heads: int, dropout_rate: float = 0.0,
                         compute_dtype: str = "float32", ln_mm: bool = True) -> torch.Tensor:
    """Pre-gating AA aggregate.

    q      [B, T, Aq, D] f32: projected queries (``lin_q`` of the normed centre)
    u      [B, T, Aq, Ak, 4] f32: rotated pair features (:func:`build_pair_features`)
    mask_f [B, T, Aq, Ak] f32: 0/1 adjacency
    keep   [B, T, Aq, Ak, H] f32 0/1 attention-dropout keep mask, or None
    ws     the 14 packed weights in ``W_ORDER``

    Returns [B, T, Aq, D] f32.  On CUDA kernel K3 runs on the current stream
    without synchronising and ``fused_pair_attention.launches`` counts its
    launches.  When autograd needs a gradient (of ``q`` or a weight) the
    call runs as :class:`FusedPairAttentionFn`: K3 also writes its softmax
    statistics, and the backward launches K4.  Otherwise nothing is saved.
    On the CPU the plain versions run.  ``compute_dtype="bfloat16"``: the
    chain in bf16 (the module's docstring), K3b and K4b on CUDA, counted in
    ``fused_pair_attention.bf16_launches`` and
    ``fused_pair_attention_bwd.bf16_launches``; ``ln_mm`` takes each
    LayerNorm's statistics from bf16-rounded inputs (nothing in f32).
    """
    _device_kind(q, "fused_pair_attention")
    _check_dtype(compute_dtype)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, *ws)):
        return FusedPairAttentionFn.apply(q, u, mask_f, keep, num_heads, dropout_rate,
                                          compute_dtype, ln_mm, *ws)
    return _forward(q, u, mask_f, keep, ws, num_heads, dropout_rate, False, compute_dtype,
                    ln_mm)[0]


counted(fused_pair_attention, "launches", "bf16_launches")


def fused_aa_aggregate(q: torch.Tensor, x_k: torch.Tensor, edge_vec: torch.Tensor,
                       rot: torch.Tensor, mask: torch.Tensor, packed: Dict[str, torch.Tensor],
                       num_heads: int, keep: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0, compute_dtype: str = "float32",
                       ln_mm: bool = True) -> torch.Tensor:
    """The fused AA propagate stage behind the encoder's inputs: q
    [B, T, Aq, D], x_k [B, T, Ak, 2], edge_vec [B, T, Aq, Ak, 2], rot
    [B, Aq, 2, 2], mask [B, T, Aq, Ak] bool, ``packed`` from
    :func:`pack_aa_params` -> [B, T, Aq, D] f32; the chain in
    ``compute_dtype`` (see :func:`fused_pair_attention`), every input f32."""
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    u = build_pair_features(f32(x_k), f32(edge_vec), f32(rot)).contiguous()
    ws = tuple(f32(w) for w in weights_of(packed))
    return fused_pair_attention(f32(q), u, f32(mask), None if keep is None else f32(keep),
                                ws, num_heads, dropout_rate, compute_dtype, ln_mm)
