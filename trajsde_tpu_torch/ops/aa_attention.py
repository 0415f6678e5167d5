"""Agent-agent attention from positions: kernel K5, its wrapper and its
plain PyTorch version.

Counterpart of ``trajsde_tpu/ops/pallas/aa_attention.py::aa_attention``
(``pallas_call`` body ``_aa_kernel``) and its ``aa_attention_reference``.
It is the fused AA pair chain of :mod:`trajsde_tpu_torch.ops.aa_fused`
(kernel K3) with two prologues moved inside: the q projection
``center_norm . wq + bq``, and the pair features ``u``, built from the
sender's displacement ``x_k`` and the edge ``pos_k - pos_q``, both rotated
into the receiver's frame.  Forward only; no dropout.  No model path calls
it: it is an op of its own, as in the JAX package.

On a CUDA tensor :func:`aa_attention` launches the hand-written kernel in
``csrc/aa_attention.cu`` (built by nvcc at first use, bound with ctypes),
which takes D 64 at the flagship's 8 heads and the HiVT baseline's 4
(``KERNEL_HEAD_COUNTS``, an entry point each) and raises on any other
width; on a CPU tensor the plain version runs, at any width.  Nothing
falls back from one to the other.  ``compute_dtype="bfloat16"`` computes
at the rounding points of the JAX kernel's bf16 form (not the fused
chain's, K3b's): on CUDA kernel K5b, the ``BF`` form of the same source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from trajsde_tpu_torch.ops import counted
from trajsde_tpu_torch.ops.aa_fused import (COMPUTE_DTYPES, KERNEL_DIM, KERNEL_HEAD_COUNTS,
                                            W_ORDER, _check, _check_dtype, _device_kind, _entry,
                                            _entry_name, _grid, _ln, _RoundBF16, attend,
                                            build_pair_features, fused_pair_attention_reference,
                                            has_heads, weights_of)


def aa_attention_reference(center_norm, x_k, pos_q, pos_k, rot, mask,
                           packed: Dict[str, torch.Tensor], num_heads: int,
                           compute_dtype: str = "float32") -> torch.Tensor:
    """The plain version: q = ``center_norm . wq + bq``, the rotated pair
    features of ``x_k`` and ``pos_k - pos_q``, then K3's plain chain with
    the 0/1 mask and no keep mask -> [B, T, Aq, D].

    ``compute_dtype="bfloat16"`` rounds where ``_aa_kernel`` casts (not
    where ``pair_chain`` does, as K3b): all 16 packed weights, ``u`` and
    the centres; the first layer's output, each half of the second layer's
    and their sum; each LayerNorm's output (its statistics f32, of the
    bf16 inputs) and ``nbr`` before its LayerNorm.  Every product is an
    f32 matmul of bf16 values (a bf16 matmul would round its sum); kv, q,
    the logits, the softmax and the aggregate stay f32."""
    edge = pos_k[:, :, None, :, :] - pos_q[:, :, :, None, :]
    u = build_pair_features(x_k, edge, rot)
    mask_f = mask.to(center_norm.dtype)
    if not _check_dtype(compute_dtype):
        q = center_norm @ packed["wq"] + packed["bq"][0]
        return fused_pair_attention_reference(q, u, mask_f, None, weights_of(packed), num_heads)
    r = _RoundBF16.apply
    w = {k: r(v) for k, v in packed.items()}
    D = center_norm.shape[-1]
    uf = r(u).reshape(-1, 4)

    def ln(x, name):  # f32 statistics of the bf16 input, the output rounded
        return r(_ln(x, w[f"{name}s"][0], w[f"{name}b"][0]))

    h = r(sum(uf[:, k:k + 1] * w["wu"][k:k + 1, :] for k in range(4)) + w["bu"][0])
    a0 = torch.relu(torch.cat([r(_ln(h[:, :D], w["ln0s"][0, :D], w["ln0b"][0, :D])),
                               r(_ln(h[:, D:], w["ln0s"][0, D:], w["ln0b"][0, D:]))], dim=-1))
    z1 = r(a0 @ w["w1"] + w["b1"][0])
    a1 = torch.relu(ln(r(z1[:, :D] + z1[:, D:]), "lna0"))
    nbr = ln(r(a1 @ w["wagg"] + w["bagg"][0]), "lna1")
    kv = nbr @ w["wkv"] + w["bkv"][0]
    q = r(center_norm) @ w["wq"] + w["bq"][0]
    return attend(q, kv, mask_f, None, num_heads)


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares K5's C interface, at every compute dtype and head count the
    build has (K5b's entry points in bf16), on a loaded library
    (``csrc/aa_attention.cu`` or a copy of it built elsewhere) and returns it."""
    lib.aa_attention_weight_floats.argtypes = []
    lib.aa_attention_weight_floats.restype = ctypes.c_int
    for dt in COMPUTE_DTYPES:
        for h in KERNEL_HEAD_COUNTS:
            if not has_heads(lib, "aa_attention", h, dt):
                continue
            fn = getattr(lib, _entry_name("aa_attention", "launch", h, dt))
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = getattr(lib, _entry_name("aa_attention", "receivers_per_group", h, dt))
            fn.argtypes, fn.restype = [], ctypes.c_int
    return lib


@functools.cache
def _library():
    from trajsde_tpu_torch.ops import build

    return configure(build.load("aa_attention"))


def launch(lib: ctypes.CDLL, center_norm, x_k, pos_q, pos_k, rot, mask, packed,
           num_heads, compute_dtype: str = "float32") -> torch.Tensor:
    """Runs ``lib``'s K5 (``csrc/aa_attention.cu``, or another build of its
    source configured by :func:`configure`; K5b in bf16) at ``num_heads``
    on the current stream; counts nothing (see :func:`aa_attention`)."""
    _check_dtype(compute_dtype)
    B, T, Aq, D = center_norm.shape
    Ak = x_k.shape[2]
    if D != KERNEL_DIM or num_heads not in KERNEL_HEAD_COUNTS:
        raise ValueError(f"the aa_attention kernel is built for D={KERNEL_DIM} at H in "
                         f"{KERNEL_HEAD_COUNTS}; got D={D}, H={num_heads}")
    if Ak < 1:
        raise ValueError("the aa_attention kernel needs at least one sender")
    dev = center_norm.device
    _check("center_norm", center_norm, (B, T, Aq, D), dev)
    _check("x_k", x_k, (B, T, Ak, 2), dev)
    _check("pos_q", pos_q, (B, T, Aq, 2), dev)
    _check("pos_k", pos_k, (B, T, Ak, 2), dev)
    _check("rot", rot, (B, Aq, 4), dev)
    if mask.device != dev or mask.dtype != torch.bool:
        raise TypeError(f"mask must be a bool tensor on {dev}, got {mask.dtype} on {mask.device}")
    if tuple(mask.shape) != (B, T, Aq, Ak) or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous [B, T, Aq, Ak] = {(B, T, Aq, Ak)}, "
                         f"got {tuple(mask.shape)}")
    w = torch.cat([packed[k].reshape(-1) for k in (*W_ORDER, "wq", "bq")]).contiguous()
    _check("packed weights", w, (lib.aa_attention_weight_floats(),), dev)
    out = torch.empty_like(center_norm)
    R = B * T * Aq
    if R == 0:
        return out
    grid = _grid(R, _entry(lib, "aa_attention", "receivers_per_group", num_heads,
                           compute_dtype)(), dev)
    fn = _entry(lib, "aa_attention", "launch", num_heads, compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(center_norm.data_ptr(), x_k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
                 rot.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(), R, T, Aq, Ak,
                 grid, stream)
    if err != 0:
        raise RuntimeError(f"aa_attention ({compute_dtype}) kernel launch failed: cudaError {err}")
    return out


def _launch(center_norm, x_k, pos_q, pos_k, rot, mask, packed, num_heads,
            compute_dtype: str = "float32") -> torch.Tensor:
    """K5, counted in ``aa_attention.launches``; K5b in bf16, counted in
    ``aa_attention.bf16_launches``."""
    out = launch(_library(), center_norm, x_k, pos_q, pos_k, rot, mask, packed, num_heads,
                 compute_dtype)
    if center_norm.numel():  # no receivers: nothing was launched
        if _check_dtype(compute_dtype):
            aa_attention.bf16_launches += 1
        else:
            aa_attention.launches += 1
    return out


def aa_attention(center_norm: torch.Tensor, x_k: torch.Tensor, pos_q: torch.Tensor,
                 pos_k: torch.Tensor, rot: torch.Tensor, mask: torch.Tensor,
                 packed: Dict[str, torch.Tensor], num_heads: int, t_chunk: int = 3,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """Pre-gating AA aggregate [B, T, Aq, D] f32.

    center_norm [B, T, Aq, D] f32: the normed centre embeddings
    x_k         [B, T, Ak, 2] f32: sender displacement features
    pos_q       [B, T, Aq, 2] f32 and pos_k [B, T, Ak, 2] f32: positions
    rot         [B, Aq, 4] f32: each receiver's rotation, row-major 2x2
    mask        [B, T, Aq, Ak] bool adjacency (a receiver with none gives 0)
    packed      the 14 pair-chain weights of ``pack_aa_params`` plus wq, bq

    ``t_chunk`` is the TPU kernel's tiling and is ignored.  On CUDA kernel
    K5 (D 64, ``num_heads`` 8 or 4) runs on the current stream without synchronising and
    ``aa_attention.launches`` counts its launches; on the CPU the plain
    version runs.  ``compute_dtype="bfloat16"`` computes at the JAX op's
    bf16 rounding points (:func:`aa_attention_reference`): on CUDA kernel
    K5b, counted in ``aa_attention.bf16_launches``; the inputs and the
    output stay f32.
    """
    del t_chunk  # the TPU's tiling of T; the kernel walks receiver groups
    _check_dtype(compute_dtype)
    if _device_kind(center_norm, "aa_attention") == "cuda":
        return _launch(center_norm, x_k, pos_q, pos_k, rot, mask, packed, num_heads,
                       compute_dtype)
    return aa_attention_reference(center_norm, x_k, pos_q, pos_k, rot, mask, packed, num_heads,
                                  compute_dtype)


counted(aa_attention, "launches", "bf16_launches")
