"""Elementwise-rate probe: kernel K6, its wrapper and its plain version.

Counterpart of the Pallas probe in ``scripts/bench_vpu_dtype.py``
(``run`` -> ``_kernel``): 64 chained ``x = tanh(x) * x + x`` on a tile, in
f32 or bf16.  It times the elementwise rate that decides whether a bf16
spine pays in the AA kernels; ``scripts/bench_vpu_dtype_torch.py`` runs it.

On a CUDA tensor :func:`chained_tanh` launches ``csrc/vpu_probe.cu``
(built by nvcc at first use, bound with ctypes); on a CPU tensor the plain
version runs.  Nothing falls back from one to the other.

The kernel is held against the plain version element by element
(:func:`agreement`): in units of the last place of each plain value in its
type (:func:`ulps`), and by the share of bit-equal elements.  The values
span 3e-8 to 6e18 after 64 rounds, so a limit scaled by the largest one
would leave most elements unchecked.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from trajsde_tpu_torch.ops import counted

ROUNDS = 64  # fixed in the kernel, as in the JAX probe
# values one thread loads as 16 bytes
_PER_VECTOR = {torch.float32: 4, torch.bfloat16: 8}
# significant bits, the implicit leading one included
_BITS = {torch.float32: 24, torch.bfloat16: 8}
# the kernel's variants: name -> (dtype, approx_f32_tanh)
VARIANTS = {"float32": (torch.float32, False), "float32-approx": (torch.float32, True),
            "bfloat16": (torch.bfloat16, False)}
# Kernel vs plain, per variant; readings on an H100 over the probe's
# [65536, 128] tile in brackets (scripts/check_vpu_probe_faults_torch.py).
# TOL_ULPS: the most any element may differ, in ulps of the plain value.
# float32 (306): one FMA per round where the plain version rounds the
# product first, carried on by the later rounds (up to x1.3 a round while
# tanh(x) x is near x); float32-approx (1574) and bfloat16 (92): the
# approximate tanh (tanh.approx.f32, tanh.approx.bf16x2) against the
# accurate one, carried on the same way.
TOL_ULPS = {"float32": 512, "float32-approx": 4096, "bfloat16": 128}
# MIN_BIT_EQUAL: the least share of bit-equal elements, held on outputs of
# at least MIN_BIT_EQUAL_SIZE elements.  It tells rounding faults that stay
# within TOL_ULPS from the kernel: bf16 reads 0.354 as it is and 0.278 with
# the multiply and add contracted into one FMA (each 92-97 ulps at most);
# float32 0.505, and 0.033 with the approximate tanh; float32-approx 0.033.
MIN_BIT_EQUAL = {"float32": 0.45, "float32-approx": 0.025, "bfloat16": 0.32}
MIN_BIT_EQUAL_SIZE = 65536


def chained_tanh_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: every operation rounds to ``x``'s dtype."""
    for _ in range(ROUNDS):
        x = torch.tanh(x) * x + x
    return x


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` per element in units of the last place of ``want``
    in ``want``'s dtype, as f64 (a ``want`` of 0 counts in units of
    2^-bits)."""
    _, exp = torch.frexp(want.float())
    unit = torch.ldexp(torch.ones_like(want, dtype=torch.float64),
                       (exp - _BITS[want.dtype]).double())
    return (got.double() - want.double()).abs() / unit


def agreement(got: torch.Tensor, want: torch.Tensor, variant: str) -> dict:
    """Kernel output ``got`` vs plain ``want`` of ``variant``: the largest
    error in ulps, the share of bit-equal elements, and whether both are
    within their limits."""
    err = ulps(got, want)
    max_ulps, equal = err.max().item(), (err == 0).double().mean().item()
    ok = max_ulps <= TOL_ULPS[variant] and (want.numel() < MIN_BIT_EQUAL_SIZE
                                            or equal >= MIN_BIT_EQUAL[variant])
    return dict(max_ulps=max_ulps, bit_equal=equal, ok=ok)


def _kind(dtype: torch.dtype, approx_f32_tanh: bool) -> int:
    """The launcher's ``kind``: 0 f32 tanhf, 1 f32 tanh.approx.f32, 2 bf16."""
    if dtype == torch.float32:
        return int(approx_f32_tanh)
    if dtype == torch.bfloat16:
        if approx_f32_tanh:
            raise ValueError("approx_f32_tanh applies to float32: bfloat16 always takes the "
                             "packed approximate tanh")
        return 2
    raise TypeError(f"the probe kernel takes float32 or bfloat16, got {dtype}")


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``lib.vpu_probe_launch``."""
    lib.vpu_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.vpu_probe_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _library():
    from trajsde_tpu_torch.ops import build

    return configure(build.load("vpu_probe"))


def launch(lib: ctypes.CDLL, x: torch.Tensor, approx_f32_tanh: bool = False) -> torch.Tensor:
    """Runs ``lib``'s ``vpu_probe_launch`` on ``x`` on the current stream
    and returns the output; counts nothing (see :func:`chained_tanh`)."""
    kind = _kind(x.dtype, approx_f32_tanh)
    per = _PER_VECTOR[x.dtype]
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("the probe kernel reads 16-byte vectors: x must be contiguous and "
                         "16-byte aligned")
    if x.numel() == 0 or x.numel() % per != 0:
        raise ValueError(f"the probe kernel needs a positive multiple of {per} {x.dtype} "
                         f"values, got {x.numel()}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vpu_probe_launch(x.data_ptr(), y.data_ptr(), x.numel(), kind, stream)
    if err != 0:
        raise RuntimeError(f"vpu_probe kernel launch failed: cudaError {err}")
    return y


def chained_tanh(x: torch.Tensor, approx_f32_tanh: bool = False) -> torch.Tensor:
    """64 x ``x = tanh(x) * x + x``.  On CUDA kernel K6 runs on the current
    stream without synchronising and ``chained_tanh.launches`` counts its
    launches; ``approx_f32_tanh`` takes ``tanh.approx.f32`` in place of
    ``tanhf`` (bfloat16 always takes the packed approximate tanh).  On the
    CPU the plain version runs."""
    if x.device.type == "cuda":
        y = launch(_library(), x, approx_f32_tanh)
        chained_tanh.launches += 1
        return y
    if x.device.type != "cpu":
        raise ValueError(f"chained_tanh runs on cuda (kernel) or cpu (plain), not {x.device}")
    _kind(x.dtype, approx_f32_tanh)
    return chained_tanh_reference(x)


counted(chained_tanh, "launches")
