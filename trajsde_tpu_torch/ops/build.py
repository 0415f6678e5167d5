"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled for Hopper (``sm_90a``) into ``_build/lib<name>.so`` beside the
package; it is rebuilt when the source is newer than the library.  The
build writes a temporary file and renames it into place, so concurrent
builders never load a half-written library.  A failed build raises with
nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}  # name -> nvcc's output of the last build in this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from source at first use"
        )
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if the library is missing or stale;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.rename(tmp, lib)
    build_log[name] = (f"built {lib} in {time.perf_counter() - t0:.2f} s\n"
                       f"{proc.stdout}{proc.stderr}")
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
