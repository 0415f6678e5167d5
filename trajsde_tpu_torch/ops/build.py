"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled for Hopper (``sm_90a``) into ``_build/lib<name>.so`` beside the
package; it is rebuilt when the source or a shared ``csrc/*.cuh`` header
is newer than the library, and several sources build in parallel.  The
build writes a temporary file and renames it into place, so concurrent
builders never load a half-written library.  A failed build raises with
nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

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


def _is_fresh(lib: str, src: str) -> bool:
    """The library exists and is newer than its source and every shared
    header in ``csrc/``."""
    if not os.path.exists(lib):
        return False
    deps = [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) >= max(os.path.getmtime(d) for d in deps)


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every missing or stale ``csrc/<name>.cu``, one nvcc process
    per source, all started together; returns each library's path."""
    libs = {n: os.path.join(BUILD_DIR, f"lib{n}.so") for n in names}
    srcs = {n: os.path.join(CSRC_DIR, f"{n}.cu") for n in names}
    stale = [n for n in names if not _is_fresh(libs[n], srcs[n])]
    if not stale:
        return libs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in stale:
        src = srcs[name]
        tmp = f"{libs[name]}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, tmp, proc, time.perf_counter()))
    failures = []
    for name, src, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f"nvcc failed to build {src} (exit {proc.returncode}):\n{out}")
            continue
        os.rename(tmp, libs[name])
        build_log[name] = f"built {libs[name]} in {time.perf_counter() - t0:.2f} s\n{out}"
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries of ``names``, the missing ones built in parallel."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        for name, path in build_all(missing).items():
            _libs[name] = ctypes.CDLL(path)
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call)."""
    return load_all([name])[name]


def build_copies(sources: Dict[str, str], out_dir: str) -> Dict[str, tuple]:
    """Builds other sources (variants of a kernel, probes) into
    ``out_dir/lib<name>.so``, one nvcc process each, all started together,
    with ``csrc/`` on the include path after each source's own directory;
    returns name -> (loaded library, nvcc's output).  Always rebuilds."""
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", so, src],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs, failures = {}, []
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed to build {sources[name]} "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        libs[name] = (ctypes.CDLL(so), out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs
