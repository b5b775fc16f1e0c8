"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries go to ``largesteps_torch/_build/`` under a name that carries a
hash of the sources (and of the flags), so an unchanged tree is not rebuilt.
All sources build in parallel, one ``nvcc`` process each, at the first
launch of any kernel; nothing is built when the package is imported.

``-fmad=false`` keeps ``a*b + c`` as two rounded operations, as PyTorch's
elementwise kernels compute it, so a kernel rounds like its plain PyTorch
version and the two agree on coverage and face ids bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["library", "check", "build_all"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: (argtypes), all return cudaError_t
_SIGNATURES = {
    "raster_fwd": ("ls_raster_fwd", [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _F, _P]),
    "raster_bwd": ("ls_raster_bwd", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _F, _F, _P]),
    "aa_fwd": ("ls_aa_fwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _F, _F, _P]),
    "aa_bwd": ("ls_aa_bwd", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _F, _F, _P]),
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit needed)")
    return path


def _sources():
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for h in headers:
        with open(os.path.join(_CSRC, h), "rb") as fh:
            digest.update(fh.read())
    common = digest.hexdigest()
    out = {}
    for name in _SIGNATURES:
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as fh:
            tag = hashlib.sha256(common.encode() + fh.read()).hexdigest()[:16]
        out[name] = (src, os.path.join(_BUILD, f"lib{name}_{tag}.so"))
    return out


def build_all() -> dict:
    """Build every kernel library that is missing, all ``nvcc`` processes
    at once; returns {name: seconds} of what was built."""
    todo = {n: (s, lib) for n, (s, lib) in _sources().items()
            if not os.path.exists(lib)}
    if not todo:
        return {}
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, (src, lib) in todo.items():
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *_FLAGS, "-I", _CSRC, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, lib)
    errors, seconds = [], {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)          # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def library(name: str):
    """The loaded entry point of kernel ``name``, built on first use."""
    with _lock:
        if name not in _libs:
            build_all()
            src, lib = _sources()[name]
            handle = ctypes.CDLL(lib)
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(handle, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = (handle, fn)
        return _libs[name][1]


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
