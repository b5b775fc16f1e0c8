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

``-Xptxas -v`` makes ptxas report each kernel's registers, stack frame,
spills and shared memory; the report is kept beside the library and read
back by :func:`ptxas_info`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["library", "check", "build_all", "ptxas_info", "stream",
           "launch_shape"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature (argtypes, restype) of every exported function; the kernel
# ``name``'s launcher is ``ls_<name>`` and returns a cudaError_t
_SIGNATURES = {
    # (..., C, TY, TX, cap, H, W, row0, sxs, sys, stream): H the planes'
    # rows, row0 their first tile row in the image
    "ls_raster_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
                      _I),
    "ls_raster_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _P], _I),
    # the antialias kernels' halo rows and share row follow the scratch
    # (null without row shards): (..., C, TY, TX, cap, H, W, D, row0, sxs,
    # sys, stream)
    "ls_aa_fwd": ([_P] * 11 + [_I] * 8 + [_F, _F, _P], _I),
    "ls_aa_bwd": ([_P] * 15 + [_I] * 8 + [_F, _F, _P], _I),
    # bytes of global scratch the antialias owner tables need, from
    # (tiles, cap); exported by aa_fwd's library, used by both kernels
    "ls_aa_scratch": ([_I, _I], ctypes.c_longlong),
    # bytes of aa_bwd's pair lists (each strip's blending pairs, summed in
    # a fixed order by a second kernel), from tiles
    "ls_aa_pairs_bytes": ([_I], ctypes.c_longlong),
    # the rasterizer micro-benchmarks' kernels (largesteps_torch.benchmarks)
    "ls_onehot_scatter": ([_P, _P, _P, ctypes.c_longlong, _I, _I, _P], _I),
    "ls_probe_tile": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
    # probe_tile over a range of its work items (kernel_probe.py times the
    # sums items and the field items alone): (..., B, cap, first, n, stream)
    "ls_probe_tile_items": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    # launch shapes, written to a long long array: probe_tile's {blocks,
    # threads, shared bytes, blocks an SM holds, work items} at (B, cap);
    # onehot_scatter's plan at (entries, ch)
    "ls_probe_tile_grid": ([_I, _I, _P], None),
    "ls_onehot_scatter_plan": ([ctypes.c_longlong, _I, _P], None),
    # the banded tier's solve (core/banded.py): (invD, L, b, perm, out,
    # scratch, n, B, nb, k, stream); its plan {blocks, threads, strip
    # width, strips, stages, shared bytes, blocks an SM holds} at (B, k)
    "ls_banded_sweep": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "ls_banded_sweep_plan": ([_I, _I, _P], None),
    # the prebinned pipe's backward glue (render/kernels.py:chain_face_rows):
    # (dslot, dslot_aa, rbb, fslots, dface, C, F+1, K, T·cap, TX·cap,
    # up_rows, boost, stream)
    "ls_chain_face_rows": ([_P] * 5 + [_I, _I, _I, ctypes.c_longlong,
                                       ctypes.c_longlong, _I, _F, _P], _I),
    # the prebinned pipe's forward setup (render/kernels.py:setup_slots):
    # (v_clip, faces, attrs, opp, bins, rfb or null, rbb, C, T, cap, V, F,
    # the bins' three strides, bins64, height / 2, stream)
    "ls_setup_slots": ([_P] * 7 + [_I, _I, _I] + [ctypes.c_longlong] * 5
                       + [_I, _F, _P], _I),
}
_KERNELS = ("raster_fwd", "raster_bwd", "aa_fwd", "aa_bwd", "onehot_scatter",
            "probe_tile", "banded_sweep", "chain_face_rows", "setup_slots")

_lock = threading.Lock()
_handles: dict = {}
_fns: dict = {}


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
    for name in _KERNELS:
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
        with open(f"{tmp}.ptxas", "wb") as fh:
            fh.write(out)
        os.replace(f"{tmp}.ptxas", f"{lib}.ptxas.txt")
        os.replace(tmp, lib)          # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def library(name: str, symbol: str = ""):
    """The loaded function ``symbol`` (default ``ls_<name>``, the launcher)
    of kernel ``name``'s library, built on first use."""
    symbol = symbol or f"ls_{name}"
    with _lock:
        if symbol not in _fns:
            if name not in _handles:
                build_all()
                _handles[name] = ctypes.CDLL(_sources()[name][1])
            fn = getattr(_handles[name], symbol)
            fn.argtypes, fn.restype = _SIGNATURES[symbol]
            _fns[symbol] = fn
        return _fns[symbol]


_PTXAS = {
    "registers": r"Used (\d+) registers",
    "stack_bytes": r"(\d+) bytes stack frame",
    "spill_stores": r"(\d+) bytes spill stores",
    "spill_loads": r"(\d+) bytes spill loads",
    "smem_bytes": r"(\d+) bytes smem",
}


def ptxas_info(name: str) -> dict:
    """What ptxas reported for each entry function (mangled name) of kernel
    ``name``'s library, built first if missing: {entry: {"registers",
    "stack_bytes", "spill_stores", "spill_loads", "smem_bytes", "lines"}}
    (smem 0 where ptxas names none)."""
    build_all()
    with open(_sources()[name][1] + ".ptxas.txt", errors="replace") as fh:
        text = fh.read()
    info, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            entry = m.group(1)
            info.setdefault(entry, {**dict.fromkeys(_PTXAS), "smem_bytes": 0,
                                    "lines": []})
            continue
        hits = {k: re.search(rx, line) for k, rx in _PTXAS.items()}
        if entry is None or not any(hits.values()):
            continue
        info[entry]["lines"].append(line.strip())
        for k, m in hits.items():
            if m:
                info[entry][k] = int(m.group(1))
    return info


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, by PyTorch's
    private accessor: ``torch.cuda.current_stream(device).cuda_stream``
    builds a Stream object, about 10 µs of host time a call against 0.2
    (``kernel_probe.py``, PERF.md), which a launch of a few microseconds
    cannot carry."""
    import torch
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


_SHAPES = {"probe_tile": "ls_probe_tile_grid",
           "onehot_scatter": "ls_onehot_scatter_plan",
           "banded_sweep": "ls_banded_sweep_plan"}


def launch_shape(name: str, *args) -> list:
    """The launch shape that kernel ``name``'s library reports for a call's
    ``args`` (``_SIGNATURES``: ``ls_probe_tile_grid``,
    ``ls_onehot_scatter_plan``, ``ls_banded_sweep_plan``), as a list of
    ints."""
    out = (ctypes.c_longlong * 8)()
    library(name, _SHAPES[name])(*args, out)
    return list(out)


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
