"""Build the port's host library of C++ code, lazily, at its first use.

The sources (``hausdorff.cpp``, ``remesh.cpp``, ``cholesky.cpp`` and their
``bvh.hpp``, copies of the JAX package's) compile with the JAX build's
flags, ``g++ -O3 -std=c++17 -shared -fPIC -march=native -funroll-loops``,
into one shared object under ``native/_build/``.  Its name carries a hash
of the sources, the flags and the host's CPU (``-march=native`` code runs
only on the CPU it was built for), so an unchanged tree is not rebuilt and
two hosts sharing a checkout never load each other's library.  A failed
build raises: nothing falls back to another implementation.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading

__all__ = ["lib_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
SOURCES = ("hausdorff.cpp", "remesh.cpp", "cholesky.cpp")
HEADERS = ("bvh.hpp",)
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
         "-funroll-loops")
_lock = threading.Lock()


def _host_cpu() -> str:
    """The host's architecture, CPU model and feature flags."""
    keys = ("model name", "flags", "Features", "CPU part")
    lines = []
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.split(":")[0].strip() in keys and line not in lines:
                    lines.append(line)
                if not line.strip() and lines:
                    break           # the first processor is enough
    except OSError:
        pass
    return platform.machine() + "".join(lines)


def lib_path(src_dir: str = _DIR, build_dir: str = _BUILD) -> str:
    """The path of the built library, building it if it is not there."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(src_dir, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    h.update(" ".join(FLAGS).encode() + _host_cpu().encode())
    lib = os.path.join(build_dir, f"libls_native_{h.hexdigest()[:16]}.so")
    with _lock:
        if os.path.exists(lib):
            return lib
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, *(os.path.join(src_dir, s) for s in SOURCES),
               "-o", tmp]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {lib}: {e}") from e
        if out.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {lib} failed ({' '.join(cmd)}):\n"
                               f"{out.stderr[-4000:]}")
        os.replace(tmp, lib)        # atomic: concurrent builds agree
        return lib
