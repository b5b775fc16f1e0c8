"""ctypes wrapper of the Botsch-Kobbelt remesher (``remesh.cpp``).

Port of ``largesteps_tpu/native/remesh.py``, loading the port's own build.
The surface is the reference's ``pyremesh.remesh_botsch(v, f, iters, h,
project)`` (scripts/main.py:149).  Numpy in, numpy out: the remesher runs on
the host between two topology epochs.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

__all__ = ["remesh_botsch"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build.lib_path())
        lib.ls_remesh.restype = ctypes.c_int
        lib.ls_remesh.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ls_free_buf.restype = None
        lib.ls_free_buf.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def remesh_botsch(v, f, iterations: int = 5, h: float = 0.1,
                  project: bool = True):
    """Isotropic remesh of (v (V, 3), f (F, 3)) to the target edge length
    ``h``: ``iterations`` rounds of splits past 4/3·h, collapses below
    4/5·h, valence flips and tangential relaxation, projected back onto
    the input surface when ``project``.  Returns (v' float64, f' int32)."""
    v = np.ascontiguousarray(v, np.float64)
    f = np.ascontiguousarray(f, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"v and f must be (n, 3); got {v.shape}, {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face indices out of range")
    lib = _load()
    out_v = ctypes.POINTER(ctypes.c_double)()
    out_f = ctypes.POINTER(ctypes.c_int)()
    out_nv = ctypes.c_int()
    out_nf = ctypes.c_int()
    rc = lib.ls_remesh(v, len(v), f, len(f), int(iterations), float(h),
                       int(bool(project)), ctypes.byref(out_v),
                       ctypes.byref(out_nv), ctypes.byref(out_f),
                       ctypes.byref(out_nf))
    if rc != 0:
        raise RuntimeError(f"remesh failed (code {rc})")
    try:
        nv, nf = out_nv.value, out_nf.value
        v_new = np.ctypeslib.as_array(out_v, shape=(nv, 3)).copy()
        f_new = np.ctypeslib.as_array(out_f, shape=(nf, 3)).copy()
    finally:
        lib.ls_free_buf(out_v)
        lib.ls_free_buf(out_f)
    return v_new, f_new.astype(np.int32)
