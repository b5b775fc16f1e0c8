"""ctypes wrapper of the simplicial sparse Cholesky (``cholesky.cpp``).

Port of ``largesteps_tpu/native/cholesky.py``, loading the port's own build:
an LLᵀ factor of an SPD matrix in float64 under a reverse Cuthill-McKee
order, ``factorize`` once per topology epoch and ``solve`` per step.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

__all__ = ["factorize", "NativeCholesky"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build.lib_path())
        lib.ls_chol_factorize.restype = ctypes.c_void_p
        lib.ls_chol_factorize.argtypes = [
            ctypes.c_int, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
        ]
        lib.ls_chol_solve.restype = ctypes.c_int
        lib.ls_chol_solve.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int,
        ]
        lib.ls_chol_nnz_factor.restype = ctypes.c_int64
        lib.ls_chol_nnz_factor.argtypes = [ctypes.c_void_p]
        lib.ls_chol_free.restype = None
        lib.ls_chol_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeCholesky:
    """The factor of the n × n matrix given as COO (rows, cols, vals);
    raises when the factorization fails (a matrix that is not SPD)."""

    def __init__(self, n, rows, cols, vals):
        rows = np.ascontiguousarray(rows, np.int32)
        cols = np.ascontiguousarray(cols, np.int32)
        vals = np.ascontiguousarray(vals, np.float64)
        if not (rows.shape == cols.shape == vals.shape and rows.ndim == 1):
            raise ValueError("rows, cols and vals must be 1-d of one length")
        if rows.size and (min(rows.min(), cols.min()) < 0
                          or max(rows.max(), cols.max()) >= n):
            raise ValueError("matrix indices out of range")
        lib = _load()
        self._lib = lib
        self._handle = lib.ls_chol_factorize(int(n), len(vals), rows, cols,
                                             vals)
        if not self._handle:
            raise RuntimeError("native Cholesky factorization failed "
                               "(matrix not SPD?)")
        self.n = int(n)
        self.nnz_factor = lib.ls_chol_nnz_factor(self._handle)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = A⁻¹ b for b (n,) or (n, k), in float64."""
        b = np.ascontiguousarray(b, np.float64)
        if b.shape[0] != self.n or b.ndim not in (1, 2):
            raise ValueError(f"b must be ({self.n},) or ({self.n}, k); "
                             f"got {b.shape}")
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        b = np.ascontiguousarray(b)
        x = np.empty_like(b)
        rc = self._lib.ls_chol_solve(self._handle, b, x, b.shape[1])
        if rc != 0:
            raise RuntimeError("native Cholesky solve failed")
        return x[:, 0] if squeeze else x

    def close(self):
        """Free the factor now (it is freed with the object otherwise)."""
        if getattr(self, "_handle", None):
            self._lib.ls_chol_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def factorize(n, rows, cols, vals) -> NativeCholesky:
    return NativeCholesky(n, rows, cols, vals)
