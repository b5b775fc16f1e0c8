"""Geometric quality metrics.

Port of ``largesteps_tpu/metrics.py``: the symmetric Hausdorff distance
``igl.hausdorff(va, fa, vb, fb) + igl.hausdorff(vb, fb, va, fa)``, the
quality metric of figures/comparison/generate_data.py:78-88 (halved in the
influence figure), by the BVH of ``native/hausdorff.cpp``.  The numpy
version :func:`_hausdorff_numpy` is the plain reference the tests hold the
library to; nothing falls back to it (at nefertiti's 163,842 × 327,680 it
would run for hours): a library that does not build raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["hausdorff", "symmetric_hausdorff"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .native.build import lib_path
        lib = ctypes.CDLL(lib_path())
        lib.ls_hausdorff.restype = ctypes.c_double
        lib.ls_hausdorff.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int,
        ]
        _lib = lib
    return _lib


def _hausdorff_numpy(va, vb, fb, chunk=256):
    """The plain version: exact point-to-triangle distances, chunked
    numpy."""
    tri = vb[fb]                                   # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    worst = 0.0
    for s in range(0, len(va), chunk):
        p = va[s:s + chunk][:, None, :]            # (P, 1, 3)
        ab, ac = b - a, c - a
        ap = p - a[None]
        d1 = (ab[None] * ap).sum(-1)
        d2 = (ac[None] * ap).sum(-1)
        bp = p - b[None]
        d3 = (ab[None] * bp).sum(-1)
        d4 = (ac[None] * bp).sum(-1)
        cp = p - c[None]
        d5 = (ab[None] * cp).sum(-1)
        d6 = (ac[None] * cp).sum(-1)
        va_ = d3 * d6 - d5 * d4
        vb_ = d5 * d2 - d1 * d6
        vc_ = d1 * d4 - d3 * d2
        denom = va_ + vb_ + vc_
        denom = np.where(np.abs(denom) < 1e-300, 1.0, denom)
        v = vb_ / denom
        w = vc_ / denom
        # the plane's closest point, a candidate only where it lies inside
        # the triangle (clipping v and w alone would take points past edge
        # bc, nearer than the triangle: JAX's copy of this function does,
        # ROADMAP.md Queue 3)
        inside = (v >= 0) & (w >= 0) & (v + w <= 1)
        q_int = a[None] + ab[None] * v[..., None] + ac[None] * w[..., None]
        # edge/vertex candidates
        def seg(p0, p1):
            d = p1 - p0
            t = ((p - p0[None]) * d[None]).sum(-1) / np.maximum((d * d).sum(-1)[None], 1e-300)
            t = np.clip(t, 0, 1)
            return p0[None] + d[None] * t[..., None]
        d2min = np.where(inside, ((p - q_int) ** 2).sum(-1), np.inf)
        for q in (seg(a, b), seg(b, c), seg(c, a)):
            d2min = np.minimum(d2min, ((p - q) ** 2).sum(-1))
        worst = max(worst, float(np.sqrt(d2min.min(axis=1).max())))
    return worst


def hausdorff(va, fa, vb, fb) -> float:
    """One-directional h(A→B): max over A's vertices of distance to surface
    B (fa is accepted for API parity with igl and unused, like igl's
    vertex-sampled approximation)."""
    del fa
    va = np.ascontiguousarray(va, np.float64)
    vb = np.ascontiguousarray(vb, np.float64)
    fb = np.ascontiguousarray(fb, np.int32)
    # the library reads vb[fb] unchecked: hold the shapes and indices here
    for name, a in (("va", va), ("vb", vb), ("fb", fb)):
        if a.ndim != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be (n, 3), got {a.shape}")
    if not len(fb) or fb.min() < 0 or fb.max() >= len(vb):
        raise ValueError(f"fb must hold at least one face of indices into "
                         f"the {len(vb)} vertices of vb")
    return float(_load().ls_hausdorff(va, len(va), vb, len(vb), fb, len(fb)))


def symmetric_hausdorff(va, fa, vb, fb) -> float:
    """h(A→B) + h(B→A), the comparison-figure metric
    (figures/comparison/generate_data.py:86-88).

    Non-finite vertices (a diverged optimization) return inf at once: NaN
    coordinates make the BVH traversal's comparisons all false, and it
    would never end."""
    if not (np.isfinite(np.asarray(va)).all()
            and np.isfinite(np.asarray(vb)).all()):
        return float("inf")
    return hausdorff(va, fa, vb, fb) + hausdorff(vb, fb, va, fa)
