"""Mesh utilities: vertex welding and a clamped ``acos``.

Port of ``largesteps_tpu/ops/mesh.py`` (``remove_duplicates``,
``safe_acos``).  ``average_edge_length`` and ``massmatrix_voronoi`` belong
to the remeshing and metrics slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["remove_duplicates", "safe_acos"]


def remove_duplicates(v, f):
    """Weld duplicated vertices on the host.

    Returns (unique_verts, new_faces, duplicate_idx) with
    ``verts == unique_verts[duplicate_idx]``; ``np.unique(axis=0)`` sorts
    rows, as the JAX package and the reference's ``torch.unique`` do.
    """
    v = np.asarray(v)
    f = np.asarray(f)
    unique_verts, inverse = np.unique(v, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1).astype(np.int32)
    new_faces = inverse[f.astype(np.int64)]
    return unique_verts, new_faces.astype(np.int32), inverse


def safe_acos(x: torch.Tensor) -> torch.Tensor:
    """``acos`` clamped strictly inside ±(1 − 1e-6): at exactly ±1 the
    derivative is infinite, and one inf gradient component turns every
    parameter NaN through AdamUniform's global-max denominator."""
    return torch.arccos(torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6))
