"""Mesh utilities: vertex welding, edge length, Voronoi cell areas and a
clamped ``acos``.

Port of ``largesteps_tpu/ops/mesh.py`` (``remove_duplicates``,
``average_edge_length``, ``massmatrix_voronoi``, ``safe_acos``; reference
scripts/geometry.py).  Welding changes the vertex count, so it runs on the
host with numpy; the rest are torch functions on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .segment import Segments

__all__ = ["remove_duplicates", "average_edge_length", "massmatrix_voronoi",
           "safe_acos"]


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


def _as_tensors(verts, faces):
    v = torch.as_tensor(verts)
    return v, torch.as_tensor(faces, device=v.device).long()


def average_edge_length(verts, faces) -> torch.Tensor:
    """Mean length of all face sides, each interior edge counted twice
    (scripts/geometry.py:13-33); in ``verts``' dtype."""
    v, f = _as_tensors(verts, faces)
    fv = v[f]
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    a = torch.linalg.norm(v1 - v2, dim=1)
    b = torch.linalg.norm(v0 - v2, dim=1)
    c = torch.linalg.norm(v0 - v1, dim=1)
    return (a + b + c).sum() / (3 * f.shape[0])


def massmatrix_voronoi(verts, faces) -> torch.Tensor:
    """Voronoi cell area around each vertex, (V,), with the obtuse-triangle
    correction (scripts/geometry.py:35-89): a corner past 90° takes half
    its triangle's area and the other two a quarter each."""
    v, f = _as_tensors(verts, faces)
    fv = v[f]
    l0 = torch.linalg.norm(fv[:, 1] - fv[:, 2], dim=1)
    l1 = torch.linalg.norm(fv[:, 2] - fv[:, 0], dim=1)
    l2 = torch.linalg.norm(fv[:, 0] - fv[:, 1], dim=1)
    l = torch.stack([l0, l1, l2], dim=1)

    cos0 = (l1**2 + l2**2 - l0**2) / (2 * l1 * l2)
    cos1 = (l2**2 + l0**2 - l1**2) / (2 * l2 * l0)
    cos2 = (l0**2 + l1**2 - l2**2) / (2 * l0 * l1)
    cosines = torch.stack([cos0, cos1, cos2], dim=1)

    barycentric = cosines * l
    barycentric = barycentric / barycentric.sum(dim=1, keepdim=True)

    areas = 0.25 * torch.sqrt(torch.clamp(
        (l0 + l1 + l2) * (l0 + l1 - l2) * (l0 - l1 + l2) * (-l0 + l1 + l2),
        min=0.0))
    tri_areas = areas[:, None] * barycentric

    cells = torch.stack([0.5 * (tri_areas[:, 1] + tri_areas[:, 2]),
                         0.5 * (tri_areas[:, 2] + tri_areas[:, 0]),
                         0.5 * (tri_areas[:, 0] + tri_areas[:, 1])], dim=1)

    # the obtuse corrections, one corner after the other as the reference
    # applies them
    for k in range(3):
        obtuse = cosines[:, k] < 0
        cols = [None] * 3
        cols[k] = torch.where(obtuse, 0.5 * areas, cells[:, k])
        for j in ((k + 1) % 3, (k + 2) % 3):
            cols[j] = torch.where(obtuse, 0.25 * areas, cells[:, j])
        cells = torch.stack(cols, dim=1)

    # each vertex's corners in corner order (a fixed order on the card)
    return Segments(f.reshape(-1), v.shape[0]).sum(cells.reshape(-1))
