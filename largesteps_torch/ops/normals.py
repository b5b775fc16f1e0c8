"""Face and angle-weighted vertex normals (differentiable).

Port of ``largesteps_tpu/ops/normals.py``: per-corner angle weights, summed
into vertices in a fixed order (``ops/segment.py``: the corners of each
vertex in corner order, and so are the gradients of the corner gathers;
``index_add`` on the card adds in no fixed order).  Every normalization is
``a * rsqrt(‖a‖² + ε)``: ``norm()``'s backward is 0/0 at a degenerate face,
and one NaN component poisons every parameter through AdamUniform.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import safe_acos
from .segment import Segments

__all__ = ["compute_face_normals", "compute_vertex_normals",
           "corner_segments"]

_EPS = 1e-20


def _faces_on(faces, device) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(faces, dtype=np.int64), device=device)


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + _EPS)


def corner_segments(faces, n_verts: int, device) -> Segments:
    """The corners of faces (F, 3), corner i of every face after corner
    i − 1 of every face, as segments of their vertices: built once a
    topology, and passed to the two functions below."""
    return Segments(_faces_on(faces, device).t(), n_verts)


def _corners(verts, faces, corners):
    """verts at the faces' corners (F, 3, 3); the gradient summed into the
    vertices in a fixed order."""
    if corners is None:
        corners = corner_segments(faces, verts.shape[0], verts.device)
    return corners.gather(verts).reshape(3, -1, 3).transpose(0, 1)


def compute_face_normals(verts: torch.Tensor, faces,
                         corners: Segments | None = None) -> torch.Tensor:
    """Unit face normals (F, 3): ``cross(v1 − v0, v2 − v0)`` normalized.
    ``corners``: :func:`corner_segments` of the faces, if made."""
    fv = _corners(verts, faces, corners)
    c = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=1)
    return _unit(c)


def compute_vertex_normals(verts: torch.Tensor, faces,
                           face_normals: torch.Tensor,
                           corners: Segments | None = None) -> torch.Tensor:
    """Angle-weighted vertex normals (V, 3).  ``corners``:
    :func:`corner_segments` of the faces, if made."""
    if corners is None:
        corners = corner_segments(faces, verts.shape[0], verts.device)
    fv = _corners(verts, faces, corners)
    contributions = []
    for i in range(3):
        d0 = _unit(fv[:, (i + 1) % 3] - fv[:, i])
        d1 = _unit(fv[:, (i + 2) % 3] - fv[:, i])
        angle = safe_acos(torch.sum(d0 * d1, dim=1))
        contributions.append(face_normals * angle[:, None])
    # corner i of face f -> faces[f, i], in corner_segments' order
    return _unit(corners.sum(torch.cat(contributions, dim=0)))
