"""Face and angle-weighted vertex normals (differentiable).

Port of ``largesteps_tpu/ops/normals.py``: per-corner angle weights, summed
into vertices with ``index_add``.  Every normalization is
``a * rsqrt(‖a‖² + ε)``: ``norm()``'s backward is 0/0 at a degenerate face,
and one NaN component poisons every parameter through AdamUniform.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import safe_acos

__all__ = ["compute_face_normals", "compute_vertex_normals"]

_EPS = 1e-20


def _faces_on(faces, device) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(faces, dtype=np.int64), device=device)


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + _EPS)


def compute_face_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Unit face normals (F, 3): ``cross(v1 − v0, v2 − v0)`` normalized."""
    fv = verts[_faces_on(faces, verts.device)]
    c = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=1)
    return _unit(c)


def compute_vertex_normals(verts: torch.Tensor, faces,
                           face_normals: torch.Tensor) -> torch.Tensor:
    """Angle-weighted vertex normals (V, 3)."""
    fidx = _faces_on(faces, verts.device)
    fv = verts[fidx]
    contributions = []
    for i in range(3):
        d0 = _unit(fv[:, (i + 1) % 3] - fv[:, i])
        d1 = _unit(fv[:, (i + 2) % 3] - fv[:, i])
        angle = safe_acos(torch.sum(d0 * d1, dim=1))
        contributions.append(face_normals * angle[:, None])
    ids = fidx.t().reshape(-1)                     # corner i -> faces[:, i]
    contrib = torch.cat(contributions, dim=0)
    normals = torch.zeros_like(verts).index_add(0, ids, contrib)
    return _unit(normals)
