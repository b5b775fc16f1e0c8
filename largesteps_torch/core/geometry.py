"""Mesh Laplacian and the large-steps system matrix ``M = I + λL``.

Port of ``largesteps_tpu/core/geometry.py``: the uniform and the cotangent
Laplacian.  The structure is built on the host once per topology epoch; the
values live on ``device``.  The cotangent Laplacian's values are a
differentiable function of the vertices (autograd reaches ``verts``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.segment import Segments
from .sparse import CooStructure, SparseCOO

__all__ = ["adjacency_edges", "laplacian_uniform", "laplacian_cot",
           "compute_matrix"]


def adjacency_edges(faces):
    """Unique directed adjacency (i, j) pairs of a triangle mesh (host)."""
    faces = np.asarray(faces)
    ii = faces[:, [1, 2, 0]].reshape(-1)
    jj = faces[:, [2, 0, 1]].reshape(-1)
    directed = np.stack(
        [np.concatenate([ii, jj]), np.concatenate([jj, ii])], axis=0)
    directed = np.unique(directed, axis=1)
    return directed[0], directed[1]


def laplacian_uniform(n_verts: int, faces, device=None,
                      dtype=torch.float32) -> SparseCOO:
    """Combinatorial graph Laplacian L = D - A: -1 per unique undirected
    edge (both directions), vertex degree on the diagonal."""
    device = resolve_device(device)
    src, dst = adjacency_edges(faces)
    deg = np.bincount(src, minlength=n_verts).astype(np.float64)
    diag = np.arange(n_verts, dtype=np.int64)
    rows = np.concatenate([src, diag])
    cols = np.concatenate([dst, diag])
    vals = np.concatenate([-np.ones_like(src, dtype=np.float64), deg])
    st = CooStructure(rows, cols, (n_verts, n_verts))
    return SparseCOO(st, st.coalesce_values(
        torch.as_tensor(vals, dtype=dtype, device=device)))


def _cot_structure(n_verts: int, faces):
    """The cotangent Laplacian's COO pattern (host): 6F off-diagonal entries
    (both directions of each face's three edges), then the V diagonal
    entries."""
    faces = np.asarray(faces)
    ii = faces[:, [1, 2, 0]].reshape(-1)
    jj = faces[:, [2, 0, 1]].reshape(-1)
    diag = np.arange(n_verts, dtype=np.int64)
    rows = np.concatenate([ii, jj, diag])
    cols = np.concatenate([jj, ii, diag])
    return CooStructure(rows, cols, (n_verts, n_verts))


def laplacian_cot(verts: torch.Tensor, faces) -> SparseCOO:
    """Cotangent Laplacian on ``verts``' device, differentiable in
    ``verts``: Heron areas clamped at 1e-12, the weight of the edge opposite
    each corner ``(b² + c² − a²) / area / 4``, symmetrized, the diagonal the
    column sums, ``L = D − W``."""
    faces = np.asarray(faces)
    n_verts = int(verts.shape[0])
    fv = verts[torch.as_tensor(faces.astype(np.int64), device=verts.device)]
    v0, v1, v2 = fv[:, 0], fv[:, 1], fv[:, 2]
    A = torch.linalg.vector_norm(v1 - v2, dim=1)      # opposite v0
    B = torch.linalg.vector_norm(v0 - v2, dim=1)      # opposite v1
    C = torch.linalg.vector_norm(v0 - v1, dim=1)      # opposite v2
    s = 0.5 * (A + B + C)
    area = torch.sqrt(torch.clamp(s * (s - A) * (s - B) * (s - C),
                                  min=1e-12))
    A2, B2, C2 = A * A, B * B, C * C
    cota = (B2 + C2 - A2) / area / 4.0
    cotb = (A2 + C2 - B2) / area / 4.0
    cotc = (A2 + B2 - C2) / area / 4.0
    w = torch.stack([cota, cotb, cotc], dim=1).reshape(-1)   # per corner
    st = _cot_structure(n_verts, faces)
    # raw entries in _cot_structure's order: w (ii → jj), w (jj → ii), then
    # the diagonal: the column sums of W
    ii = faces[:, [1, 2, 0]].reshape(-1)
    jj = faces[:, [2, 0, 1]].reshape(-1)
    ww = torch.cat([w, w])
    colsum = Segments(np.concatenate([jj, ii]), n_verts, w.device).sum(ww)
    return SparseCOO(st, st.coalesce_values(torch.cat([-ww, colsum])))


def compute_matrix(verts, faces, lambda_: float | None = None,
                   alpha: float | None = None, cotan: bool = False,
                   device=None) -> SparseCOO:
    """``M = I + λL`` (λ form) or ``(1-α)I + αL`` (α form, 0 <= α < 1), L
    uniform or (``cotan``) cotangent; the cotangent form is differentiable
    in ``verts`` when they are a tensor that requires grad."""
    n_verts = int(verts.shape[0])
    if device is None and isinstance(verts, torch.Tensor):
        device = verts.device
    if cotan:
        if not isinstance(verts, torch.Tensor):
            verts = torch.as_tensor(np.asarray(verts, np.float32),
                                    device=resolve_device(device))
        L = laplacian_cot(verts, faces)
    else:
        L = laplacian_uniform(n_verts, faces, device=device)
    if alpha is None:
        if lambda_ is None:
            raise ValueError("one of lambda_ / alpha must be given")
        return L.add_scaled_identity(1.0, self_scale=float(lambda_))
    if alpha < 0.0 or alpha >= 1.0:
        raise ValueError(f"alpha={alpha} out of range: need 0 <= alpha < 1")
    return L.add_scaled_identity(1.0 - alpha, self_scale=float(alpha))
