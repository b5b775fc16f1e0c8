"""Mesh Laplacian and the large-steps system matrix ``M = I + λL``.

Port of ``largesteps_tpu/core/geometry.py`` (uniform Laplacian only; the
cotangent Laplacian is queued in ROADMAP.md).  The structure is built on the
host once per topology epoch; the values live on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .sparse import CooStructure, SparseCOO

__all__ = ["adjacency_edges", "laplacian_uniform", "compute_matrix"]


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


def compute_matrix(verts, faces, lambda_: float | None = None,
                   alpha: float | None = None, device=None) -> SparseCOO:
    """``M = I + λL`` (λ form) or ``(1-α)I + αL`` (α form, 0 <= α < 1)."""
    n_verts = int(verts.shape[0])
    if device is None and isinstance(verts, torch.Tensor):
        device = verts.device
    L = laplacian_uniform(n_verts, faces, device=device)
    if alpha is None:
        if lambda_ is None:
            raise ValueError("one of lambda_ / alpha must be given")
        return L.add_scaled_identity(1.0, self_scale=float(lambda_))
    if alpha < 0.0 or alpha >= 1.0:
        raise ValueError(f"alpha={alpha} out of range: need 0 <= alpha < 1")
    return L.add_scaled_identity(1.0 - alpha, self_scale=float(alpha))
