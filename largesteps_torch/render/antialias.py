"""Edge adjacency for the antialias silhouette test.

Port of ``face_adjacency`` from ``largesteps_tpu/render/antialias.py``.  The
dense XLA antialias of that module belongs to the ``backend="xla"`` slice
(ROADMAP.md Queue 1); the main path antialiases in the CUDA kernels of
:mod:`largesteps_torch.render.kernels`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["face_adjacency"]


def face_adjacency(faces) -> np.ndarray:
    """For each face edge e = (f[e], f[(e+1)%3]), the index of the face
    sharing that undirected edge (the lowest other index), or −1 on a
    boundary.  Host, once per topology."""
    faces = np.asarray(faces)
    F = faces.shape[0]
    edge_map: dict = {}
    for fi in range(F):
        for e in range(3):
            a, b = int(faces[fi, e]), int(faces[fi, (e + 1) % 3])
            key = (a, b) if a < b else (b, a)
            edge_map.setdefault(key, []).append(fi)
    opp = np.full((F, 3), -1, dtype=np.int32)
    for fi in range(F):
        for e in range(3):
            a, b = int(faces[fi, e]), int(faces[fi, (e + 1) % 3])
            key = (a, b) if a < b else (b, a)
            for other in edge_map[key]:
                if other != fi:
                    opp[fi, e] = other
                    break
    return opp
