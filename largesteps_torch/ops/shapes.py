"""Procedural test meshes (host-side numpy).

A copy of ``largesteps_tpu/ops/shapes.py``: importing that module would pull
in jax through ``largesteps_tpu/__init__.py``.

The reference repo ships no geometry (scenes are a separate download), so the
test suite, benchmarks and experiment configs synthesize meshes: icospheres
as optimization sources (the reference experiments all start from a sphere,
e.g. Tutorial.ipynb) and assorted closed target shapes standing in for
suzanne/bunny/nefertiti-class geometry.
"""
from __future__ import annotations

import numpy as np

__all__ = ["icosphere", "torus", "gourd", "supershape"]


def icosphere(subdiv: int = 3, radius: float = 1.0):
    """Geodesic sphere: icosahedron subdivided ``subdiv`` times.

    V = 10 * 4**subdiv + 2.  subdiv=4 → 2562 verts, 6 → 40962, 7 → 163842
    (Nefertiti-class ≥100k, SURVEY §6).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    for _ in range(subdiv):
        edges = {}
        new_faces = []
        verts = [v]
        n = v.shape[0]

        def midpoint(a, b):
            nonlocal n
            key = (min(a, b), max(a, b))
            if key not in edges:
                m = v[a] + v[b]
                m /= np.linalg.norm(m)
                verts.append(m[None])
                edges[key] = n
                n += 1
            return edges[key]

        for (a, b, c) in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.concatenate(verts, axis=0)
        f = np.array(new_faces, dtype=np.int64)

    return (radius * v).astype(np.float32), f.astype(np.int32)


def torus(n_major: int = 48, n_minor: int = 24, R: float = 1.0, r: float = 0.4):
    """Triangulated torus."""
    u = np.arange(n_major) * (2 * np.pi / n_major)
    w = np.arange(n_minor) * (2 * np.pi / n_minor)
    uu, ww = np.meshgrid(u, w, indexing="ij")
    x = (R + r * np.cos(ww)) * np.cos(uu)
    y = r * np.sin(ww)
    z = (R + r * np.cos(ww)) * np.sin(uu)
    v = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = ((i + 1) % n_major) * n_minor + j
            c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            d = i * n_minor + (j + 1) % n_minor
            faces += [[a, b, c], [a, c, d]]
    return v.astype(np.float32), np.array(faces, dtype=np.int32)


def gourd(subdiv: int = 4, seed: int = 0):
    """A smooth asymmetric blob (sphere displaced by low-frequency bumps) —
    a stand-in for organic targets like suzanne/bunny in tests/benchmarks."""
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amps = rng.uniform(0.15, 0.35, size=6)
    widths = rng.uniform(2.0, 5.0, size=6)
    r = np.ones(v.shape[0])
    for c, a, wdt in zip(centers, amps, widths):
        r += a * np.exp(wdt * (v @ c - 1.0))
    v = v * r[:, None]
    v[:, 1] *= 1.2
    return v.astype(np.float32), f


def supershape(subdiv: int = 4, m: float = 5.0, n1: float = 0.3, n2: float = 0.3, n3: float = 0.3):
    """Superformula-displaced sphere: sharp-featured closed target."""
    v, f = icosphere(subdiv)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    phi = np.arctan2(z, x)

    def sf(ang):
        a = np.abs(np.cos(m * ang / 4.0)) ** n2
        b = np.abs(np.sin(m * ang / 4.0)) ** n3
        return (a + b) ** (-1.0 / n1)

    r = 0.6 + 0.4 * sf(phi) / np.max(sf(np.linspace(0, 2 * np.pi, 512)))
    return (v * r[:, None]).astype(np.float32), f
