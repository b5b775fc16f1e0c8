"""The benchmark's scenes, made from a seed (host numpy).

A frozen copy of the port's scene generator (``largesteps_torch.io.synth``
``make_scene``, ``turntable_views``, ``make_envmap`` and the icosphere and
gourd builders of ``largesteps_torch.ops.shapes``), so that no change to
the program changes the yardstick's inputs.  At ``azimuth=0`` it gives the
port's scenes byte for byte (``tests/test_perfbench_harness.py``); the
icosphere's subdivision is vectorized, with the same vertex order and the
same float64 arithmetic as the loop it replaces.

:func:`scene_for` is what a run uses: the configuration's scene spec, the
workload's view count, the environment map drawn from ``--seed`` and the
camera ring turned by an azimuth drawn from it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["icosphere", "gourd", "make_envmap", "turntable_views",
           "make_scene", "scene_for"]


def icosphere(subdiv: int = 3, radius: float = 1.0):
    """Geodesic sphere: the icosahedron subdivided ``subdiv`` times, each
    edge's midpoint numbered in the order its faces first meet it."""
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
        n = v.shape[0]
        # the edges (a, b), (b, c), (c, a) of each face, in call order
        a = f[:, [0, 1, 2]].reshape(-1)
        b = f[:, [1, 2, 0]].reshape(-1)
        key = np.minimum(a, b) * n + np.maximum(a, b)
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")    # first-seen order
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        mid = n + rank[inv.reshape(-1)]
        ea, eb = a[first[order]], b[first[order]]
        m = v[ea] + v[eb]
        # the loop's np.linalg.norm of one 3-vector: sqrt(x·x)
        m /= np.sqrt(np.einsum("ij,ij->i", m, m))[:, None]
        v = np.concatenate([v, m], axis=0)
        ab, bc, ca = (mid.reshape(-1, 3)[:, k] for k in range(3))
        fa, fb, fc = f[:, 0], f[:, 1], f[:, 2]
        f = np.stack([np.stack([fa, ab, ca], 1), np.stack([fb, bc, ab], 1),
                      np.stack([fc, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     axis=1).reshape(-1, 3)
    return (radius * v).astype(np.float32), f.astype(np.int32)


def gourd(subdiv: int = 4, seed: int = 0):
    """A smooth asymmetric blob: the sphere displaced by six low-frequency
    bumps drawn from ``seed``, stretched 1.2× in y."""
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


SHAPES = {"icosphere": icosphere, "gourd": gourd}


def make_envmap(h: int = 64, w: int = 128, seed: int = 0) -> np.ndarray:
    """Smooth HDR environment (H, W, 4 with alpha = 1): a sky-like
    gradient plus a bright 'sun' lobe in a direction drawn from ``seed``."""
    theta = np.linspace(0, np.pi, h)[:, None] * np.ones((1, w))
    phi = np.ones((h, 1)) * np.linspace(0, 2 * np.pi, w)[None, :]
    rng = np.random.default_rng(seed)
    sky = np.stack([0.4 + 0.4 * np.cos(theta), 0.5 + 0.3 * np.cos(theta),
                    0.7 + 0.3 * np.cos(theta) * 0.5], axis=-1)
    sun_dir = rng.normal(size=3)
    sun_dir /= np.linalg.norm(sun_dir)
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  -np.sin(theta) * np.sin(phi)], axis=-1)
    sun = 8.0 * np.exp(24.0 * (d @ sun_dir - 1.0))[..., None]
    env = (sky + sun * np.array([1.0, 0.9, 0.7])).astype(np.float32)
    return np.concatenate([env, np.ones((h, w, 1), np.float32)], axis=-1)


def _rotation(axis: str, angle_deg: float) -> np.ndarray:
    mat = np.eye(4, dtype=np.float64)
    theta = np.deg2rad(angle_deg)
    idx = "xyz".find(axis)
    i1, i2 = (idx + 1) % 3, (idx + 2) % 3
    mat[i1, i1] = np.cos(theta)
    mat[i2, i2] = np.cos(theta)
    mat[i1, i2] = -np.sin(theta)
    mat[i2, i1] = np.sin(theta)
    return mat


def _translation(tr) -> np.ndarray:
    mat = np.eye(4, dtype=np.float64)
    mat[:3, 3] = np.asarray(tr, dtype=np.float64)
    return mat


def turntable_views(n_views: int, distance: float = 3.5,
                    elevation: float = 15.0, azimuth: float = 0.0):
    """Inverted view matrices of ``n_views`` cameras orbiting the y axis,
    the first at ``azimuth`` degrees."""
    views = []
    for k in range(n_views):
        angle = 360.0 * k / max(n_views, 1)
        if azimuth:
            angle += azimuth
        cam_to_world = (_rotation("y", angle) @ _rotation("x", -elevation)
                        @ _translation([0.0, 0.0, -distance]))
        views.append(np.linalg.inv(cam_to_world).astype(np.float32))
    return views


def make_scene(source=("icosphere", 3), target=("gourd", 4),
               n_views: int = 13, res: int = 128, fov: float = 45.0,
               distance: float = 3.5, envmap_hw=(64, 128), seed: int = 0,
               azimuth: float = 0.0):
    """A scene dict of the port's schema (``optimize_shape``'s input)."""

    def build(spec):
        name, arg = spec
        v, f = SHAPES[name](arg)
        return {"vertices": v.astype(np.float32), "faces": f.astype(np.int32)}

    return {
        "res_x": res, "res_y": res, "fov": fov,
        "near_clip": 0.1, "far_clip": 100.0,
        "view_mats": turntable_views(n_views, distance=distance,
                                     azimuth=azimuth),
        "envmap": make_envmap(*envmap_hw, seed=seed),
        "envmap_scale": 1.0,
        "mesh-source": build(source),
        "mesh-target": build(target),
    }


def scene_for(spec: dict, n_views: int, seed: int) -> dict:
    """The run's scene: ``spec`` (``source``, ``target``, ``res``) with
    ``n_views`` cameras, the environment map's sun drawn from ``seed`` and
    the ring turned by an azimuth in [0, 360 / n_views) drawn from it.
    Every seed gives the same meshes, sizes and views."""
    rng = np.random.default_rng([int(seed), 7])
    return make_scene(source=tuple(spec["source"]),
                      target=tuple(spec["target"]), n_views=int(n_views),
                      res=int(spec["res"]), seed=int(seed) % 2 ** 63,
                      azimuth=float(rng.uniform(0.0, 360.0 / n_views)))
