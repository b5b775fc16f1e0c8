"""Synthetic scene construction (host numpy).

Port of ``largesteps_tpu/io/synth.py`` (``make_envmap``,
``turntable_views``, ``make_scene``): turntable cameras around the origin, a
procedural HDR envmap, and procedural source and target meshes.  Writing a
scene to disk (XML, PLY, HDR) is queued with the io slice in ROADMAP.md.
"""
from __future__ import annotations

import numpy as np

from ..ops import shapes
from ..render.camera import rotation_matrix, translation_matrix

__all__ = ["make_envmap", "turntable_views", "make_scene"]


def make_envmap(h: int = 64, w: int = 128, seed: int = 0) -> np.ndarray:
    """Smooth HDR environment (H, W, 4 with alpha = 1): a sky-like
    gradient plus a bright 'sun' lobe in a direction drawn from ``seed``."""
    theta = np.linspace(0, np.pi, h)[:, None] * np.ones((1, w))
    phi = np.ones((h, 1)) * np.linspace(0, 2 * np.pi, w)[None, :]
    rng = np.random.default_rng(seed)
    sky = np.stack(
        [
            0.4 + 0.4 * np.cos(theta),
            0.5 + 0.3 * np.cos(theta),
            0.7 + 0.3 * np.cos(theta) * 0.5,
        ],
        axis=-1,
    )
    sun_dir = rng.normal(size=3)
    sun_dir /= np.linalg.norm(sun_dir)
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta),
         -np.sin(theta) * np.sin(phi)],
        axis=-1,
    )
    sun = 8.0 * np.exp(24.0 * (d @ sun_dir - 1.0))[..., None]
    env = (sky + sun * np.array([1.0, 0.9, 0.7])).astype(np.float32)
    return np.concatenate([env, np.ones((h, w, 1), np.float32)], axis=-1)


def turntable_views(n_views: int, distance: float = 3.5,
                    elevation: float = 15.0):
    """Inverted view matrices for n cameras orbiting the y axis
    (rotate-then-translate sensor transforms)."""
    views = []
    for k in range(n_views):
        angle = 360.0 * k / max(n_views, 1)
        cam_to_world = (
            rotation_matrix("y", angle)
            @ rotation_matrix("x", -elevation)
            @ translation_matrix([0.0, 0.0, -distance])
        )
        views.append(np.linalg.inv(cam_to_world).astype(np.float32))
    return views


def make_scene(source=("icosphere", 3), target=("gourd", 4),
               n_views: int = 13, res: int = 128, fov: float = 45.0,
               distance: float = 3.5, envmap_hw=(64, 128), seed: int = 0):
    """An in-memory scene params dict (the schema of the JAX package's
    ``load_scene``)."""

    def build(spec):
        name, arg = spec
        v, f = getattr(shapes, name)(arg)
        return {"vertices": v.astype(np.float32), "faces": f.astype(np.int32)}

    return {
        "res_x": res,
        "res_y": res,
        "fov": fov,
        "near_clip": 0.1,
        "far_clip": 100.0,
        "view_mats": turntable_views(n_views, distance=distance),
        "envmap": make_envmap(*envmap_hw, seed=seed),
        "envmap_scale": 1.0,
        "mesh-source": build(source),
        "mesh-target": build(target),
    }
