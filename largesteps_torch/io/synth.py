"""Synthetic scene construction (host numpy).

Port of ``largesteps_tpu/io/synth.py`` (``make_envmap``,
``turntable_views``, ``make_scene``, ``save_scene``): turntable cameras
around the origin, a procedural HDR envmap, and procedural source and
target meshes; a scene can be written to disk (XML, PLY, HDR) for
:func:`largesteps_torch.io.xml_scene.load_scene`.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import shapes
from ..render.camera import rotation_matrix, translation_matrix
from .hdr import write_hdr
from .ply import write_ply

__all__ = ["make_envmap", "turntable_views", "make_scene", "save_scene"]


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


def save_scene(params, directory, name="scene"):
    """Persist a scene dict as XML + PLY + HDR, loadable by load_scene."""
    os.makedirs(directory, exist_ok=True)
    write_ply(os.path.join(directory, "source.ply"),
              params["mesh-source"]["vertices"], params["mesh-source"]["faces"])
    write_ply(os.path.join(directory, "target.ply"),
              params["mesh-target"]["vertices"], params["mesh-target"]["faces"])
    write_hdr(os.path.join(directory, "envmap.hdr"), params["envmap"][..., :3])

    sensors = []
    n = len(params["view_mats"])
    # Round-trip caveat: we re-emit the turntable parameters rather than the
    # raw matrices; only scenes built by make_scene are exactly reproduced.
    for k in range(n):
        angle = 360.0 * k / max(n, 1)
        sensors.append(f"""
  <sensor type="perspective">
    <float name="fov" value="{params['fov']}"/>
    <float name="near_clip" value="{params['near_clip']}"/>
    <float name="far_clip" value="{params['far_clip']}"/>
    <transform name="to_world">
      <translate value="0 0 -3.5"/>
      <rotate x="1" angle="-15.0"/>
      <rotate y="1" angle="{angle}"/>
    </transform>
  </sensor>""")

    xml = f"""<scene version="2.0.0">
  <default name="resx" value="{params['res_x']}"/>
  <default name="resy" value="{params['res_y']}"/>
{''.join(sensors)}
  <emitter type="envmap">
    <string name="filename" value="envmap.hdr"/>
    <float name="scale" value="{params['envmap_scale']}"/>
  </emitter>
  <shape type="ply" id="mesh-source">
    <string name="filename" value="source.ply"/>
  </shape>
  <shape type="ply" id="mesh-target">
    <string name="filename" value="target.ply"/>
  </shape>
</scene>
"""
    path = os.path.join(directory, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write(xml)
    return path
