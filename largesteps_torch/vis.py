"""Mesh pictures for the figures, drawn by the port's own renderer.

Port of ``largesteps_tpu/vis.py``: one shaded view of a mesh with SH
lighting from the synthetic environment map, an optional wireframe and an
optional highlight of chosen faces, saved as a PNG through matplotlib.  The
view renders through :class:`largesteps_torch.render.renderer.Renderer`,
whose ``"auto"`` backend takes the tile kernels where the resolution tiles
into 32×128 pixels (384², 512²) and the dense renderer elsewhere (320²), as
JAX's ``"auto"`` does.  The wireframe and the highlight read the face ids
of the dense :func:`largesteps_torch.render.raster.rasterize`.

Unlike JAX's, :func:`render_mesh_image` sizes the tile bins to the mesh
(``Renderer.check_overflow``) before it renders: at the renderer's default
cap of 768 a tile of a larger mesh drops faces.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .io.synth import make_envmap, turntable_views
from .ops.normals import compute_face_normals, compute_vertex_normals
from .render.camera import project, rotation_matrix, translation_matrix
from .render.raster import rasterize
from .render.renderer import Renderer, Topology

__all__ = ["render_panel", "render_mesh_image", "save_mesh_png",
           "self_intersections"]


def _view(angle_deg: float, distance: float) -> np.ndarray:
    """The panel's one view matrix (``vis.py:34-39``)."""
    if angle_deg == 0.0:
        return turntable_views(12, distance=distance)[0]
    return np.linalg.inv(
        rotation_matrix("y", angle_deg) @ rotation_matrix("x", -15.0)
        @ translation_matrix([0, 0, -distance])).astype(np.float32)


@torch.no_grad()
def render_panel(v, f, res: int = 512, angle_deg: float = 30.0,
                 distance: float = 3.5, wireframe: bool = False,
                 highlight_faces=None, device=None):
    """:func:`render_mesh_image`'s image with what it drew: (image, the
    wireframe's pixels or None, the highlight's pixels or None, the
    renderer), the masks (res, res) bool in the image's row order.  The
    renderer is the panel's one-view shaded :class:`Renderer` on
    ``device``, its bins sized to the mesh."""
    dev = resolve_device(device)
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int32)
    scene = {
        "res_x": res, "res_y": res, "fov": 45.0, "near_clip": 0.1,
        "far_clip": 100.0, "view_mats": [_view(angle_deg, distance)],
        "envmap": make_envmap(64, 128), "envmap_scale": 1.0,
    }
    renderer = Renderer(scene, shading=True, device=dev)
    topo = Topology(f)
    vt = torch.as_tensor(v, device=dev)
    renderer.check_overflow(vt, topo)
    n = compute_vertex_normals(vt, topo.faces,
                               compute_face_normals(vt, topo.faces))
    img = renderer.render(vt, n, topo)[0, ..., :3].cpu().numpy()
    edge = mask = None
    if wireframe or highlight_faces is not None:
        faces, _ = topo.dense_tables(dev)
        rast = rasterize(project(vt, renderer.mvps), faces, (res, res),
                         256)[0].cpu().numpy()
        ids = rast[..., 3].astype(np.int32)
        if wireframe:
            # pixels whose least barycentric is small: near an edge
            u, vv = rast[..., 0], rast[..., 1]
            w2 = 1 - u - vv
            edge = (ids > 0) & (np.minimum(np.minimum(u, vv), w2) < 0.03)
            img = np.where(edge[..., None], img * 0.25, img)
            edge = edge[::-1]
        if highlight_faces is not None:
            mask = np.isin(ids - 1, np.asarray(highlight_faces)) & (ids > 0)
            img = np.where(mask[..., None], np.array([1.0, 0.1, 0.1]), img)
            mask = mask[::-1]
    # flip: row 0 of the raster is the bottom
    return np.clip(img[::-1], 0.0, None), edge, mask, renderer


def render_mesh_image(v, f, res: int = 512, angle_deg: float = 30.0,
                      distance: float = 3.5, wireframe: bool = False,
                      highlight_faces=None, device=None) -> np.ndarray:
    """One shaded view of a mesh on ``device`` (the card unless the caller
    asks for the CPU) → (res, res, 3) float numpy image, row 0 at the top.
    ``wireframe`` darkens the pixels near an edge; ``highlight_faces``
    paints those faces' pixels red."""
    return render_panel(v, f, res, angle_deg, distance, wireframe,
                        highlight_faces, device)[0]


def save_mesh_png(path, v, f, **kw):
    """``render_mesh_image`` scaled by its 99.5th percentile into a 6-inch
    PNG at 120 dpi (``vis.py:76-89``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = render_mesh_image(v, f, **kw)
    img = img / max(np.percentile(img, 99.5), 1e-6)
    plt.figure(figsize=(6, 6))
    plt.imshow(np.clip(img, 0, 1))
    plt.axis("off")
    plt.tight_layout(pad=0)
    plt.savefig(path, dpi=120)
    plt.close()
    return path


def self_intersections(v, f, max_pairs: int = 200000):
    """Face indices involved in self-intersections: a bounding-box sweep
    along x, then an exact triangle-triangle test on each pair that shares
    no vertex, on the host; at most ``max_pairs`` pairs are tested."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    tri = v[f]
    lo = tri.min(axis=1)
    hi = tri.max(axis=1)
    order = np.argsort(lo[:, 0], kind="stable")
    hits = set()
    n = len(f)
    checked = 0
    for oi in range(n):
        i = order[oi]
        for oj in range(oi + 1, n):
            j = order[oj]
            if lo[j, 0] > hi[i, 0]:
                break
            if (lo[j] > hi[i]).any() or (lo[i] > hi[j]).any():
                continue
            if len(np.intersect1d(f[i], f[j])) > 0:
                continue  # sharing a vertex: not a self-intersection
            checked += 1
            if checked > max_pairs:
                return sorted(hits)
            if _tri_tri_intersect(tri[i], tri[j]):
                hits.add(int(i))
                hits.add(int(j))
    return sorted(hits)


def _tri_tri_intersect(t1, t2):
    """Möller's interval test (separating-plane based, conservative)."""
    def plane(t):
        n = np.cross(t[1] - t[0], t[2] - t[0])
        return n, -n.dot(t[0])

    n1, d1 = plane(t1)
    s2 = t2 @ n1 + d1
    if (s2 > 1e-12).all() or (s2 < -1e-12).all():
        return False
    n2, d2 = plane(t2)
    s1 = t1 @ n2 + d2
    if (s1 > 1e-12).all() or (s1 < -1e-12).all():
        return False
    # project onto the intersection line and compare the intervals
    d = np.cross(n1, n2)
    axis = np.argmax(np.abs(d))

    def interval(t, s):
        p = t[:, axis]
        pts = []
        for a in range(3):
            b = (a + 1) % 3
            if s[a] * s[b] < 0:
                alpha = s[a] / (s[a] - s[b])
                pts.append(p[a] + alpha * (p[b] - p[a]))
            elif abs(s[a]) <= 1e-12:
                pts.append(p[a])
        if not pts:
            return None
        return min(pts), max(pts)

    i1 = interval(t1, s1)
    i2 = interval(t2, s2)
    if i1 is None or i2 is None:
        return False
    return not (i1[1] < i2[0] or i2[1] < i1[0])
