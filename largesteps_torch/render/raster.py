"""The dense differentiable rasterizer (nvdiffrast's ``rasterize`` and
``interpolate``), capacity-free.

Port of ``largesteps_tpu/render/raster.py``, the JAX package's
``backend="xla"`` path.  Per pixel ``(u, v, z/w, triangle_id + 1)`` with 0
for the background; (u, v) are the perspective-correct barycentric weights
of the triangle's first two corners.  Pixel (row i, column j) sits at NDC
x = 2(j+½)/W − 1, y = 2(i+½)/H − 1, row 0 at the image bottom.

* Forward: a z-buffer over chunks of ``chunk`` faces, all cameras at once,
  outside autograd.  Within a chunk the first nearest face wins (``min``
  over a dimension returns the first), across chunks only a strictly
  nearer one, so the
  lowest face id wins an exact tie, as in JAX.  The last chunk is short
  where JAX pads with degenerate faces of id 0; neither ever covers a pixel.
  Only depth and coverage are evaluated for every face; (u, v) are
  evaluated once, for the winner, by the same expressions.
* Backward: the closed form of (u, v) at each covered pixel, recomputed
  from its owner's clip coordinates and differentiated by autograd
  (``raster.py:172-203``), then added into (C, V, 4).  Only the u and v
  cotangents enter.

Triangles with a corner at w ≤ 1e-9 are discarded (no near-plane clipping).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.segment import segment_sum

__all__ = ["rasterize", "interpolate", "pixel_grid"]

BIG = 3.4e38


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32):
    """NDC coordinates of the pixel centres: (px, py), each (H, W).

    The divisor is a tensor on the device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which rounds otherwise than
    the CPU's (and JAX's) division where the size is not a power of two."""
    n = lambda k: torch.full((), float(k), dtype=dtype, device=device)
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) \
        / n(width) * 2.0 - 1.0
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) \
        / n(height) * 2.0 - 1.0
    return xs[None, :].expand(height, width), ys[:, None].expand(height, width)


def _edge(ax, ay, bx, by, px, py):
    """Signed edge function: cross(b − a, p − a)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _pixel_uv_depth(tri, px, py, need_uv=True, need_depth=True):
    """Barycentrics and depth of pixels against triangles.

    tri (..., 3, 4) clip coordinates, broadcast against px, py.  Returns
    (u, v, depth, covered); u, v (depth) are None without ``need_uv``
    (``need_depth``).  This closed form is both the forward's arithmetic and,
    under autograd, the analytic backward.
    """
    w = tri[..., 3]
    sx = tri[..., 0] / w
    sy = tri[..., 1] / w
    c = lambda a, k: a[..., k]
    area = _edge(c(sx, 0), c(sy, 0), c(sx, 1), c(sy, 1), c(sx, 2), c(sy, 2))
    e0 = _edge(c(sx, 1), c(sy, 1), c(sx, 2), c(sy, 2), px, py)  # opposite v0
    e1 = _edge(c(sx, 2), c(sy, 2), c(sx, 0), c(sy, 0), px, py)  # opposite v1
    small = torch.abs(area) < 1e-12
    safe_area = torch.where(small, 1.0, area)
    b0 = e0 / safe_area
    b1 = e1 / safe_area
    b2 = 1.0 - b0 - b1
    covered = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0) \
        & ~small & torch.all(w > 1e-9, dim=-1)
    u = v = depth = None
    if need_uv:
        q0, q1, q2 = b0 / c(w, 0), b1 / c(w, 1), b2 / c(w, 2)
        s = q0 + q1 + q2
        safe_s = torch.where(s == 0, 1.0, s)
        u = q0 / safe_s
        v = q1 / safe_s
    if need_depth:
        zw = tri[..., 2] / w
        depth = b0 * c(zw, 0) + b1 * c(zw, 1) + b2 * c(zw, 2)
    return u, v, depth, covered


@torch.no_grad()
def _zbuffer(v_clip, faces, height, width, chunk):
    """(depth, id) of the nearest face at every pixel: (C, H, W) each, id
    1-based and 0 on the background (depth BIG there)."""
    C = v_clip.shape[0]
    F = faces.shape[0]
    dev = v_clip.device
    px, py = pixel_grid(height, width, dev, v_clip.dtype)
    # a row and a column: the per-face terms of the edge functions stay
    # (C, K, 1, W) and (C, K, H, 1), and only their difference is a plane
    px, py = px[:1], py[:, :1]
    zbuf = torch.full((C, height, width), BIG, dtype=v_clip.dtype, device=dev)
    ids = torch.zeros((C, height, width), dtype=torch.int64, device=dev)
    for f0 in range(0, F, chunk):
        f1 = min(f0 + chunk, F)
        tri = v_clip[:, faces[f0:f1]][:, :, None, None]   # (C, K, 1, 1, 3, 4)
        _, _, depth, covered = _pixel_uv_depth(tri, px, py, need_uv=False)
        depth = torch.where(covered, depth, BIG)          # (C, K, H, W)
        d, best = depth.min(dim=1)                        # the first minimum
        del depth, covered
        closer = d < zbuf
        zbuf = torch.where(closer, d, zbuf)
        ids = torch.where(closer, best + (f0 + 1), ids)
    return zbuf, ids


def _owner_tri(v_clip, faces, ids):
    """Clip coordinates of each pixel's owning face: (C, H, W, 3, 4), the
    first face's at the background.  Also returns the corner ids (C, H, W,
    3)."""
    fidx = faces[torch.clamp(ids - 1, min=0)]              # (C, H, W, 3)
    cam = torch.arange(v_clip.shape[0], device=v_clip.device)
    return v_clip[cam[:, None, None, None], fidx], fidx


class _Rasterize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v_clip, faces, height, width, chunk):
        zbuf, ids = _zbuffer(v_clip, faces, height, width, chunk)
        tri, _ = _owner_tri(v_clip, faces, ids)
        px, py = pixel_grid(height, width, v_clip.device, v_clip.dtype)
        u, v, _, _ = _pixel_uv_depth(tri, px, py, need_depth=False)
        covered = ids > 0
        out = torch.stack([torch.where(covered, u, 0.0),
                           torch.where(covered, v, 0.0),
                           torch.where(covered, zbuf, 0.0),
                           ids.to(v_clip.dtype)], dim=-1)
        ctx.save_for_backward(v_clip, faces, ids)
        return out

    @staticmethod
    def backward(ctx, g):
        v_clip, faces, ids = ctx.saved_tensors
        C, V = v_clip.shape[:2]
        height, width = ids.shape[1:]
        covered = ids > 0
        # mask the cotangents first: an uncovered pixel's recompute may be
        # inf or NaN, and 0 · inf would leak NaN into the sums
        du = torch.where(covered, g[..., 0], 0.0)
        dv = torch.where(covered, g[..., 1], 0.0)
        tri, fidx = _owner_tri(v_clip.detach(), faces, ids)
        px, py = pixel_grid(height, width, v_clip.device, v_clip.dtype)
        with torch.enable_grad():
            tri = tri.requires_grad_(True)
            u, v, _, _ = _pixel_uv_depth(tri, px, py, need_depth=False)
            dt, = torch.autograd.grad((u, v), tri, (du, dv))
        dt = torch.where(covered[..., None, None], dt, 0.0)
        cam = torch.arange(C, device=v_clip.device)[:, None, None, None] * V
        # each vertex's pixels in pixel order (a fixed order on the card)
        dvc = segment_sum(dt.reshape(-1, 4), (fidx + cam).reshape(-1), C * V)
        return dvc.reshape(C, V, 4), None, None, None, None


def _faces_tensor(faces, device) -> torch.Tensor:
    """An index table (faces, adjacency) as int64 on ``device``."""
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(faces, np.int64), device=device)


def rasterize(v_clip, faces, resolution, chunk: int = 128):
    """Rasterize v_clip (C, V, 4) × faces (F, 3) → rast (C, H, W, 4).

    Channels (u, v, z/w, triangle_id + 1), the last 0 on the background.
    Differentiable with respect to ``v_clip`` through (u, v) only, as
    nvdiffrast's.  ``chunk`` faces are z-tested against the whole image at
    a time (memory C · chunk · H · W floats a plane).
    """
    height, width = resolution
    f = _faces_tensor(faces, v_clip.device)
    return _Rasterize.apply(v_clip, f, int(height), int(width), int(chunk))


def interpolate(attr, rast, faces):
    """Barycentric attribute interpolation (nvdiffrast ``interpolate``).

    attr (V, D) or (C, V, D); rast (C, H, W, 4); faces (F, 3).  Returns
    (C, H, W, D), zero on the background.  Differentiable with respect to
    ``attr`` and, through the (u, v) channels, to :func:`rasterize`'s
    positions; the face ids carry no gradient.
    """
    f = _faces_tensor(faces, rast.device)
    tri_id = rast[..., 3].detach().to(torch.int64)
    covered = tri_id > 0
    fidx = f[torch.clamp(tri_id - 1, min=0)]              # (C, H, W, 3)
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    if attr.ndim == 2:
        a = attr[fidx]                                    # (C, H, W, 3, D)
    else:
        cam = torch.arange(attr.shape[0], device=attr.device)
        a = attr[cam[:, None, None, None], fidx]
    out = u * a[..., 0, :] + v * a[..., 1, :] + (1.0 - u - v) * a[..., 2, :]
    return torch.where(covered[..., None], out, 0.0)
