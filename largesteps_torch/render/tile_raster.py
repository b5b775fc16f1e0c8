"""The modular tile rasterizer: nvdiffrast's ``rasterize`` on the CUDA tile
kernels, without the fused interpolate and antialias.

Port of ``largesteps_tpu/render/pallas_raster.py``: the same per-pixel
``(u, v, z/w, triangle_id + 1)`` as :func:`largesteps_torch.render.raster.
rasterize`, through the traced binning (:func:`setup_and_bin`), the
``raster_fwd`` kernel, and for the gradient the ``raster_bwd`` kernel, the
chain to clip space and the scatter to vertices of
:mod:`largesteps_torch.render.pipeline`.  For benchmarks, tests and callers
that want rasterization alone.  The resolution must tile into 32×128
pixels.  JAX's ``chunk`` argument sizes the TPU kernel's slot blocks and
has no counterpart here.
"""
from __future__ import annotations

import torch

from . import kernels
from .pipeline import (bin_triangles, build_incidence, chain_planes,
                       check_bin_overflow, scatter_via_faces, setup_and_bin,
                       suggest_cap)
from .raster import _faces_tensor

__all__ = ["rasterize_tiles", "rasterize_tiles_fwd", "bin_triangles",
           "check_bin_overflow", "suggest_cap"]


def _forward(v_clip, faces, resolution, cap):
    """Setup, bins and raster_fwd: (rast (C, H, W, 4), rbb, bins, counts,
    slot)."""
    height, width = resolution
    V = v_clip.shape[1]
    attrs = v_clip.new_zeros((V, 3))
    opp = torch.zeros_like(faces)
    rfb, rbb, bins, counts = setup_and_bin(v_clip, faces, attrs, opp,
                                           height, width, cap)
    u, v, z, fid, slot, _, _, _ = kernels.raster_fwd(rfb, counts,
                                                     tuple(resolution))
    return torch.stack([u, v, z, fid], dim=-1), rbb, bins, counts, slot


@torch.no_grad()
def rasterize_tiles_fwd(v_clip, faces, resolution, cap: int = 768):
    """Forward-only rasterize: v_clip (C, V, 4) × faces (F, 3) → rast
    (C, H, W, 4) with channels (u, v, z/w, triangle_id + 1).  ``cap`` slots
    a tile; a bin past it under-draws its tile (size it with
    :func:`check_bin_overflow` and :func:`suggest_cap`)."""
    f = _faces_tensor(faces, v_clip.device)
    return _forward(v_clip, f, tuple(resolution), int(cap))[0]


class _RasterizeTiles(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v_clip, faces, resolution, cap):
        rast, rbb, bins, counts, slot = _forward(v_clip, faces, resolution,
                                                 cap)
        ctx.resolution = resolution
        ctx.n_verts = v_clip.shape[1]
        ctx.save_for_backward(faces, rbb, bins, counts, slot)
        return rast

    @staticmethod
    def backward(ctx, g):
        faces, rbb, bins, counts, slot = ctx.saved_tensors
        zero_col = g.new_zeros((*slot.shape, 3))
        dslot = kernels.raster_bwd(rbb, counts, slot, zero_col,
                                   g[..., 0].contiguous(),
                                   g[..., 1].contiguous(), ctx.resolution)
        table18 = chain_planes(dslot, None, 0.0, rbb)
        idx, mask = build_incidence(faces.cpu().numpy(), ctx.n_verts)
        incidence = (torch.as_tensor(idx, device=g.device),
                     torch.as_tensor(mask, dtype=torch.float32,
                                     device=g.device))
        dv_clip, _ = scatter_via_faces(table18, bins, incidence,
                                       faces.shape[0], ctx.n_verts)
        return dv_clip, None, None, None


def rasterize_tiles(v_clip, faces, resolution, cap: int = 768):
    """Differentiable rasterize on the tile kernels: as
    :func:`rasterize_tiles_fwd`, with the gradient with respect to
    ``v_clip`` through the (u, v) channels (``raster_bwd``)."""
    f = _faces_tensor(faces, v_clip.device)
    return _RasterizeTiles.apply(v_clip, f, tuple(resolution), int(cap))
