"""The modular tile rasterizer: nvdiffrast's ``rasterize`` on the CUDA tile
kernels, without the fused antialias.

Port of ``largesteps_tpu/render/pallas_raster.py`` and of
``pallas_core.py:make_render_core`` / ``render_core``.

* :func:`make_render_core` builds the unfused rasterize + interpolate op of
  one topology: the traced binning (:func:`setup_and_bin`) and the
  ``raster_fwd`` kernel give ``(rast (C, H, W, 4), slot, color
  (C, H, W, 3))``; its backward is the ``raster_bwd`` kernel with the
  colour and (u, v) cotangents, the chain to clip space and the scatter to
  vertices of :mod:`largesteps_torch.render.pipeline`, giving the
  gradients of ``v_clip`` and of the attributes (JAX's ``core_bwd``).  The
  vertex incidence is built once per op and vertex count.
* :func:`rasterize_tiles` is the same per-pixel ``(u, v, z/w,
  triangle_id + 1)`` as :func:`largesteps_torch.render.raster.rasterize`,
  differentiable through (u, v): a render core without attributes, kept
  per faces object while the caller holds it.

For benchmarks, tests and callers that want rasterization alone.  The
resolution must tile into 32×128 pixels.  JAX's ``chunk`` argument sizes
the TPU kernel's slot blocks and has no counterpart here.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import kernels
from .pipeline import (bin_triangles, build_incidence, chain_planes,
                       check_bin_overflow, scatter_via_faces, setup_and_bin,
                       suggest_cap)

__all__ = ["make_render_core", "render_core",
           "rasterize_tiles", "rasterize_tiles_fwd", "bin_triangles",
           "check_bin_overflow", "suggest_cap"]


class _RenderCore:
    """The op :func:`make_render_core` returns; the device tables and the
    vertex incidence are made once per device."""

    def __init__(self, faces, opp, resolution, cap: int = 768):
        self.faces = np.ascontiguousarray(np.asarray(faces), np.int64)
        self.opp = np.ascontiguousarray(np.asarray(opp), np.int64)
        self.resolution = tuple(int(r) for r in resolution)
        self.cap = int(cap)
        self._tables = {}       # device -> (faces, opp)
        self._incidence = {}    # (device, n_verts) -> (idx, mask)

    def tables(self, device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (torch.as_tensor(self.faces, device=device),
                                 torch.as_tensor(self.opp, device=device))
        return self._tables[key]

    def incidence(self, n_verts: int, device):
        key = (str(device), int(n_verts))
        if key not in self._incidence:
            idx, mask = build_incidence(self.faces, n_verts)
            self._incidence[key] = (
                torch.as_tensor(idx, device=device),
                torch.as_tensor(mask, dtype=torch.float32, device=device))
        return self._incidence[key]

    def forward(self, v_clip, attrs):
        """The forward alone, outside autograd: (rast, slot, color, rbb,
        bins, counts)."""
        faces, opp = self.tables(v_clip.device)
        height, width = self.resolution
        rfb, rbb, bins, counts = setup_and_bin(v_clip, faces, attrs, opp,
                                               height, width, self.cap)
        u, v, z, fid, slot, c0, c1, c2 = kernels.raster_fwd(
            rfb, counts, self.resolution)
        return (torch.stack([u, v, z, fid], dim=-1), slot,
                torch.stack([c0, c1, c2], dim=-1), rbb, bins, counts)

    def __call__(self, v_clip, attrs):
        return _RenderCoreFn.apply(v_clip, attrs, self)


class _RenderCoreFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v_clip, attrs, core):
        rast, slot, color, rbb, bins, counts = core.forward(v_clip, attrs)
        ctx.core = core
        ctx.n_verts = v_clip.shape[1]
        ctx.save_for_backward(rbb, bins, counts, slot)
        ctx.mark_non_differentiable(slot)
        return rast, slot, color

    @staticmethod
    def backward(ctx, g_rast, _g_slot, g_color):
        rbb, bins, counts, slot = ctx.saved_tensors
        core = ctx.core
        if g_rast is None:
            g_rast = rbb.new_zeros((*slot.shape, 4))
        if g_color is None:
            g_color = rbb.new_zeros((*slot.shape, 3))
        dslot = kernels.raster_bwd(rbb, counts, slot, g_color.contiguous(),
                                   g_rast[..., 0].contiguous(),
                                   g_rast[..., 1].contiguous(),
                                   core.resolution)
        table18 = chain_planes(dslot, None, 0.0, rbb)
        dv_clip, d_attrs = scatter_via_faces(
            table18, bins, core.incidence(ctx.n_verts, rbb.device),
            core.faces.shape[0], ctx.n_verts)
        return dv_clip, d_attrs, None


def make_render_core(faces, opp, resolution, cap: int = 768):
    """The differentiable rasterize + interpolate op of one topology epoch:
    ``core(v_clip (C, V, 4), attrs (V, 3)) -> (rast (C, H, W, 4), slot
    (C, H, W), color (C, H, W, 3))`` with nvdiffrast's channels (u, v,
    z/w, triangle_id + 1).  Gradients reach ``v_clip`` (through u, v and
    color) and ``attrs`` (through color); z, the ids and slot carry none.
    ``cap`` slots a tile; a bin past it under-draws its tile.  The faces
    and the adjacency ``opp`` are host tables of the epoch."""
    return _RenderCore(faces, opp, resolution, cap)


def render_core(v_clip, attrs, faces, opp, resolution, cap: int = 768):
    """One call of a new :func:`make_render_core`."""
    return make_render_core(faces, opp, resolution, cap)(v_clip, attrs)


# faces object -> {(resolution, cap): render core}, an entry dropped when
# the caller's faces go (as core/parameterize.py keys its solvers)
_CORES: dict = {}


def _core_of(faces, resolution, cap) -> _RenderCore:
    """The attribute-free core of ``faces`` (zero adjacency), kept while
    the caller holds that faces object (a tensor or an array)."""
    key = id(faces)
    if key not in _CORES:
        weakref.finalize(faces, _CORES.pop, key, None)
        _CORES[key] = {}
    cores = _CORES[key]
    if (resolution, cap) not in cores:
        f = faces.cpu().numpy() if isinstance(faces, torch.Tensor) \
            else np.asarray(faces)
        cores[(resolution, cap)] = make_render_core(f, np.zeros_like(f),
                                                    resolution, cap)
    return cores[(resolution, cap)]


def _zero_attrs(v_clip):
    return v_clip.new_zeros((v_clip.shape[1], 3))


@torch.no_grad()
def rasterize_tiles_fwd(v_clip, faces, resolution, cap: int = 768):
    """Forward-only rasterize: v_clip (C, V, 4) × faces (F, 3) → rast
    (C, H, W, 4) with channels (u, v, z/w, triangle_id + 1).  ``cap`` slots
    a tile; a bin past it under-draws its tile (size it with
    :func:`check_bin_overflow` and :func:`suggest_cap`)."""
    core = _core_of(faces, tuple(int(r) for r in resolution), int(cap))
    return core.forward(v_clip, _zero_attrs(v_clip))[0]


def rasterize_tiles(v_clip, faces, resolution, cap: int = 768):
    """Differentiable rasterize on the tile kernels: as
    :func:`rasterize_tiles_fwd`, with the gradient with respect to
    ``v_clip`` through the (u, v) channels (``raster_bwd``)."""
    core = _core_of(faces, tuple(int(r) for r in resolution), int(cap))
    return core(v_clip, _zero_attrs(v_clip))[0]
