"""Differentiable multi-view renderer.

Port of ``largesteps_tpu/render/renderer.py``: project all cameras →
rasterize → interpolate SH vertex lighting (or constant white for
silhouettes) → composite over the environment backgrounds → antialias, with
``boost`` on the antialias position gradients.  Two backends: ``"tiles"``
(JAX's ``"pallas"``), the fused pipelines of
:mod:`largesteps_torch.render.pipeline` on the CUDA tile kernels, which take
``render(..., bins=)`` for the large-F path; and ``"dense"`` (JAX's
``"xla"``), the capacity-free PyTorch rasterizer and antialias of
:mod:`largesteps_torch.render.raster` and
:mod:`largesteps_torch.render.antialias`, at any resolution.  A renderer
cut to one rank's shard of a ``(dp, sp)`` mesh
(:func:`largesteps_torch.parallel.sharding.shard_renderer`) draws that
rank's cameras and rows and sums the gradients of its inputs over the
ranks (JAX's ``renderer.py:172-239``).
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .._device import resolve_device
from ..parallel import distributed as pdist
from ..spans import span as _span
from .antialias import antialias, face_adjacency
from .camera import persp_proj, build_mvps, project
from .pipeline import (RenderPipeline, RenderPipelineBig, check_bin_overflow,
                       suggest_cap, TILE_H, TILE_W)
from .raster import rasterize, interpolate
from .sh import sh_matrices, sh_eval
from .texture import texture_bilinear

__all__ = ["Topology", "Renderer", "render_backgrounds", "batched_bytes",
           "BATCHED_SHARE"]

# the share of the device's memory that the batched prebinned pipe's
# working set (batched_bytes) may take; past it the camera-sequential pipe
# renders one camera at a time
BATCHED_SHARE = 0.25


class Topology:
    """Static per-epoch mesh topology: faces and edge adjacency (host)."""

    def __init__(self, faces):
        self.faces = np.ascontiguousarray(np.asarray(faces), dtype=np.int32)
        self.opp = face_adjacency(self.faces)
        # (res, shading, boost, cap, prebinned, slots_k, camera-sequential,
        # row shards, row index) -> pipeline
        self._pipe_cache = {}
        self._dense = {}        # device -> (faces, opp) tensors

    def dense_tables(self, device):
        """faces and opp as int64 tensors on ``device`` (the dense path's),
        uploaded once per device."""
        key = str(device)
        if key not in self._dense:
            as_t = lambda a: torch.as_tensor(a.astype(np.int64),
                                             device=device)
            self._dense[key] = (as_t(self.faces), as_t(self.opp))
        return self._dense[key]

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])


def batched_bytes(n_cams, tiles, cap, n_faces) -> int:
    """Bytes the batched prebinned pipe keeps at once: per (camera, tile,
    slot) the forward and backward records, raster_bwd's sums (32 floats
    each), the antialias sums (8) and the chained table (18); per (camera,
    face) the setup records, twice."""
    return 4 * (n_cams * tiles * cap * (32 + 32 + 32 + 8 + 18)
                + 2 * n_cams * n_faces * 32)


def _device_bytes(device) -> int:
    """Memory of the device the tensors live on."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def render_backgrounds(envmap, view_mats, fov_x, res) -> torch.Tensor:
    """Per-view environment backgrounds (C, H, W, 4) by casting each
    pixel's ray into equirect UVs; alpha set to 0.  Computed on the CPU."""
    h, w = res
    envmap = torch.as_tensor(np.asarray(envmap, np.float32))
    view_mats = torch.as_tensor(np.asarray(view_mats, np.float32))
    tan_a = np.tan(np.deg2rad(fov_x) / 2.0)
    ar = w / h
    xs = (torch.arange(w, dtype=torch.float32) + 0.5) / w * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32) + 0.5) / h * 2.0 - 1.0
    x_ndc = xs[None, :].expand(h, w)
    y_ndc = ys[:, None].expand(h, w)
    # camera-space ray under persp_proj's conventions (x negated)
    d_cam = torch.stack([-x_ndc * tan_a, y_ndc * tan_a / ar,
                         torch.ones_like(x_ndc)], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    inv_rot = torch.linalg.inv(view_mats)[:, :3, :3]
    d_world = torch.einsum("cij,hwj->chwi", inv_rot, d_cam)
    theta = torch.arccos(torch.clamp(d_world[..., 1], -1.0, 1.0))
    phi = torch.arctan2(d_world[..., 0], d_world[..., 2])
    uv = torch.stack([0.75 - phi / (2 * np.pi), theta / np.pi], dim=-1)
    bgs = texture_bilinear(envmap, uv)
    if bgs.shape[-1] >= 4:
        bgs[..., -1] = 0.0
    return bgs


class Renderer:
    """Multi-view differentiable renderer on ``device`` (CUDA unless the
    caller asks for the CPU).

    ``scene_params`` holds near_clip, far_clip, fov, res_x, res_y,
    view_mats, envmap and envmap_scale; ``shading`` selects shaded or
    silhouette images; ``boost`` multiplies the antialias position
    gradients.  ``backend``: ``"tiles"`` (the CUDA tile kernels; the
    resolution must tile into 32×128 pixels), ``"dense"`` (any resolution)
    or ``"auto"``, which takes tiles where the resolution tiles and dense
    elsewhere, as JAX's ``"auto"`` picks ``"pallas"`` or ``"xla"``.
    ``chunk`` is the dense rasterizer's faces a step, ``aa_cap`` the dense
    antialias's pair capacity (None: auto), ``bin_cap`` the tile bins'.
    """

    def __init__(self, scene_params, shading: bool = True, boost: float = 1.0,
                 chunk: int = 128, backend: str = "auto", bin_cap: int = 768,
                 aa_cap: int | None = None, device=None):
        self.device = resolve_device(device)
        near = scene_params["near_clip"]
        far = scene_params["far_clip"]
        self.fov_x = scene_params["fov"]
        w = scene_params["res_x"]
        h = scene_params["res_y"]
        if backend == "auto":
            backend = "tiles" if (h % TILE_H == 0 and w % TILE_W == 0) \
                else "dense"
        if backend not in ("tiles", "dense"):
            raise ValueError(f"backend {backend!r}: 'auto', 'tiles' or "
                             f"'dense'")
        if backend == "tiles" and (h % TILE_H or w % TILE_W):
            raise ValueError(f"resolution {h}x{w} does not tile into "
                             f"{TILE_H}x{TILE_W} pixel tiles; use "
                             f"backend='dense'")
        self.backend = backend
        self.chunk = int(chunk)
        self.aa_cap = aa_cap
        self.res = (h, w)
        self.proj_mat = persp_proj(self.fov_x, w / h, near, far)
        self.view_mats = np.stack([np.asarray(v)
                                   for v in scene_params["view_mats"]])
        self.mvps = torch.as_tensor(build_mvps(self.proj_mat, self.view_mats),
                                    device=self.device)
        self.boost = float(boost)
        self.shading = bool(shading)
        bin_cap = int(bin_cap)
        if bin_cap > 128 and bin_cap % 128 != 0:
            raise ValueError(f"bin_cap must be <=128 or a multiple of 128; "
                             f"got {bin_cap}")
        self.bin_cap = bin_cap
        self._bin_cap_floor = bin_cap
        envmap = scene_params.get("envmap_scale", 1.0) * np.asarray(
            scene_params["envmap"], np.float32)
        self.sh_M = sh_matrices(envmap).to(self.device)
        self.bgs = render_backgrounds(envmap, self.view_mats, self.fov_x,
                                      self.res).to(self.device)
        # a rank's shard (parallel.sharding.shard_renderer sets these)
        self.mesh = None
        self.row_shards = 1
        self.cam_slice, self.row_slice = slice(0, len(self.mvps)), slice(0, h)

    @torch.no_grad()
    def check_overflow(self, v, topology: Topology, grow: bool = True) -> int:
        """Measure the bin occupancy of ``v`` and, with ``grow``, resize
        ``bin_cap`` in both directions: up to fit, down (with hysteresis,
        never below the configured cap) when it is more than twice too
        large.  Returns the measured max occupancy; 0 on the dense
        backend, which has no bins."""
        if self.backend != "tiles":
            return 0
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        faces = torch.as_tensor(topology.faces.astype(np.int64),
                                device=self.device)
        occ = check_bin_overflow(project(v, self.mvps), faces, self.res)
        occ = int(pdist.host_max([occ], self.mesh)[0])   # every rank's cameras
        fit = suggest_cap(occ)
        if grow:
            if fit > self.bin_cap:
                self.bin_cap = fit
            elif fit < self.bin_cap // 2:
                self.bin_cap = max(fit, self._bin_cap_floor)
        elif occ > self.bin_cap:
            warnings.warn(f"raster bin occupancy {occ} exceeds bin_cap "
                          f"{self.bin_cap}; tiles will under-draw (suggest "
                          f"bin_cap={fit})")
        return occ

    def camera_sequential(self, cap: int, n_faces: int) -> bool:
        """Whether prebinned bins of ``cap`` take the camera-sequential
        pipe: when the batched pipe's working set would pass a quarter
        (``BATCHED_SHARE``) of the device's memory.  The working set, in
        float32 values, is C·T·cap·(32 + 32 + 32 + 8 + 18) + 2·C·F·32
        (:func:`batched_bytes`) for C views of T tiles and F faces (the
        rank's views and tile rows)."""
        h, w = self.res
        tiles = (h // TILE_H // self.row_shards) * (w // TILE_W)
        need = batched_bytes(self.mvps.shape[0], tiles, cap, n_faces)
        return need > BATCHED_SHARE * _device_bytes(self.device)

    def render(self, v, n, topology: Topology, bins=None):
        """Render every view: v (V, 3), n (V, 3) → (C, H, W, 4|3),
        differentiable with respect to v and n.

        ``bins``: precomputed ``(bins (C, T, cap), counts (C, T)[, fslots
        (C, F+1, K)])`` device tensors (the large-F path, tiles backend
        only; no gradient), in place of the traced per-step binning; the
        pipe is chosen by :meth:`camera_sequential`.  On a rank's shard the
        images are the rank's cameras and rows, the bins the rank's cameras
        (whole images; the pipe takes its rows), and the gradients of ``v``
        and ``n`` the sums over every rank (a row shard's pipe sums over its
        mesh row, :class:`_SumGrads` over the cameras' ranks); the face→slot
        inverse is not used there (JAX's sharded pipes scatter by faces)."""
        if self.mesh is not None:
            if self.row_shards == 1:      # cameras over the ranks
                v, n = _SumGrads.apply(None, v, n)
            elif self.mesh.dp > 1:        # rows summed in the pipe
                v, n = _SumGrads.apply(self.mesh.dp_group, v, n)
        if self.backend == "dense":
            if bins is not None:
                raise ValueError("bins are the tiles backend's")
            return self._render_dense(v, n, topology)
        prebinned = bins is not None
        fslots = None
        if prebinned:
            cap = int(bins[0].shape[-1])
            if len(bins) > 2 and bins[2] is not None and self.mesh is None:
                fslots = bins[2]
            big = self.camera_sequential(cap, topology.n_faces)
        else:
            cap, big = self.bin_cap, False
        slots_k = None if fslots is None else int(fslots.shape[-1])
        key = (self.res, self.shading, self.boost, cap, prebinned, slots_k,
               big, self.row_shards)
        pipe = topology._pipe_cache.get(key)
        if pipe is None:
            kind = RenderPipelineBig if big else RenderPipeline
            kw = {} if big else {"prebinned": prebinned}
            row_mesh = self.mesh if self.row_shards > 1 else None
            pipe = kind(topology.faces, topology.opp, self.res,
                        shading=self.shading, boost=self.boost, cap=cap,
                        slots_k=slots_k, mesh=row_mesh, **kw)
            topology._pipe_cache[key] = pipe
        extra = ()
        if prebinned:
            extra = (bins[0], bins[1]) + (() if fslots is None else (fslots,))
        v_ndc = project(v, self.mvps)
        if self.shading:
            return pipe(v_ndc, sh_eval(self.sh_M, n) / np.pi, self.bgs, *extra)
        return pipe(v_ndc, torch.ones_like(v), None, *extra)

    def _render_dense(self, v, n, topology: Topology):
        """The dense path (``largesteps_tpu/render/renderer.py:240-253``).
        Its forward stages are spans (``zbuffer``, ``interpolate``,
        ``shade``, ``antialias``; :mod:`largesteps_torch.spans`) that
        :mod:`largesteps_torch.profiling` splits a step by."""
        faces, opp = topology.dense_tables(self.device)
        v_ndc = project(v, self.mvps)
        with _span("zbuffer"):
            rast = rasterize(v_ndc, faces, self.res, self.chunk)
        if self.shading:
            with _span("shade"):
                irradiance = sh_eval(self.sh_M, n)
            with _span("interpolate"):
                light = interpolate(irradiance, rast, faces)
            with _span("shade"):
                alpha = torch.ones_like(light[..., :1])
                col = torch.cat([light / np.pi, alpha], dim=-1)
                covered = rast[..., 3:4] != 0
                col = torch.where(covered, col, self.bgs)
        else:
            with _span("interpolate"):
                col = interpolate(torch.ones_like(v), rast, faces)
        with _span("antialias"):
            return antialias(col, rast, v_ndc, faces, opp, self.boost,
                             cap=self.aa_cap)


class _SumGrads(torch.autograd.Function):
    """The identity on the renderer's replicated inputs (v, n), whose
    backward sums their gradients over the ranks of ``group`` (None: every
    rank of the mesh): each rank's images hold only its shard's share of
    them (``shard_map``'s ``psum`` of replicated cotangents).  A row-sharded
    tile pipe completes its per-face sums over its mesh row itself
    (``pipeline._scatter``), so there the group is the ranks of the other
    cameras (``dp_group``).  One all-reduce for both; every rank gets the
    same bits, so the replicated state stays replicated."""

    @staticmethod
    def forward(ctx, group, v, n):
        ctx.group = group
        ctx.shapes, ctx.device = (v.shape, n.shape), v.device
        return v.view_as(v), n.view_as(n)

    @staticmethod
    def backward(ctx, gv, gn):
        sv, sn = ctx.shapes
        if gv is None:
            gv = torch.zeros(sv, device=ctx.device)
        if gn is None:
            gn = torch.zeros(sn, device=ctx.device)
        flat = torch.cat([gv.reshape(-1), gn.reshape(-1)])
        pdist.all_reduce(flat, group=ctx.group)
        k = gv.numel()
        return None, flat[:k].reshape(sv), flat[k:].reshape(sn)
