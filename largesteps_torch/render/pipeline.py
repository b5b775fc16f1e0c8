"""The fused render pipeline of the main path: setup, binning, the four
per-tile kernels, and the glue that chains their gradients to vertices.

Port of the non-prebinned, unsharded branch of
``largesteps_tpu/render/pallas_core.py`` (``triangle_setup``/``_setup_core``
lines 102-190, ``bin_triangles`` 193-242, ``suggest_cap`` and
``check_bin_overflow`` 525-545, ``_setup_and_bin`` 1172-1198,
``_chain_planes`` 1201-1235, ``build_incidence`` 1238-1257,
``_scatter_via_faces`` 1260-1289 and ``make_render_pipeline`` 1935-2116).

Layouts are the JAX package's, so tests compare like with like: records
(C, TY, TX, cap, 32) with the column maps below, bins (C, TY, TX, cap) with
−1 padding, 32×128 pixel tiles.  The kernels themselves live in
:mod:`largesteps_torch.render.kernels`.

rec_fwd columns: 0-2 q0a q0b q0c · 3-5 q1a q1b q1c · 6-8 sa sb sc (the
perspective denominator) · 9-11 da db dc (depth z/w) · 12 ymin 13 ymax
(pixel rows, 1 px expanded) · 14 fid (1-based) · 16-24 P0 Q0 R0 P1 Q1 R1
P2 Q2 R2 (colour_c = u·Pc + v·Qc + Rc).

rec_bwd columns: 0-2 b0a b0b b0c · 3-5 b1a b1b b1c (screen barycentrics) ·
6-8 iw0 iw1 iw2 · 9-14 sx0 sy0 sx1 sy1 sx2 sy2 · 15 inv_area · 16-21
P0 Q0 P1 Q1 P2 Q2 · 22 fid · 23-25 opp0 opp1 opp2 (1-based adjacent face,
0 = boundary) · 26 ymin 27 ymax.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .kernels import TILE_H, TILE_W, BIG

__all__ = ["triangle_setup", "bin_triangles", "setup_and_bin",
           "chain_planes", "build_incidence", "scatter_via_faces",
           "suggest_cap", "check_bin_overflow", "RenderPipeline"]


def triangle_setup(v_clip, faces, attrs, opp, height, width):
    """Per-triangle records for every camera.

    v_clip (C, V, 4), faces (F, 3) int64, attrs (V, 3), opp (F, 3) int64.
    Returns (rec_fwd (C, F, 32), rec_bwd (C, F, 32)).
    """
    F = faces.shape[0]
    fid = torch.arange(1, F + 1, dtype=torch.float32, device=v_clip.device)
    opp1 = (opp + 1).to(torch.float32)                  # 0 = boundary
    return _setup_core(v_clip[:, faces], attrs[faces], opp1, fid,
                       height, width)


def _setup_core(tri, A, opp1, fid, height, width):
    """Record assembly from gathered corners: tri (C, N, 3, 4) clip-space
    corners, A (N, 3, 3) corner attributes, opp1 (N, 3), fid (N,) with 0 for
    a dead slot (rigged to an empty y-range and no coverage)."""
    w = tri[..., 3]
    valid = torch.all(w > 1e-9, dim=-1) & (fid > 0.0)
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    zero = torch.zeros_like(w)
    iw = torch.where(valid[..., None], 1.0 / safe_w, zero)
    # direct division (not x * (1/w)): rounds like the antialias oracle's
    # screen coordinates, so edge-crossing parameters agree exactly
    ok = valid[..., None]
    sx = torch.where(ok, tri[..., 0] / safe_w, zero)
    sy = torch.where(ok, tri[..., 1] / safe_w, zero)
    zw = torch.where(ok, tri[..., 2] / safe_w, zero)

    area = (sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0]) \
        - (sy[..., 1] - sy[..., 0]) * (sx[..., 2] - sx[..., 0])
    valid = valid & (torch.abs(area) >= 1e-12)
    one = torch.ones_like(area)
    inv_area = torch.where(valid, 1.0 / torch.where(area == 0, one, area),
                           torch.zeros_like(area))

    b0a = -(sy[..., 2] - sy[..., 1]) * inv_area
    b0b = (sx[..., 2] - sx[..., 1]) * inv_area
    b0c = (sx[..., 1] * (sy[..., 2] - sy[..., 1])
           - sy[..., 1] * (sx[..., 2] - sx[..., 1])) * inv_area
    b1a = -(sy[..., 0] - sy[..., 2]) * inv_area
    b1b = (sx[..., 0] - sx[..., 2]) * inv_area
    b1c = (sx[..., 2] * (sy[..., 0] - sy[..., 2])
           - sy[..., 2] * (sx[..., 0] - sx[..., 2])) * inv_area

    q0a, q0b = b0a * iw[..., 0], b0b * iw[..., 0]
    q1a, q1b = b1a * iw[..., 1], b1b * iw[..., 1]
    # invalid triangles: q0 == -1 everywhere, so never covered
    q0c = torch.where(valid, b0c * iw[..., 0], -one)
    q1c = torch.where(valid, b1c * iw[..., 1], -one)
    d02, d12 = iw[..., 0] - iw[..., 2], iw[..., 1] - iw[..., 2]
    sa = b0a * d02 + b1a * d12
    sb = b0b * d02 + b1b * d12
    sc = b0c * d02 + b1c * d12 + iw[..., 2]
    z02, z12 = zw[..., 0] - zw[..., 2], zw[..., 1] - zw[..., 2]
    da = b0a * z02 + b1a * z12
    db = b0b * z02 + b1b * z12
    dc = b0c * z02 + b1c * z12 + zw[..., 2]

    # bbox in pixel rows, 1 px expanded (shared with the antialias kernels)
    ymin = (torch.amin(sy, dim=-1) + 1.0) * (height / 2.0) - 0.5 - 1.0
    ymax = (torch.amax(sy, dim=-1) + 1.0) * (height / 2.0) - 0.5 + 1.0
    ymin = torch.where(valid, ymin, torch.full_like(ymin, 1e9))
    ymax = torch.where(valid, ymax, torch.full_like(ymax, -1e9))

    shape = area.shape
    P = (A[..., 0, :] - A[..., 2, :]).expand(*shape, 3)
    Q = (A[..., 1, :] - A[..., 2, :]).expand(*shape, 3)
    R = A[..., 2, :].expand(*shape, 3)
    fidb = fid.expand(shape)
    pad = torch.zeros_like(area)
    opp1 = opp1.expand(*shape, 3)

    rec_fwd = torch.stack([
        q0a, q0b, q0c, q1a, q1b, q1c, sa, sb, sc, da, db, dc,
        ymin, ymax, fidb, pad,
        P[..., 0], Q[..., 0], R[..., 0], P[..., 1], Q[..., 1], R[..., 1],
        P[..., 2], Q[..., 2], R[..., 2],
        pad, pad, pad, pad, pad, pad, pad,
    ], dim=-1)
    rec_bwd = torch.stack([
        b0a, b0b, b0c, b1a, b1b, b1c,
        iw[..., 0], iw[..., 1], iw[..., 2],
        sx[..., 0], sy[..., 0], sx[..., 1], sy[..., 1], sx[..., 2], sy[..., 2],
        inv_area,
        P[..., 0], Q[..., 0], P[..., 1], Q[..., 1], P[..., 2], Q[..., 2],
        fidb, opp1[..., 0], opp1[..., 1], opp1[..., 2],
        ymin, ymax,
        pad, pad, pad, pad,
    ], dim=-1)
    return rec_fwd, rec_bwd


def bin_triangles(rec_fwd, v_clip, faces, height, width, cap):
    """Fixed-capacity per-tile bins for every camera.

    The overlap test uses the 1 px expanded bbox, so the antialias kernels
    find pair owners that sit just across a tile border.  Each bin is sorted
    by ymin (ties by face id); the kernels' (depth, fid) z-test makes the
    result independent of that order.  Returns (bins (C, TY, TX, cap) int64
    with −1 padding, counts (C, TY, TX) before clamping to ``cap``).
    """
    ty, tx = height // TILE_H, width // TILE_W
    tri = v_clip[:, faces]
    w = tri[..., 3]
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    iw = 1.0 / safe_w
    sx = tri[..., 0] * iw
    xmin = (torch.amin(sx, dim=-1) + 1.0) * (width / 2.0) - 0.5 - 1.0
    xmax = (torch.amax(sx, dim=-1) + 1.0) * (width / 2.0) - 0.5 + 1.0
    ymin = rec_fwd[..., 12]
    ymax = rec_fwd[..., 13]
    valid = ymax > ymin                       # invalid: rigged empty range

    dev = v_clip.device
    ty0 = (torch.arange(ty, dtype=torch.float32, device=dev)
           * TILE_H)[None, :, None, None]
    tx0 = (torch.arange(tx, dtype=torch.float32, device=dev)
           * TILE_W)[None, None, :, None]
    e = lambda a: a[:, None, None, :]
    overlap = ((e(ymax) >= ty0) & (e(ymin) <= ty0 + TILE_H - 1)
               & (e(xmax) >= tx0) & (e(xmin) <= tx0 + TILE_W - 1)
               & e(valid))                     # (C, TY, TX, F)
    counts = overlap.sum(dim=-1)
    key = torch.where(overlap, e(ymin).expand_as(overlap),
                      torch.full_like(overlap, float("inf"),
                                      dtype=torch.float32))
    order = torch.argsort(key, dim=-1, stable=True)
    if order.shape[-1] < cap:
        order = torch.nn.functional.pad(order,
                                        (0, cap - order.shape[-1]))
    bins = order[..., :cap]
    k = torch.arange(cap, device=dev)
    bins = torch.where(k < torch.clamp(counts, max=cap)[..., None], bins,
                       torch.full_like(bins, -1))
    return bins, counts


def setup_and_bin(v_clip, faces, attrs, opp, height, width, cap):
    """Setup and binning of all cameras: (rec_fwd_b, rec_bwd_b) of shape
    (C, TY, TX, cap, 32), bins (C, TY, TX, cap) and counts (C, TY, TX)
    int32, clamped to ``cap``."""
    rec_fwd, rec_bwd = triangle_setup(v_clip, faces, attrs, opp, height,
                                      width)
    bins, counts = bin_triangles(rec_fwd, v_clip, faces, height, width, cap)
    C = v_clip.shape[0]
    cam = torch.arange(C, device=v_clip.device)[:, None, None, None]
    safe = torch.clamp(bins, min=0)
    live = (bins >= 0)[..., None]
    rfb = torch.where(live, rec_fwd[cam, safe], 0.0)
    rbb = torch.where(live, rec_bwd[cam, safe], 0.0)
    # padded slots get an empty y-range (a zeroed row would read as y = 0)
    dead = bins < 0
    rfb[..., 12] = torch.where(dead, 1e9, rfb[..., 12])
    rfb[..., 13] = torch.where(dead, -1e9, rfb[..., 13])
    return (rfb.contiguous(), rbb.contiguous(), bins,
            torch.clamp(counts, max=cap).to(torch.int32))


def chain_planes(dslot, dslot_aa, boost, rbb):
    """Per-slot screen-space sums → a corner-major (..., cap, 18) table
    [per corner: dx dy dw dA0 dA1 dA2] in clip space (dz is identically
    zero and is put back by :func:`scatter_via_faces`).

    dslot (..., cap, 32) raster sums; dslot_aa (..., cap, 8) antialias
    endpoint sums (cols 0-5), scaled by ``boost``, or None.
    """
    iw = [rbb[..., 6 + k] for k in range(3)]
    sx = [rbb[..., 9 + 2 * k] for k in range(3)]
    sy = [rbb[..., 10 + 2 * k] for k in range(3)]
    planes = []
    for k in range(3):
        dsx = dslot[..., 2 * k]
        dsy = dslot[..., 2 * k + 1]
        if dslot_aa is not None:
            dsx = dsx + boost * dslot_aa[..., 2 * k]
            dsy = dsy + boost * dslot_aa[..., 2 * k + 1]
        diw = dslot[..., 6 + k]
        # sx = x/w: dx = dsx·iw, dw = −iw²·diw − iw·(dsx·sx + dsy·sy)
        planes += [dsx * iw[k], dsy * iw[k],
                   -iw[k] * iw[k] * diw - iw[k] * (dsx * sx[k] + dsy * sy[k]),
                   dslot[..., 9 + 3 * k], dslot[..., 10 + 3 * k],
                   dslot[..., 11 + 3 * k]]
    table = torch.stack(planes, dim=-1)
    # sliver triangles give inf upstream (1/s, 1/area, 1/den²); one inf
    # component NaNs every parameter through AdamUniform's global max, so
    # drop non-finite per-slot contributions (False for inf and NaN alike)
    return torch.where(torch.abs(table) < BIG, table, 0.0)


def build_incidence(faces, n_verts):
    """Static vertex ← (face, corner) incidence in padded-row form: (idx
    (V, K) int64 into a corner-major (F·3 + 3) table, mask (V, K)); padded
    entries point at the sentinel row 3F.  Host, once per topology."""
    faces = np.asarray(faces)
    F = faces.shape[0]
    vids = faces.reshape(-1)
    order = np.argsort(vids, kind="stable")
    counts = np.bincount(vids, minlength=n_verts)
    K = int(counts.max())
    offsets = np.zeros(n_verts + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    k_idx = np.arange(K)[None, :]
    valid = k_idx < counts[:, None]
    slot = np.where(valid, offsets[:-1, None] + k_idx, 0)
    idx = np.where(valid, order[slot], 3 * F).astype(np.int64)
    return idx, valid


def scatter_via_faces(table18, bins, incidence, n_faces, n_verts):
    """Slot gradients → vertex gradients through a per-face table.

    table18 (C, TY, TX, cap, 18) from :func:`chain_planes`; bins
    (C, TY, TX, cap); incidence from :func:`build_incidence` as tensors on
    the table's device.  Returns (dv_clip (C, V, 4), d_attrs (V, 3)).
    """
    idx, mask = incidence
    C = table18.shape[0]
    F = n_faces
    dev = table18.device
    ids = torch.where(bins >= 0, bins, F).reshape(C, -1)
    ids = ids + (torch.arange(C, device=dev) * (F + 1))[:, None]
    dface = torch.zeros((C * (F + 1), 18), dtype=table18.dtype, device=dev)
    dface.index_add_(0, ids.reshape(-1), table18.reshape(-1, 18))
    per_corner = dface.reshape(C, (F + 1) * 3, 6)
    gathered = per_corner[:, idx.reshape(-1)].reshape(C, *idx.shape, 6)
    dv = (gathered * mask[None, :, :, None]).sum(dim=2)   # (C, V, 6)
    dv_clip = torch.cat([dv[..., 0:2], torch.zeros_like(dv[..., :1]),
                         dv[..., 2:3]], dim=-1)
    return dv_clip, dv[..., 3:6].sum(dim=0)


def suggest_cap(max_count: int, chunk: int = 8) -> int:
    """Round a measured max bin occupancy up to a multiple of 128, with
    25 % headroom."""
    c = max(chunk * 4, int(max_count * 1.25))
    return ((c + 127) // 128) * 128


@torch.no_grad()
def check_bin_overflow(v_clip, faces, resolution) -> int:
    """Max bin occupancy over all cameras and tiles."""
    height, width = resolution
    F = faces.shape[0]
    attrs = torch.zeros((v_clip.shape[1], 3), dtype=torch.float32,
                        device=v_clip.device)
    opp = torch.zeros((F, 3), dtype=torch.int64, device=v_clip.device)
    rec_fwd, _ = triangle_setup(v_clip, faces, attrs, opp, height, width)
    _, counts = bin_triangles(rec_fwd, v_clip, faces, height, width, 8)
    return int(counts.max())


class RenderPipeline:
    """The fused render op of one topology epoch.

    ``pipe(v_clip (C, V, 4), attrs (V, 3), bg) → (C, H, W, 4)`` shaded
    images (``(C, H, W, 3)`` with ``shading=False``; pass ``bg=None``).
    Rasterize → interpolate → composite over ``bg`` → antialias, with
    ``boost`` multiplying exactly the antialias position gradients.  One
    ``torch.autograd.Function`` wraps the chain, so bins, records and the
    slot map are built once and shared by the forward and backward kernels.
    """

    def __init__(self, faces, opp, resolution, shading=True, boost=1.0,
                 cap=768):
        self.faces = np.ascontiguousarray(np.asarray(faces), dtype=np.int64)
        self.opp = np.ascontiguousarray(np.asarray(opp), dtype=np.int64)
        self.resolution = tuple(resolution)
        self.shading = bool(shading)
        self.boost = float(boost)
        self.cap = int(cap)
        self._dev = {}

    def device_tables(self, device, n_verts):
        """faces, opp and the vertex incidence as tensors on ``device``
        (uploaded once per device and vertex count)."""
        key = (str(device), n_verts)
        if key not in self._dev:
            idx, mask = build_incidence(self.faces, n_verts)
            as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
            self._dev[key] = (as_t(self.faces, torch.int64),
                              as_t(self.opp, torch.int64),
                              (as_t(idx, torch.int64),
                               as_t(mask, torch.float32)))
        return self._dev[key]

    def __call__(self, v_clip, attrs, bg=None):
        return _PipelineFn.apply(self, v_clip, attrs, bg)


class _PipelineFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pipe, v_clip, attrs, bg):
        height, width = res = pipe.resolution
        faces, opp, _ = pipe.device_tables(v_clip.device, v_clip.shape[1])
        rfb, rbb, bins, counts = setup_and_bin(v_clip, faces, attrs, opp,
                                               height, width, pipe.cap)
        u, v, z, fid, slot, c0, c1, c2 = kernels.raster_fwd(rfb, counts, res)
        color = torch.stack([c0, c1, c2], dim=-1)
        cov = (fid > 0.0)[..., None]
        if pipe.shading:
            col4 = torch.cat([color, cov.to(color.dtype)], dim=-1)
            comp = torch.where(cov, col4, bg)
        else:
            comp = color
        out = kernels.aa_fwd(rbb, counts, fid, z, comp.contiguous(), res)
        ctx.pipe = pipe
        ctx.n_verts = v_clip.shape[1]
        ctx.bg_shape = None if bg is None else bg.shape
        ctx.save_for_backward(rbb, bins, counts, slot, fid, z, comp, cov)
        return out

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        res = pipe.resolution
        rbb, bins, counts, slot, fid, z, comp, cov = ctx.saved_tensors
        d_comp, dslot_aa = kernels.aa_bwd(rbb, counts, fid, z, comp,
                                          g.contiguous(), res)
        if pipe.shading:
            d_color = torch.where(cov, d_comp[..., :3], 0.0)
        else:
            d_color = d_comp
        zeros = torch.zeros_like(fid)
        dslot = kernels.raster_bwd(rbb, counts, slot, d_color.contiguous(),
                                   zeros, zeros, res)
        table18 = chain_planes(dslot, dslot_aa, pipe.boost, rbb)
        _, _, incidence = pipe.device_tables(rbb.device, ctx.n_verts)
        dv_clip, d_attrs = scatter_via_faces(table18, bins, incidence,
                                             pipe.faces.shape[0], ctx.n_verts)
        d_bg = None
        if ctx.bg_shape is not None and ctx.needs_input_grad[3]:
            # comp = where(cov, col4, bg): d_bg is d_comp off the surface
            d_bg = torch.where(cov, 0.0, d_comp)
            extra = d_bg.ndim - len(ctx.bg_shape)
            if extra:
                d_bg = d_bg.sum(dim=tuple(range(extra)))
        return None, dv_clip, d_attrs, d_bg
