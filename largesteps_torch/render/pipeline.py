"""The fused render pipelines: setup, binning, the four per-tile kernels, and
the glue that chains their gradients to vertices.

Port of ``largesteps_tpu/render/pallas_core.py``: the setup
(``triangle_setup``/``_setup_core`` lines 102-190), the traced binning
(``bin_triangles`` 193-242, ``suggest_cap`` and ``check_bin_overflow``
525-545, ``_setup_and_bin`` 1172-1198), the large-F binning
(``setup_from_bins`` 245-273, ``bin_triangles_host`` 276-408,
``bin_triangles_device`` 411-522), the backward glue (``_chain_planes``
1201-1235, ``build_incidence`` 1238-1257, ``_scatter_via_faces`` and
``_scatter_via_slots`` 1260-1321), ``make_render_pipeline`` with and
without precomputed bins (1903-2116) and the camera-sequential
``make_render_pipeline_big`` (2134-2304), each also for one image-row shard
(given a mesh of ``sp > 1``): the pipe bins or slices out the shard's
tile rows (``bin_triangles``' ``ty_range``, ``local_bins``), runs
the kernels with its first tile row, and swaps the antialias halo rows with
the neighbouring shards of its mesh row (``_shift_up_halo`` and
``_shift_down_ch_halo``), forward and backward.  Its images are the
shard's rows; its vertex gradients the shard's share, which the renderer
sums over the ranks.

Layouts are the JAX package's, so tests compare like with like: records
(C, TY, TX, cap, 32) with the column maps below, bins (C, TY, TX, cap) or
(C, T, cap) with −1 padding, 32×128 pixel tiles.  The kernels themselves
live in :mod:`largesteps_torch.render.kernels`.

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
from ..ops.segment import run_sums, segment_sum
from ..parallel import distributed as pdist
from ..spans import span as _span

__all__ = ["triangle_setup", "bin_triangles", "setup_and_bin",
           "setup_from_bins", "bin_triangles_host", "bin_triangles_device",
           "DEVICE_BIN_SPAN", "chain_planes", "build_incidence", "face_ids",
           "first_half", "face_sums", "scatter_via_faces", "slot_face_rows",
           "scatter_via_slots", "suggest_cap", "check_bin_overflow",
           "RenderPipeline", "RenderPipelineBig", "ABLATE"]

# the backward stages a pipe can be built without (RenderPipeline's ablate)
ABLATE = ("aabwd", "rbwd", "scatter")


def triangle_setup(v_clip, faces, attrs, opp, height, width, need_fwd=True):
    """Per-triangle records for every camera.

    v_clip (C, V, 4), faces (F, 3) int64, attrs (V, 3), opp (F, 3) int64.
    Returns (rec_fwd (C, F, 32), rec_bwd (C, F, 32)); rec_fwd is None with
    ``need_fwd=False``.
    """
    F = faces.shape[0]
    fid = torch.arange(1, F + 1, dtype=torch.float32, device=v_clip.device)
    opp1 = (opp + 1).to(torch.float32)                  # 0 = boundary
    return _setup_core(v_clip[:, faces], attrs[faces], opp1, fid,
                       height, width, need_fwd)


def _setup_core(tri, A, opp1, fid, height, width, need_fwd=True):
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

    rec_fwd = None if not need_fwd else torch.stack([
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


def bin_triangles(rec_fwd, v_clip, faces, height, width, cap,
                  ty_range=None):
    """Fixed-capacity per-tile bins for every camera.

    The overlap test uses the 1 px expanded bbox, so the antialias kernels
    find pair owners that sit just across a tile border.  Each bin is sorted
    by ymin (ties by face id); the kernels' (depth, fid) z-test makes the
    result independent of that order.  Returns (bins (C, TY, TX, cap) int64
    with −1 padding, counts (C, TY, TX) before clamping to ``cap``).
    ``ty_range`` = (first tile row, TY) bins only those tile rows (a row
    shard's).
    """
    ty, tx = height // TILE_H, width // TILE_W
    row0 = 0
    if ty_range is not None:
        row0, ty = ty_range
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
    ty0 = ((torch.arange(ty, dtype=torch.float32, device=dev) + row0)
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


def setup_and_bin(v_clip, faces, attrs, opp, height, width, cap,
                  ty_range=None):
    """Setup and binning of all cameras: (rec_fwd_b, rec_bwd_b) of shape
    (C, TY, TX, cap, 32), bins (C, TY, TX, cap) and counts (C, TY, TX)
    int32, clamped to ``cap``; TY tile rows from the first of ``ty_range``
    where it is given."""
    rec_fwd, rec_bwd = triangle_setup(v_clip, faces, attrs, opp, height,
                                      width)
    bins, counts = bin_triangles(rec_fwd, v_clip, faces, height, width, cap,
                                 ty_range)
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


def _gather_rows(rec, bins, fill):
    """Whole 32-float record rows by bins: rec (C, F, 32), bins (C, T, cap)
    with −1 for a dead slot, which gets the row ``fill``."""
    C, F, _ = rec.shape
    ext = torch.cat([rec, fill.expand(C, 1, 32)], dim=1)
    ids = torch.where(bins >= 0, bins, F)
    cam = torch.arange(C, device=rec.device)[:, None, None]
    return ext[cam, ids]


def setup_from_bins(v_clip, faces, attrs, opp, bins, height, width,
                    need_fwd=True):
    """Setup and record gather by precomputed bins (the large-F path).

    The records are built face-major, as :func:`triangle_setup` builds
    them, and whole rows are gathered by ``bins`` (C, T, cap) (−1 = dead
    slot).  Dead slots get an empty y-range in rfb (a zeroed row would read
    as y = 0) and zeros in rbb.  Returns (rfb, rbb), each (C, T, cap, 32);
    rfb is None with ``need_fwd=False`` (the backward's recompute).
    """
    rec_fwd, rec_bwd = triangle_setup(v_clip, faces, attrs, opp, height,
                                      width, need_fwd)
    rbb = _gather_rows(rec_bwd, bins, rec_bwd.new_zeros(32))
    if not need_fwd:
        return None, rbb
    dead = rec_fwd.new_zeros(32)
    dead[12], dead[13] = 1e9, -1e9
    return _gather_rows(rec_fwd, bins, dead), rbb


def bin_triangles_host(v_ndc, faces, resolution, cap=None, margin=0.0,
                       chunk=8, cull=False, return_spans=False,
                       return_slots=False):
    """Host (numpy) binning of all cameras: the large-F path's epoch bins.

    Each face enters the bins of every tile its bbox, expanded by 1 px (the
    antialias pairs) plus ``margin`` px, overlaps; a margin keeps the bins
    valid for every step in which no vertex moves more than margin/2 px.
    Each bin is ordered by ymin (ties by entry order).  v_ndc (C, V, 4)
    numpy.  Returns (bins (C, T, cap) int32 with −1 padding, counts (C, T)
    int32 clamped to cap, occ); with ``return_slots`` (bins, counts, fslots
    (C, F+1, K) int32 flat slot indices with sentinel T·cap, occ); with
    ``return_spans`` also (span_y, span_x), the most tiles a face spans.
    ``cap=None`` sizes the bins from the occupancy (:func:`suggest_cap`).
    """
    height, width = resolution
    ty_n, tx_n = height // TILE_H, width // TILE_W
    T = ty_n * tx_n
    v_ndc = np.asarray(v_ndc)
    faces = np.asarray(faces)
    C = v_ndc.shape[0]

    # planar per-corner gathers (a (C, F, 3, 4) fancy index is far slower)
    vx = np.ascontiguousarray(v_ndc[..., 0])
    vy = np.ascontiguousarray(v_ndc[..., 1])
    vw = np.ascontiguousarray(v_ndc[..., 3])
    sx, sy, valid = [], [], True
    for c in range(3):
        idx = faces[:, c]
        w = vw[:, idx]                           # (C, F)
        valid = valid & (w > 1e-9)
        w[w == 0] = 1.0
        sx.append(vx[:, idx] / w)
        sy.append(vy[:, idx] / w)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) \
        - (sy[1] - sy[0]) * (sx[2] - sx[0])
    if cull:
        # closed meshes: a back face never wins the z-test; front faces have
        # positive screen-space area under the negated-x projection
        valid &= area > 0.0
    else:
        valid &= np.abs(area) >= 1e-12
    exp = 1.0 + margin                           # 1 px antialias + margin
    xmin = (np.minimum(np.minimum(sx[0], sx[1]), sx[2]) + 1.0) \
        * (width / 2.0) - 0.5 - exp
    xmax = (np.maximum(np.maximum(sx[0], sx[1]), sx[2]) + 1.0) \
        * (width / 2.0) - 0.5 + exp
    ymin = (np.minimum(np.minimum(sy[0], sy[1]), sy[2]) + 1.0) \
        * (height / 2.0) - 0.5 - exp
    ymax = (np.maximum(np.maximum(sy[0], sy[1]), sy[2]) + 1.0) \
        * (height / 2.0) - 0.5 + exp

    # inclusive tile ranges, the traced overlap test's
    valid &= (xmax >= 0) & (ymax >= 0) \
        & (xmin <= width - 1) & (ymin <= height - 1)
    jlo = np.clip(np.floor(xmin).astype(np.int64) // TILE_W, 0, tx_n - 1)
    jhi = np.clip(np.floor(xmax).astype(np.int64) // TILE_W, 0, tx_n - 1)
    ilo = np.clip(np.floor(ymin).astype(np.int64) // TILE_H, 0, ty_n - 1)
    ihi = np.clip(np.floor(ymax).astype(np.int64) // TILE_H, 0, ty_n - 1)

    span_y = int(np.max((ihi - ilo + 1) * valid, initial=1))
    span_x = int(np.max((jhi - jlo + 1) * valid, initial=1))

    tile_ids, face_ids, cam_ids, ent_ids = [], [], [], []
    F = faces.shape[0]
    fidx = np.broadcast_to(np.arange(F, dtype=np.int64), (C, F))
    cidx = np.broadcast_to(np.arange(C, dtype=np.int64)[:, None], (C, F))
    cell = 0
    for dy in range(span_y):
        for dx in range(span_x):
            ti = ilo + dy
            tj = jlo + dx
            m = valid & (ti <= ihi) & (tj <= jhi)
            tile_ids.append(ti[m] * tx_n + tj[m])
            face_ids.append(fidx[m])
            cam_ids.append(cidx[m])
            # (cam, face, span cell) of each entry, for the face→slot inverse
            ent_ids.append((cidx[m] * F + fidx[m]) * (span_y * span_x) + cell)
            cell += 1
    tile_id = np.concatenate(tile_ids)
    face_id = np.concatenate(face_ids)
    cam_id = np.concatenate(cam_ids)
    ent_id = np.concatenate(ent_ids)
    key = cam_id * T + tile_id
    counts = np.bincount(key, minlength=C * T).reshape(C, T)
    occ = int(counts.max(initial=0))
    if cap is None:
        cap = suggest_cap(occ, chunk)

    # ymin order within each tile, as the traced binning's
    ymin_b = ymin[cam_id, face_id].astype(np.float32)
    order = np.lexsort((ymin_b, key))
    key_s = key[order]
    face_s = face_id[order]
    starts = np.zeros(C * T + 1, np.int64)
    np.cumsum(counts.reshape(-1), out=starts[1:])
    pos = np.arange(len(key_s)) - starts[key_s]
    keep = pos < cap
    bins = np.full((C * T, cap), -1, np.int32)
    bins[key_s[keep], pos[keep]] = face_s[keep]
    counts = np.minimum(counts, cap).astype(np.int32)
    out = (bins.reshape(C, T, cap), counts.reshape(C, T), occ)
    if return_slots:
        K = span_y * span_x
        fslots = np.full((C, F + 1, K), T * cap, np.int32)
        ent_s = ent_id[order]
        fs_cam = (ent_s // K) // F
        fs_face = (ent_s // K) % F
        fs_cell = ent_s % K
        flat = (key_s % T) * cap + pos
        k3 = keep & (flat < T * cap)
        fslots[fs_cam[k3], fs_face[k3], fs_cell[k3]] = flat[k3]
        out = out[:2] + (fslots, occ)
    if return_spans:
        return out + ((span_y, span_x),)
    return out


# the device binning's static bound on the tiles (y, x) a face spans
DEVICE_BIN_SPAN = (2, 2)


def bin_triangles_device(v_ndc, faces, resolution, cap, margin=0.0,
                         span=DEVICE_BIN_SPAN, cull=False):
    """Device binning of all cameras: the large-F path's mid-run rebins.

    Each face emits ``span_y·span_x`` candidate entries, one per cell of its
    clipped tile range (the driver checks at epoch build that the spans fit
    this static bound).  One stable sort of the keys tile·4096 + ⌊ymin⌋
    per camera orders the entries by tile, then y, then entry; the bins are
    gathered from the sorted faces, and the face→slot inverse is scattered
    back through the sort's permutation.  The result equals the JAX
    package's slot for slot.

    v_ndc (C, V, 4), faces (F, 3) int64, both on one device.  Returns
    (bins (C, T, cap) int64 with −1 padding, counts (C, T) int32 clamped to
    cap, fslots (C, F+1, span_y·span_x) int64 flat slot indices with
    sentinel T·cap, occ: the largest unclamped count, a 0-d device tensor).
    """
    height, width = resolution
    ty_n, tx_n = height // TILE_H, width // TILE_W
    T = ty_n * tx_n
    C = v_ndc.shape[0]
    F = faces.shape[0]
    span_y, span_x = span
    K = span_y * span_x
    dev = v_ndc.device
    tri = v_ndc[:, faces]                                 # (C, F, 3, 4)
    w = tri[..., 3]
    iw = 1.0 / torch.where(w == 0, torch.ones_like(w), w)
    sx = tri[..., 0] * iw
    sy = tri[..., 1] * iw
    valid = torch.all(w > 1e-9, dim=-1)
    area = ((sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0])
            - (sy[..., 1] - sy[..., 0]) * (sx[..., 2] - sx[..., 0]))
    valid &= area > 0.0 if cull else torch.abs(area) >= 1e-12
    exp = 1.0 + margin
    xmin = (sx.amin(-1) + 1.0) * (width / 2.0) - 0.5 - exp
    xmax = (sx.amax(-1) + 1.0) * (width / 2.0) - 0.5 + exp
    ymin = (sy.amin(-1) + 1.0) * (height / 2.0) - 0.5 - exp
    ymax = (sy.amax(-1) + 1.0) * (height / 2.0) - 0.5 + exp
    valid &= (xmax >= 0) & (ymax >= 0) & (xmin <= width - 1) \
        & (ymin <= height - 1)

    def tile_of(a, tile, n):
        # ⌊a⌋ // tile, clipped to the image's tiles; ⌊a⌋ clamped to
        # [−1, n·tile] first, which keeps the result and any float in range
        a = torch.floor(a).clamp(-1.0, float(n * tile)).to(torch.int64)
        return torch.div(a, tile, rounding_mode="floor").clamp(0, n - 1)

    jlo, jhi = tile_of(xmin, TILE_W, tx_n), tile_of(xmax, TILE_W, tx_n)
    ilo, ihi = tile_of(ymin, TILE_H, ty_n), tile_of(ymax, TILE_H, ty_n)
    # ⌊ymin⌋ toward zero, as a float → int32 conversion rounds
    yq = ymin.clamp(0.0, 4095.0).to(torch.int64)

    keys = []
    for dy in range(span_y):
        for dx in range(span_x):
            ti = ilo + dy
            tj = jlo + dx
            live = valid & (ti <= ihi) & (tj <= jhi)
            keys.append(torch.where(live, (ti * tx_n + tj) * 4096 + yq,
                                    T * 4096))            # dead: past every tile
    key = torch.cat(keys, dim=1)                          # (C, K·F)
    key_s, order = torch.sort(key, dim=1, stable=True)
    tile_s = key_s // 4096                                # T for dead
    starts = torch.searchsorted(
        key_s, (torch.arange(T + 1, device=dev) * 4096).expand(C, T + 1)
        .contiguous())
    counts = starts[:, 1:] - starts[:, :-1]
    # bins by gather: slot (t, p) holds the face at sorted position
    # starts[t] + p
    p = torch.arange(cap, device=dev)
    live = p < torch.clamp(counts, max=cap)[..., None]
    src = torch.clamp(starts[:, :T, None] + p, max=K * F - 1)
    fid_s = torch.gather(order, 1, src.reshape(C, -1)).reshape(C, T, cap) % F
    bins = torch.where(live, fid_s, -1)
    # face→slot inverse: entry e (span cell e // F, face e % F) sits at
    # sorted position j with order[j] = e; its flat slot is
    # tile·cap + (j − starts[tile])
    pos = torch.arange(K * F, device=dev) \
        - torch.gather(starts, 1, torch.clamp(tile_s, max=T))
    keep = (tile_s < T) & (pos < cap)
    lin_sorted = torch.where(keep, tile_s * cap + pos, T * cap)
    lin = torch.empty_like(lin_sorted).scatter_(1, order, lin_sorted)
    fslots = torch.cat([lin.reshape(C, K, F).transpose(1, 2),
                        torch.full((C, 1, K), T * cap, dtype=lin.dtype,
                                   device=dev)], dim=1)
    return (bins, torch.clamp(counts, max=cap).to(torch.int32), fslots,
            counts.max())


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


def face_ids(bins, n_faces):
    """The row of :func:`face_sums` that each slot adds into: the slot's face
    id, or the sentinel ``n_faces`` for an empty slot, offset by camera c
    to c·(n_faces + 1).  bins (C, ..., cap) → (C, rest) int64."""
    C = bins.shape[0]
    ids = torch.where(bins >= 0, bins, n_faces).reshape(C, -1)
    return ids + (torch.arange(C, device=bins.device) * (n_faces + 1))[:, None]


def first_half(n_rows, row0=0, rows_image=None, device=None):
    """Whether each of ``n_rows`` tile rows from tile row ``row0`` lies in
    the first half of the image's ``rows_image`` tile rows (by default
    ``n_rows``): (n_rows,) bool on ``device`` (made there: a copy from
    the host would wait for the card), for :func:`face_sums` and
    :func:`slot_face_rows`."""
    rows_image = n_rows if rows_image is None else rows_image
    return (torch.arange(n_rows, device=device) + row0) < rows_image // 2


def face_sums(table18, bins, n_faces, upper=None):
    """The per-(camera, face) sums of the slot rows, a sentinel row a
    camera: (C·(n_faces + 1), 18), the segment sum of ``onehot_scatter``
    over :func:`face_ids`, in a fixed order (the same bits on every run,
    where ``index_add_`` on the card adds in no fixed order): each face's
    slots in the image's first half of tile rows (``upper``, from
    :func:`first_half`; by default the table's first half) added in slot
    order, those in the second half likewise, then the two halves.  A run
    in two row shards adds its halves on two ranks and the same way
    (:func:`_scatter`), so its sums are the unsharded run's bits."""
    C, TY = table18.shape[:2]
    upper = first_half(TY, device=bins.device) if upper is None else upper
    half = (~upper).to(device=bins.device, dtype=torch.int64)
    half = half.reshape(1, TY, *([1] * (bins.dim() - 2))).expand(bins.shape)
    ids = face_ids(bins, n_faces) * 2 + half.reshape(C, -1)
    sums = segment_sum(table18.reshape(-1, 18), ids.reshape(-1),
                       2 * C * (n_faces + 1)).reshape(-1, 2, 18)
    return sums[:, 0] + sums[:, 1]


def scatter_via_faces(table18, bins, incidence, n_faces, n_verts):
    """Slot gradients → vertex gradients through a per-face table.

    table18 (C, TY, TX, cap, 18) from :func:`chain_planes`; bins
    (C, TY, TX, cap); incidence from :func:`build_incidence` as tensors on
    the table's device.  Returns (dv_clip (C, V, 4), d_attrs (V, 3)).
    """
    C = table18.shape[0]
    dface = face_sums(table18, bins, n_faces)
    return _faces_to_vertices(dface.reshape(C, n_faces + 1, 18), incidence)


def slot_face_rows(table18, fslots, upper=None):
    """The per-(camera, face) sums (C, F+1, 18) of the slot rows that each
    face's K slots name (fslots (C, F+1, K) flat slot indices in tile
    order, sentinel T·cap a zero row), in :func:`face_sums`' order: the
    slots in the first half of tile rows (``upper``) in turn, those in the
    second, then the two halves.  In tile order a face's slots in the
    first half come before those in the second, so each half is one run of
    its K slots (a sentinel, a zero row, joins the run it sits in)."""
    C, TY, TX, cap = table18.shape[:4]
    upper = first_half(TY, device=table18.device) if upper is None \
        else upper
    table = table18.reshape(C, -1, 18)
    table = torch.cat([table, table.new_zeros(C, 1, 18)], dim=1)
    Fp1, K = fslots.shape[1:]
    cam = torch.arange(C, device=table.device)[:, None]
    gathered = table[cam, fslots.reshape(C, -1)]            # (C, (F+1)·K, 18)
    row = torch.clamp(fslots // (cap * TX), max=TY - 1)
    up = upper.to(table.device)[row] & (fslots < TY * TX * cap)
    k = torch.arange(1, K + 1, device=table.device)
    n_up = (up * k).amax(dim=2)          # past the face's last upper slot
    lengths = torch.stack([n_up, K - n_up], dim=2).reshape(-1)
    halves = run_sums(gathered.reshape(-1, 18), lengths).reshape(C, Fp1, 2,
                                                                 18)
    return halves[:, :, 0] + halves[:, :, 1]


def scatter_via_slots(table18, fslots, incidence, n_verts):
    """Slot gradients → vertex gradients through the face→slot inverse of
    the bins: each face gathers and sums its K slots' rows
    (:func:`slot_face_rows`).

    table18 (C, TY, TX, cap, 18); fslots (C, F+1, K) flat slot indices with
    sentinel T·cap (a zero row).  Returns (dv_clip (C, V, 4), d_attrs
    (V, 3)).
    """
    return _faces_to_vertices(slot_face_rows(table18, fslots), incidence)


def _faces_to_vertices(dface, incidence):
    """Per-(camera, face) rows [per corner: dx dy dw dA0 dA1 dA2] (C, F+1,
    18) → (dv_clip (C, V, 4) with dz = 0, d_attrs (V, 3)) through the static
    vertex incidence; row F is the padding sentinel."""
    idx, mask = incidence
    C = dface.shape[0]
    per_corner = dface.reshape(C, -1, 6)
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
    """The fused render op of one topology epoch, over all cameras at once.

    ``pipe(v_clip (C, V, 4), attrs (V, 3), bg) → (C, H, W, 4)`` shaded
    images (``(C, H, W, 3)`` with ``shading=False``; pass ``bg=None``).
    Rasterize → interpolate → composite over ``bg`` → antialias, with
    ``boost`` multiplying exactly the antialias position gradients.  One
    ``torch.autograd.Function`` wraps the chain, so bins, records and the
    slot map are built once and shared by the forward and backward kernels.

    With ``prebinned`` the op takes precomputed bins and skips the traced
    binning: ``pipe(v_clip, attrs, bg, bins (C, T, cap), counts (C, T))``,
    and with ``slots_k=K`` also ``fslots (C, F+1, K)``, through which the
    backward gathers each face's slot sums (:func:`scatter_via_slots`; on
    the card one kernel, :func:`kernels.chain_face_rows`).
    The bins take no gradient.

    With a ``mesh`` (:class:`largesteps_torch.parallel.distributed.Mesh`)
    of ``sp > 1`` the pipe renders row shard ``s = mesh.sp_index`` of
    ``mesh.sp`` of every camera, the image's tile rows ``s · TY/sp``
    onward, and swaps the antialias halo rows with the other shards of its
    mesh row (every rank of that row calls the pipe).  ``bg`` and the
    images are the shard's rows; precomputed bins cover the whole image,
    and the pipe slices its rows.
    ``slots_k`` is for unsharded pipes only (as the JAX package's).

    ``ablate`` zeroes backward stages, to time each one's share
    (``benchmarks/bench.py``; JAX's ``make_render_pipeline(ablate=)``):
    ``"aabwd"`` skips aa_bwd (its per-slot sums are zero and the cotangent
    passes through as d_comp), ``"rbwd"`` skips raster_bwd (zero sums),
    ``"scatter"`` still chains the sums but returns zero v and attribute
    gradients.  It is an argument of the constructor only: the training
    path always builds with ``""``.
    """

    def __init__(self, faces, opp, resolution, shading=True, boost=1.0,
                 cap=768, prebinned=False, slots_k=None, ablate="",
                 mesh=None):
        if slots_k is not None and not prebinned:
            raise ValueError("slots_k needs prebinned bins")
        if ablate and ablate not in ABLATE:
            raise ValueError(f"ablate {ablate!r}: '' or one of {ABLATE}")
        self.ablate = ablate
        self.faces = np.ascontiguousarray(np.asarray(faces), dtype=np.int64)
        self.opp = np.ascontiguousarray(np.asarray(opp), dtype=np.int64)
        self.resolution = tuple(resolution)
        self.shading = bool(shading)
        self.boost = float(boost)
        self.cap = int(cap)
        self.prebinned = bool(prebinned)
        self.slots_k = None if slots_k is None else int(slots_k)
        ty_full = self.resolution[0] // TILE_H
        self.mesh = mesh
        self.row_shards = 1 if mesh is None else mesh.sp
        self.row_index = 0 if mesh is None else mesh.sp_index
        if self.row_shards > 1:
            if ty_full % self.row_shards:
                raise ValueError(f"{ty_full} tile rows do not divide into "
                                 f"{self.row_shards} row shards")
            if self.slots_k is not None:
                raise ValueError("slots_k is for unsharded pipes only")
        self.ty = ty_full // self.row_shards      # tile rows of the shard
        self.row0 = self.row_index * self.ty      # its first
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

    def check_bins(self, n_cams, binned):
        """The bins' shapes against this pipe's: (bins, counts[, fslots])."""
        want = 0 if not self.prebinned else 2 + (self.slots_k is not None)
        if len(binned) != want:
            raise ValueError(f"the pipe takes {want} bin tensors, got "
                             f"{len(binned)}")
        if not want:
            return
        h, w = self.resolution
        T = (h // TILE_H) * (w // TILE_W)
        shapes = [(n_cams, T, self.cap), (n_cams, T)]
        if self.slots_k is not None:
            shapes.append((n_cams, len(self.faces) + 1, self.slots_k))
        got = [tuple(b.shape) for b in binned]
        if got != shapes:
            raise ValueError(f"bins of shapes {got}; the pipe takes {shapes}")

    def local_bins(self, bins, counts):
        """The shard's tile rows of whole-image bins (C, T, cap) and counts
        (C, T) (``pallas_core._slice_bin_rows``): the bins stay replicated
        over a mesh row and each shard takes its rows."""
        tx = self.resolution[1] // TILE_W
        rows = slice(self.row0 * tx, (self.row0 + self.ty) * tx)
        return bins[:, rows], counts[:, rows]

    def __call__(self, v_clip, attrs, bg=None, *binned):
        self.check_bins(v_clip.shape[0], binned)
        return _PipelineFn.apply(self, v_clip, attrs, bg, *binned)


def _halo_rows(pipe, fid, z, comp):
    """The down neighbours of the shard's last row, packed (C, W, 2 + D):
    id, depth and colour of the next shard's first row, or of the shard's
    own last row on the last shard (the image's edge replication)."""
    first = torch.cat([fid[:, 0, :, None], z[:, 0, :, None], comp[:, 0]], -1)
    got = pdist.from_next_row_shard(first.contiguous(), pipe.mesh)
    if got is None:
        got = torch.cat([fid[:, -1, :, None], z[:, -1, :, None],
                         comp[:, -1]], -1)
    return got


def _unpack(hrow):
    """The packed halo rows as the kernels take them: (fid, z, colour)."""
    return (hrow[..., 0].contiguous(), hrow[..., 1].contiguous(),
            hrow[..., 2:].contiguous())


def _add_share(pipe, planes, share):
    """Add the previous shard's share row to row 0 of ``planes`` in place;
    every shard sends its own to the next."""
    prev = pdist.to_next_row_shard(share, pipe.mesh)
    if pipe.row_index > 0:
        planes[:, 0] += prev


def _forward_kernels(pipe, rfb, rbb, counts, bg):
    """raster_fwd, composite and aa_fwd: (out, slot, fid, z, comp, cov,
    the packed halo rows of a row shard or None)."""
    res = pipe.resolution
    u, v, z, fid, slot, c0, c1, c2 = kernels.raster_fwd(rfb, counts, res,
                                                        pipe.row0)
    color = torch.stack([c0, c1, c2], dim=-1)
    cov = (fid > 0.0)[..., None]
    if pipe.shading:
        col4 = torch.cat([color, cov.to(color.dtype)], dim=-1)
        comp = torch.where(cov, col4, bg).contiguous()
    else:
        comp = color
    if pipe.row_shards == 1:
        return (kernels.aa_fwd(rbb, counts, fid, z, comp, res), slot, fid, z,
                comp, cov, None)
    hrow = _halo_rows(pipe, fid, z, comp)
    out, share = kernels.aa_fwd(rbb, counts, fid, z, comp, res, pipe.row0,
                                _unpack(hrow))
    _add_share(pipe, out, share)
    return out, slot, fid, z, comp, cov, hrow


def _backward_kernels(pipe, rbb, counts, slot, fid, z, comp, cov, g,
                      hrow=None):
    """aa_bwd and raster_bwd: ([dslot, dslot_aa], the per-slot sums that
    :func:`_chain_scatter` takes, d_comp (C, H, W, D)); ``hrow`` the
    forward's packed halo rows of a row shard."""
    res = pipe.resolution
    g = g.contiguous()
    if pipe.ablate == "aabwd":
        d_comp, dslot_aa = g, rbb.new_zeros((*rbb.shape[:-1], 8))
    elif pipe.row_shards == 1:
        d_comp, dslot_aa = kernels.aa_bwd(rbb, counts, fid, z, comp, g, res)
    else:
        dout_h = pdist.from_next_row_shard(g[:, 0].contiguous(), pipe.mesh)
        if dout_h is None:
            dout_h = g[:, -1].contiguous()
        d_comp, dslot_aa, share = kernels.aa_bwd(
            rbb, counts, fid, z, comp, g, res, pipe.row0,
            _unpack(hrow) + (dout_h,))
        _add_share(pipe, d_comp, share)
    d_color = torch.where(cov, d_comp[..., :3], 0.0) if pipe.shading \
        else d_comp
    if pipe.ablate == "rbwd":
        dslot = torch.zeros_like(rbb)
    else:
        zeros = torch.zeros_like(fid)
        dslot = kernels.raster_bwd(rbb, counts, slot, d_color.contiguous(),
                                   zeros, zeros, res, pipe.row0)
    return [dslot, dslot_aa], d_comp


def _chain_scatter(pipe, sums, rbb, bins, fslots, incidence, n_verts):
    """The per-slot sums chained to clip space and scattered to the
    vertices (span ``pipe_scatter``): (dv_clip, d_attrs) of :func:`_scatter`.
    ``sums`` is emptied once chained, so that its tables (some 1.8 GB at
    nefertiti) are freed before the scatter runs.  A pipe given the
    face→slot inverse on the card chains and sums each face's slots in one
    kernel (:func:`kernels.chain_face_rows`, the bits of
    :func:`slot_face_rows` of :func:`chain_planes`), with no per-slot
    table."""
    with _span("pipe_scatter"):
        if fslots and rbb.is_cuda and pipe.ablate != "scatter":
            # a pipe with fslots is unsharded: its first half is TY // 2 rows
            dface = kernels.chain_face_rows(*sums, pipe.boost, rbb,
                                            fslots[0], pipe.ty // 2)
            sums.clear()
            return _faces_to_vertices(dface, incidence)
        table18 = chain_planes(*sums, pipe.boost, rbb)
        sums.clear()
        return _scatter(pipe, table18, bins, fslots, incidence, n_verts)


def _scatter(pipe, table18, bins, fslots, incidence, n_verts):
    """The chained per-slot table → (dv_clip (C, V, 4), d_attrs (V, 3)):
    the per-face table, through the face→slot inverse where the pipe takes
    one; zeros where the scatter is ablated.  On a row shard the per-face
    table is the shard's half of each face's sums (:func:`face_sums`), and
    :func:`_row_face_table` completes it over the mesh row: every rank
    then holds the whole table, at two shards the unsharded run's bits,
    and the vertex gradients need no reduction over rows."""
    C = table18.shape[0]
    if pipe.ablate == "scatter":
        return (table18.new_zeros((C, n_verts, 4)),
                table18.new_zeros((n_verts, 3)))
    upper = first_half(pipe.ty, pipe.row0, pipe.resolution[0] // TILE_H,
                       table18.device)
    if fslots:
        dface = slot_face_rows(table18, fslots[0], upper)
    else:
        F = pipe.faces.shape[0]
        dface = face_sums(table18, bins, F, upper).reshape(C, F + 1, 18)
    if pipe.row_shards > 1:
        dface = _row_face_table(dface, pipe.mesh)
    return _faces_to_vertices(dface, incidence)


def _row_face_table(dface, mesh):
    """The per-face table of a mesh row from its row shards' parts, added
    in shard order (((d0 + d1) + d2) + ...): the same bits on every rank
    of the row and, at two shards, those of ``d0 + d1`` in any order, the
    unsharded table.  A shard's part is nonzero only on the faces its rows
    draw, so the shards swap those rows, each with its row index, and not
    the table."""
    flat = dface.reshape(-1, 18)
    live = (flat.view(torch.int32) != 0).any(dim=1).nonzero().squeeze(1)
    n = [int(k) for k in pdist.all_gather(
        torch.tensor([live.numel()], device=flat.device), mesh.sp_group)]
    packed = torch.cat([live.to(torch.int32)[:, None],
                        flat[live].view(torch.int32)], dim=1)
    packed = torch.cat([packed, packed.new_zeros(max(n) - len(live), 19)])
    total = None
    for s, (k, got) in enumerate(zip(n, pdist.all_gather(packed,
                                                         mesh.sp_group))):
        part = flat
        if s != mesh.sp_index:
            part = torch.zeros_like(flat)
            part[got[:k, 0].long()] = got[:k, 1:].view(torch.float32)
        total = part if total is None else total + part
    return total.reshape(dface.shape)


def _tiled(pipe, n_cams, *tensors):
    """(C, T, cap, ...) tensors of the pipe's tile rows → (C, TY, TX, cap,
    ...)."""
    tx = pipe.resolution[1] // TILE_W
    return [t.reshape(n_cams, pipe.ty, tx, *t.shape[2:]) for t in tensors]


def _counts3(pipe, counts):
    """counts (C, T) → contiguous int32 (C, TY, TX), as the kernels take."""
    return counts.reshape(counts.shape[0], pipe.ty,
                          pipe.resolution[1] // TILE_W) \
        .to(torch.int32).contiguous()


def _d_bg(d_comp, cov, bg_shape):
    """comp = where(cov, col4, bg): d_bg is d_comp off the surface, summed
    over the dimensions bg was broadcast along."""
    d_bg = torch.where(cov, 0.0, d_comp)
    extra = d_bg.ndim - len(bg_shape)
    return d_bg.sum(dim=tuple(range(extra))) if extra else d_bg


def _halo_or_empty(hrow, like):
    """A packed halo row for save_for_backward (an empty tensor without)."""
    return like.new_empty(0) if hrow is None else hrow


class _PipelineFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pipe, v_clip, attrs, bg, *binned):
        height, width = pipe.resolution
        C = v_clip.shape[0]
        faces, opp, _ = pipe.device_tables(v_clip.device, v_clip.shape[1])
        with _span("pipe_setup"):
            if pipe.prebinned:
                bins, counts = pipe.local_bins(binned[0], binned[1])
                rfb, rbb = setup_from_bins(v_clip, faces, attrs, opp, bins,
                                           height, width)
                rfb, rbb, bins = _tiled(pipe, C, rfb, rbb, bins)
                counts = _counts3(pipe, counts)
            else:
                rfb, rbb, bins, counts = setup_and_bin(
                    v_clip, faces, attrs, opp, height, width, pipe.cap,
                    (pipe.row0, pipe.ty))
        out, slot, fid, z, comp, cov, hrow = _forward_kernels(
            pipe, rfb, rbb, counts, bg)
        ctx.pipe = pipe
        ctx.n_verts = v_clip.shape[1]
        ctx.n_binned = len(binned)
        ctx.bg_shape = None if bg is None else bg.shape
        fslots = binned[2:3]
        ctx.save_for_backward(rbb, bins, counts, slot, fid, z, comp, cov,
                              _halo_or_empty(hrow, fid), *fslots)
        return out

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        rbb, bins, counts, slot, fid, z, comp, cov, hrow, *fslots = \
            ctx.saved_tensors
        sums, d_comp = _backward_kernels(pipe, rbb, counts, slot, fid, z,
                                         comp, cov, g, hrow)
        _, _, incidence = pipe.device_tables(rbb.device, ctx.n_verts)
        dv_clip, d_attrs = _chain_scatter(pipe, sums, rbb, bins, fslots,
                                          incidence, ctx.n_verts)
        d_bg = None
        if ctx.bg_shape is not None and ctx.needs_input_grad[3]:
            d_bg = _d_bg(d_comp, cov, ctx.bg_shape)
        return (None, dv_clip, d_attrs, d_bg) + (None,) * ctx.n_binned


class RenderPipelineBig(RenderPipeline):
    """The camera-sequential prebinned render op
    (``pallas_core.make_render_pipeline_big``): the contract of
    ``RenderPipeline(..., prebinned=True)``, run one camera at a time
    through the four kernels (C = 1), so the binned tables of one camera are
    alive at a time.  The backward rebuilds each camera's backward records
    from the bins (``setup_from_bins(..., need_fwd=False)``) rather than
    keeping them, and chains and scatters per camera.  Row shards as
    :class:`RenderPipeline`'s."""

    def __init__(self, faces, opp, resolution, shading=True, boost=1.0,
                 cap=8192, slots_k=None, ablate="", mesh=None):
        super().__init__(faces, opp, resolution, shading=shading,
                         boost=boost, cap=cap, prebinned=True,
                         slots_k=slots_k, ablate=ablate, mesh=mesh)

    def __call__(self, v_clip, attrs, bg=None, *binned):
        self.check_bins(v_clip.shape[0], binned)
        return _BigFn.apply(self, v_clip, attrs, bg, *binned)


def _per_camera_bg(bg, i, n_cams):
    return bg[i:i + 1] if bg.ndim == 4 and bg.shape[0] == n_cams else bg


class _BigFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pipe, v_clip, attrs, bg, *binned):
        height, width = pipe.resolution
        C = v_clip.shape[0]
        faces, opp, _ = pipe.device_tables(v_clip.device, v_clip.shape[1])
        bins, counts = pipe.local_bins(*binned[:2])
        per_cam = []
        for i in range(C):
            with _span("pipe_setup"):
                rfb, rbb = setup_from_bins(v_clip[i:i + 1], faces, attrs,
                                           opp, bins[i:i + 1], height, width)
                rfb, rbb = _tiled(pipe, 1, rfb, rbb)
            bg_i = None if bg is None else _per_camera_bg(bg, i, C)
            per_cam.append(_forward_kernels(pipe, rfb, rbb,
                                            _counts3(pipe, counts[i:i + 1]),
                                            bg_i))
        out, slot, fid, z, comp, cov = (torch.cat([p[k] for p in per_cam])
                                        for k in range(6))
        hrow = None if pipe.row_shards == 1 \
            else torch.cat([p[6] for p in per_cam])
        ctx.pipe = pipe
        ctx.n_binned = len(binned)
        ctx.bg_shape = None if bg is None else bg.shape
        ctx.save_for_backward(v_clip, attrs, slot, fid, z, comp, cov,
                              _halo_or_empty(hrow, fid), *binned)
        return out

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        height, width = pipe.resolution
        (v_clip, attrs, slot, fid, z, comp, cov, hrow, bins, counts,
         *fslots) = ctx.saved_tensors
        bins, counts = pipe.local_bins(bins, counts)
        C, V = v_clip.shape[:2]
        faces, opp, incidence = pipe.device_tables(v_clip.device, V)
        dv_clip = torch.empty_like(v_clip)
        d_attrs = torch.zeros_like(attrs)
        d_comp = torch.empty_like(comp)
        for i in range(C):
            one = slice(i, i + 1)
            with _span("pipe_setup"):
                _, rbb = setup_from_bins(v_clip[one], faces, attrs, opp,
                                         bins[one], height, width,
                                         need_fwd=False)
                rbb, = _tiled(pipe, 1, rbb)
            sums, d_comp[one] = _backward_kernels(
                pipe, rbb, _counts3(pipe, counts[one]), slot[one], fid[one],
                z[one], comp[one], cov[one], g[one],
                hrow[one] if pipe.row_shards > 1 else None)
            bins4, = _tiled(pipe, 1, bins[one])
            dv1, da1 = _chain_scatter(pipe, sums, rbb, bins4,
                                      [fs[one] for fs in fslots], incidence,
                                      V)
            dv_clip[i] = dv1[0]
            d_attrs += da1
        d_bg = None
        if ctx.bg_shape is not None and ctx.needs_input_grad[3]:
            d_bg = _d_bg(d_comp, cov, ctx.bg_shape)
        return (None, dv_clip, d_attrs, d_bg) + (None,) * ctx.n_binned
