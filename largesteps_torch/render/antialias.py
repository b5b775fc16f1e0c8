"""Analytic silhouette-edge antialiasing (nvdiffrast's ``antialias``), dense
and compacted, and the edge adjacency it needs.

Port of ``largesteps_tpu/render/antialias.py``, the JAX package's
``backend="xla"`` path; the tile path antialiases in the CUDA kernels of
:mod:`largesteps_torch.render.kernels`.  For every pair of adjacent pixels
(right and up neighbours) whose face ids differ, the owner is the nearer
face (the background at +inf); the owner's first silhouette edge that
crosses the segment between the two pixel centres gives the crossing t,
and colour blends across the pair by how far t lies from the midpoint.
Every discrete choice (pair, owner, edge, ``separates & within``) is
detached; only t keeps its gradient, to the edge's two endpoints, where
``pos_gradient_boost`` multiplies it.

:func:`antialias` evaluates only the pairs whose ids differ, compacted
into ``cap`` slots a camera in pair order, lowest pair index first with all
horizontal pairs before the vertical ones: the order of JAX's stable
argsort, here by a running count of the differing pairs, which needs no
sort and so no sort's stability on the card.  Pairs past ``cap`` are
dropped, the same ones JAX drops.  :func:`antialias_dense` evaluates every
pair and needs no capacity.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.segment import segment_sum
from .raster import _faces_tensor, pixel_grid

__all__ = ["antialias", "antialias_dense", "face_adjacency"]

BIG = 3.4e38


def face_adjacency(faces) -> np.ndarray:
    """For each face edge e = (f[e], f[(e+1)%3]), the index of the face
    sharing that undirected edge (the lowest other index), or −1 on a
    boundary.  Host, once per topology."""
    faces = np.asarray(faces)
    F = faces.shape[0]
    edge_map: dict = {}
    for fi in range(F):
        for e in range(3):
            a, b = int(faces[fi, e]), int(faces[fi, (e + 1) % 3])
            key = (a, b) if a < b else (b, a)
            edge_map.setdefault(key, []).append(fi)
    opp = np.full((F, 3), -1, dtype=np.int32)
    for fi in range(F):
        for e in range(3):
            a, b = int(faces[fi, e]), int(faces[fi, (e + 1) % 3])
            key = (a, b) if a < b else (b, a)
            for other in edge_map[key]:
                if other != fi:
                    opp[fi, e] = other
                    break
    return opp


def _boost(x, factor):
    """Identity in the forward pass; multiplies the gradient by ``factor``."""
    if factor == 1.0:
        return x
    return x.detach() + factor * (x - x.detach())


def _take(table, idx):
    """table (C, V, ...) rows at idx (C, N...) → (C, N..., ...), by indexing:
    its gradient adds in a fixed order on the card, where
    ``torch.gather``'s adds with atomics."""
    cam = torch.arange(idx.shape[0], device=idx.device)
    flat = idx.reshape(idx.shape[0], -1)
    return table[cam[:, None], flat].reshape(*idx.shape, *table.shape[2:])


def _pair_corrections(color_a, color_b, rast_a, rast_b, pa, pb, v_clip,
                      faces, opp):
    """Corrections (delta_a, delta_b) for one array of adjacent pixel pairs.

    color_* (C, N, D); rast_* (C, N, 4); pa, pb (..., N, 2) NDC pixel
    centres, broadcast against the cameras; v_clip (C, V, 4); faces and opp
    (F, 3) int64.  Shared by the compacted and the dense path.
    """
    id_a = rast_a[..., 3].detach().to(torch.int64)
    id_b = rast_b[..., 3].detach().to(torch.int64)
    differs = id_a != id_b

    # the occluder: the non-background pixel, or the nearer depth if both
    # are covered (the background at +inf)
    da = torch.where(id_a > 0, rast_a[..., 2].detach(), BIG)
    db = torch.where(id_b > 0, rast_b[..., 2].detach(), BIG)
    owner_is_a = da <= db
    owner_id = torch.where(owner_is_a, id_a, id_b)       # 1-based
    other_id = torch.where(owner_is_a, id_b, id_a)
    tri = torch.clamp(owner_id - 1, min=0)               # (C, N) 0-based

    fverts = faces[tri]                                  # (C, N, 3)
    fopp = opp[tri]
    w = v_clip[..., 3]
    safe_w = torch.where(w == 0, 1.0, w)
    sx = v_clip[..., 0] / safe_w                         # (C, V)
    sy = v_clip[..., 1] / safe_w
    w_ok = w.detach() > 1e-9
    pax, pay = pa[..., 0], pa[..., 1]
    pbx, pby = pb[..., 0], pb[..., 1]

    best_valid = torch.zeros(tri.shape, dtype=torch.bool, device=tri.device)
    best_t = torch.zeros(tri.shape, dtype=v_clip.dtype, device=tri.device)
    for e in range(3):
        va = fverts[..., e]
        vb = fverts[..., (e + 1) % 3]
        ax, ay = _take(sx, va), _take(sy, va)
        bx, by = _take(sx, vb), _take(sy, vb)
        ex, ey = bx - ax, by - ay
        # the signed edge function at both pixel centres
        ea = ex * (pay - ay) - ey * (pax - ax)
        eb = ex * (pby - ay) - ey * (pbx - ax)
        separates = (ea > 0) != (eb > 0)
        denom = ea - eb
        t = ea / torch.where(denom == 0, 1.0, denom)
        # the crossing point must lie on the edge segment
        with torch.no_grad():
            cx = pax + t * (pbx - pax)
            cy = pay + t * (pby - pay)
            along = (cx - ax) * ex + (cy - ay) * ey
            within = (along >= 0) & (along <= ex * ex + ey * ey)
        # silhouette: the face across the edge is not the other pixel's.  A
        # background other pixel (other_id 0) always qualifies: its 0-based
        # id (−1) must not match the boundary marker −1
        silhouette = (other_id == 0) | (fopp[..., e] != (other_id - 1))
        valid = separates & within & silhouette \
            & _take(w_ok, va) & _take(w_ok, vb)
        take = valid & ~best_valid
        best_t = torch.where(take, t, best_t)
        best_valid = best_valid | valid

    active = differs & (owner_id > 0) & best_valid
    t = best_t
    # blend weights: a crossing past the pair's midpoint covers the far pixel
    wa = torch.where(t.detach() < 0.5, 0.5 - t, 0.0)
    wb = torch.where(t.detach() >= 0.5, t - 0.5, 0.0)
    diff = color_b - color_a
    delta_a = torch.where(active[..., None], wa[..., None] * diff, 0.0)
    delta_b = torch.where(active[..., None], -wb[..., None] * diff, 0.0)
    return delta_a, delta_b


def _auto_cap(n_pairs: int) -> int:
    """Default boundary-pair capacity: silhouettes are O(perimeter), so an
    eighth of all pairs is a generous bound; the floor keeps small images
    exact."""
    cap = max(2048, n_pairs // 8)
    return min(n_pairs, ((cap + 511) // 512) * 512)


def antialias(color, rast, v_clip, faces, opp, pos_gradient_boost=1.0,
              cap=None):
    """Antialias ``color`` (C, H, W, D) given the rasterizer's output
    (C, H, W, 4) and the clip positions (C, V, 4).  Returns (C, H, W, D).

    Only the pairs whose ids differ are evaluated, at most ``cap`` a camera
    (default :func:`_auto_cap`); the output equals :func:`antialias_dense`'s
    whenever every camera's count fits.
    """
    dev = color.device
    faces, opp = _faces_tensor(faces, dev), _faces_tensor(opp, dev)
    C, H, W, D = color.shape
    n_h = H * (W - 1)
    n_v = (H - 1) * W
    n_pairs = n_h + n_v
    cap = min(_auto_cap(n_pairs) if cap is None else int(cap), n_pairs)
    px, py = pixel_grid(H, W, dev, color.dtype)
    xs, ys = px[0], py[:, 0]

    # pair p ↦ (flat_a, flat_b) pixel indices: horizontal pairs first, row
    # r column c ↔ (r, c+1), then vertical (r, c) ↔ (r+1, c)
    rr, cc = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W - 1, device=dev), indexing="ij")
    a_h = (rr * W + cc).reshape(-1)
    rr, cc = torch.meshgrid(torch.arange(H - 1, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    a_v = (rr * W + cc).reshape(-1)
    flat_a = torch.cat([a_h, a_v])
    flat_b = torch.cat([a_h + 1, a_v + W])

    vb = _boost(v_clip, pos_gradient_boost)
    col_f = color.reshape(C, H * W, D)
    rst_f = rast.reshape(C, H * W, 4)
    tid = rst_f[..., 3].detach().to(torch.int64)
    differs = tid[:, flat_a] != tid[:, flat_b]            # (C, n_pairs)
    # compact: the k-th differing pair of a camera (in pair order) goes to
    # slot k, if k < cap; the other slots hold pair 0, invalid
    rank = torch.cumsum(differs, dim=1) - 1
    keep = differs & (rank < cap)
    cams = torch.arange(C, device=dev)[:, None].expand_as(rank)
    slot = (cams * cap + rank)[keep]
    sel = torch.zeros(C * cap, dtype=torch.int64, device=dev)
    sel[slot] = torch.arange(n_pairs, device=dev).expand_as(rank)[keep]
    valid = torch.zeros(C * cap, dtype=torch.bool, device=dev)
    valid[slot] = True
    sel, valid = sel.reshape(C, cap), valid.reshape(C, cap)
    pa_idx, pb_idx = flat_a[sel], flat_b[sel]

    pa = torch.stack([xs[pa_idx % W], ys[pa_idx // W]], dim=-1)
    pb = torch.stack([xs[pb_idx % W], ys[pb_idx // W]], dim=-1)
    delta_a, delta_b = _pair_corrections(
        _take(col_f, pa_idx), _take(col_f, pb_idx), _take(rst_f, pa_idx),
        _take(rst_f, pb_idx), pa, pb, vb, faces, opp)
    delta_a = torch.where(valid[..., None], delta_a, 0.0)
    delta_b = torch.where(valid[..., None], delta_b, 0.0)

    # a segment sum (a fixed order on the card) of the corrections, the
    # a-sides' then the b-sides', each in slot order; padded and invalid
    # slots go to a spare row per camera, cut off afterwards
    base = (torch.arange(C, device=dev) * (H * W + 1))[:, None]
    tgt_a = (torch.where(valid, pa_idx, H * W) + base).reshape(-1)
    tgt_b = (torch.where(valid, pb_idx, H * W) + base).reshape(-1)
    delta = segment_sum(torch.cat([delta_a.reshape(-1, D),
                                   delta_b.reshape(-1, D)]),
                        torch.cat([tgt_a, tgt_b]), C * (H * W + 1))
    out = col_f + delta.reshape(C, H * W + 1, D)[:, :H * W]
    return out.reshape(C, H, W, D)


def antialias_dense(color, rast, v_clip, faces, opp, pos_gradient_boost=1.0):
    """Every adjacent pair evaluated: the capacity-free reference of
    :func:`antialias`.  Same arguments, no ``cap``."""
    dev = color.device
    faces, opp = _faces_tensor(faces, dev), _faces_tensor(opp, dev)
    C, H, W, D = color.shape
    centres = torch.stack(pixel_grid(H, W, dev, color.dtype), dim=-1)
    vb = _boost(v_clip, pos_gradient_boost)
    pad = torch.nn.functional.pad

    def pairs(sl_a, sl_b):
        ca, cb = color[sl_a], color[sl_b]
        shape = ca.shape[:-1]
        da, db = _pair_corrections(
            ca.reshape(C, -1, D), cb.reshape(C, -1, D),
            rast[sl_a].reshape(C, -1, 4), rast[sl_b].reshape(C, -1, 4),
            centres[sl_a[1:]].reshape(-1, 2), centres[sl_b[1:]].reshape(-1, 2),
            vb, faces, opp)
        return da.reshape(*shape, D), db.reshape(*shape, D)

    every = slice(None)
    # horizontal pairs: (i, j) ↔ (i, j+1)
    da, db = pairs((every, every, slice(None, -1)), (every, every, slice(1, None)))
    out = color + pad(da, (0, 0, 0, 1)) + pad(db, (0, 0, 1, 0))
    # vertical pairs: (i, j) ↔ (i+1, j)
    da, db = pairs((every, slice(None, -1)), (every, slice(1, None)))
    return out + pad(da, (0, 0, 0, 0, 0, 1)) + pad(db, (0, 0, 0, 0, 1, 0))
