"""The four per-tile kernels of the render pipeline and the prebinned pipe's
forward setup and backward glue, each beside its plain PyTorch version.

===============  ==========================================  ========================
wrapper          replaces (``largesteps_tpu/render/...``)    CUDA source
===============  ==========================================  ========================
raster_fwd       ``pallas_core.py:raster_fwd_pallas``        ``csrc/raster_fwd.cu``
aa_fwd           ``pallas_core.py:aa_fwd_pallas``            ``csrc/aa_fwd.cu``
raster_bwd       ``pallas_core.py:raster_bwd_pallas``        ``csrc/raster_bwd.cu``
aa_bwd           ``pallas_core.py:aa_bwd_pallas``            ``csrc/aa_bwd.cu``
chain_face_rows  no Pallas kernel: ``pallas_core.py``'s       ``csrc/chain_face_rows.cu``
                 ``_chain_planes`` and ``_scatter_via_slots``
setup_slots      no Pallas kernel: ``pallas_core.py``'s       ``csrc/setup_slots.cu``
                 ``setup_from_bins``
===============  ==========================================  ========================

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain version (``*_plain``, same signature and layout), a CUDA tensor to
the hand-written kernel, which raises if it cannot build or launch.  Each
kernel launch adds one to ``LAUNCHES[name]``; the plain versions count
nothing.  The plain versions loop over chunks of bin slots, so their memory
stays bounded at any ``cap``, and they repeat the kernels' arithmetic
operation for operation (the kernels are built with ``-fmad=false``).

Layouts are the JAX package's: records (C, TY, TX, cap, 32), counts
(C, TY, TX) int32, planes (C, H, W) float32 with row 0 at the image bottom,
32×128 pixel tiles.

Row shards (``pallas_core.py``'s ``row0`` and ``halo``): every kernel takes
``row0``, the first tile row of its planes in an image of ``resolution``
(the whole image's), so that a rank holding TY of its tile rows computes
global pixel centres; its planes are (C, TY·32, W).  The antialias kernels
also take ``halo``: the first row of the next row shard's planes (on the
last shard, the shard's own last row, which is the image's edge
replication).  A vertical pair anchored at the shard's last row reads its
neighbour there, and its share of the neighbour's colour (or cotangent) is
returned as one more (C, W, D) row, which the caller adds to the next
shard's row 0 (``_shift_down_ch_halo``).  The pair anchored below a
shard's row 0 is the previous shard's: its share arrives that way.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["raster_fwd", "raster_fwd_plain", "raster_bwd",
           "raster_bwd_plain", "aa_fwd", "aa_fwd_plain", "aa_bwd",
           "aa_bwd_plain", "chain_face_rows", "chain_face_rows_plain",
           "setup_slots", "setup_slots_plain", "LAUNCHES", "TILE_KERNELS",
           "TILE_H", "TILE_W", "BIG"]

BIG = 3.4e38
TILE_H = 32
TILE_W = 128
_P = TILE_H * TILE_W
_CHUNK = 16            # bin slots per step of the plain versions' loops

TILE_KERNELS = ("raster_fwd", "aa_fwd", "raster_bwd", "aa_bwd")
LAUNCHES = {**dict.fromkeys(TILE_KERNELS, 0), "chain_face_rows": 0,
            "setup_slots": 0}


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _scales(resolution):
    """float32 NDC pixel pitch (2/W, 2/H), as the kernels receive it."""
    return _pitch(*resolution)


@functools.lru_cache(maxsize=64)
def _pitch(height, width):
    return float(np.float32(2.0 / width)), float(np.float32(2.0 / height))


def _pixel_coords(ty, tx, resolution, device, row0=0):
    """NDC pixel centres in tile layout: (px, py), each (TY, TX, P), of the
    TY tile rows from tile row ``row0``."""
    sxs, sys_ = _scales(resolution)
    p = torch.arange(_P, device=device)
    col = (p % TILE_W).to(torch.float32)
    row = (p // TILE_W).to(torch.float32)
    tx0 = (torch.arange(tx, device=device) * TILE_W).to(torch.float32)
    ty0 = ((torch.arange(ty, device=device) + row0) * TILE_H) \
        .to(torch.float32)
    px = ((tx0[None, :, None] + col) + 0.5) * sxs - 1.0
    py = ((ty0[:, None, None] + row) + 0.5) * sys_ - 1.0
    return px.expand(ty, tx, _P), py.expand(ty, tx, _P)


def _to_tiles(x):
    """(C, H, W[, D]) → (C, TY, TX, P[, D])."""
    C, H, W = x.shape[:3]
    rest = x.shape[3:]
    t = x.reshape(C, H // TILE_H, TILE_H, W // TILE_W, TILE_W, *rest)
    t = t.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
    return t.reshape(C, H // TILE_H, W // TILE_W, _P, *rest)


def _from_tiles(t):
    """(C, TY, TX, P[, D]) → (C, H, W[, D])."""
    C, ty, tx = t.shape[:3]
    rest = t.shape[4:]
    x = t.reshape(C, ty, tx, TILE_H, TILE_W, *rest)
    x = x.permute(0, 1, 3, 2, 4, *range(5, 5 + len(rest)))
    return x.reshape(C, ty * TILE_H, tx * TILE_W, *rest)


def _gather_slots(rec, slot, cols):
    """rec (C, TY, TX, cap, 32) rows at ``slot`` (C, TY, TX, P) int64, the
    columns ``cols``; zeros where slot < 0 → (C, TY, TX, P, len(cols))."""
    sub = rec[..., cols]
    idx = torch.clamp(slot, min=0)[..., None].expand(*slot.shape, len(cols))
    out = torch.gather(sub, 3, idx)
    return torch.where((slot >= 0)[..., None], out, 0.0)


def _shift_left(x):
    """Right-neighbour values (edge-replicated) of (C, H, W[, D])."""
    return torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)


def _shift_up(x, halo=None):
    """Down-neighbour values (edge-replicated; row 0 is the image bottom);
    with ``halo`` (C, W[, D]) the last row's neighbours are the halo row."""
    last = x[:, -1:] if halo is None else halo[:, None]
    return torch.cat([x[:, 1:], last], dim=1)


def _shift_right_ch(x):
    """Push values one pixel toward larger column index (zero fill)."""
    return torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]], dim=2)


def _shift_down_ch(x):
    """Push values one row toward larger row index (zero fill)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _device_kind(*tensors) -> str:
    if all(t.is_cuda for t in tensors):     # the fast answer on the card
        return "cuda"
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: {kinds}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def _check_cuda_inputs(name, **tensors):
    for arg, t in tensors.items():
        want = torch.int32 if arg == "counts" else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {want} "
                             f"tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")


def _check_rows(name, ty, row0, resolution):
    """The TY tile rows from ``row0`` lie in the image of ``resolution``."""
    if row0 < 0 or (row0 + ty) * TILE_H > resolution[0]:
        raise ValueError(f"{name}: tile rows {row0}..{row0 + ty - 1} are "
                         f"not in an image of height {resolution[0]}")


def _check_aligned(name, *tensors):
    """The raster kernels read records 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: records must be 16-byte aligned")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# 1. rasterize + interpolate (forward)
# ---------------------------------------------------------------------------

def raster_fwd(rec_fwd_b, counts_b, resolution, row0=0):
    """Z-buffered rasterization and perspective-correct interpolation over
    per-tile bins.  rec_fwd_b (C, TY, TX, cap, 32), counts_b (C, TY, TX)
    int32, of the TY tile rows from ``row0``.  Returns (u, v, z, fid, slot,
    col0, col1, col2), each (C, TY·32, W): z = z/w, fid 1-based (0 =
    background), slot −1 on background."""
    if _device_kind(rec_fwd_b, counts_b) == "cpu":
        return raster_fwd_plain(rec_fwd_b, counts_b, resolution, row0)
    from .. import _cuda
    _check_cuda_inputs("raster_fwd", rec=rec_fwd_b, counts=counts_b)
    _check_aligned("raster_fwd", rec_fwd_b)
    C, ty, tx, cap, _ = rec_fwd_b.shape
    _check_rows("raster_fwd", ty, row0, resolution)
    height, width = ty * TILE_H, resolution[1]
    out = torch.empty((8, C, height, width), dtype=torch.float32,
                      device=rec_fwd_b.device)
    sxs, sys_ = _scales(resolution)
    err = _cuda.library("raster_fwd")(
        rec_fwd_b.data_ptr(), counts_b.data_ptr(), out.data_ptr(),
        C, ty, tx, cap, height, width, int(row0), sxs, sys_, _stream())
    _cuda.check("raster_fwd", err)
    LAUNCHES["raster_fwd"] += 1
    return tuple(out.unbind(0))


def raster_fwd_plain(rec_fwd_b, counts_b, resolution, row0=0):
    """Plain PyTorch version of :func:`raster_fwd`."""
    C, ty, tx, cap, _ = rec_fwd_b.shape
    dev = rec_fwd_b.device
    _check_rows("raster_fwd", ty, row0, resolution)
    px, py = _pixel_coords(ty, tx, resolution, dev, row0)
    pxe, pye = px[None, :, :, None, :], py[None, :, :, None, :]
    counts = counts_b.to(torch.int64)
    zb = torch.full((C, ty, tx, _P), BIG, dtype=torch.float32, device=dev)
    fb = torch.full_like(zb, BIG)
    sb = torch.full_like(zb, -1.0)
    n = min(int(counts.max()) if counts.numel() else 0, cap)
    for j0 in range(0, n, _CHUNK):
        j1 = min(j0 + _CHUNK, n)
        r = rec_fwd_b[:, :, :, j0:j1]
        c = lambda k: r[..., k, None]                  # (C, TY, TX, ch, 1)
        q0 = c(0) * pxe + c(1) * pye + c(2)
        q1 = c(3) * pxe + c(4) * pye + c(5)
        s = c(6) * pxe + c(7) * pye + c(8)
        d = c(9) * pxe + c(10) * pye + c(11)
        q2 = s - q0 - q1
        slots = torch.arange(j0, j1, device=dev)
        live = (slots < counts[..., None])[..., None]
        cov = (q0 >= 0.0) & (q1 >= 0.0) & (q2 >= 0.0) & (s > 0.0) \
            & (d < BIG) & live
        dm = torch.where(cov, d, BIG)
        m = dm.amin(dim=3)
        fid = c(14)
        fidw = torch.where(dm == m[:, :, :, None], fid, BIG).amin(dim=3)
        slot_f = slots.to(torch.float32)[:, None]
        slotw = torch.where((dm == m[:, :, :, None])
                            & (fid == fidw[:, :, :, None]),
                            slot_f, BIG).amin(dim=3)
        closer = (m < zb) | ((m == zb) & (fidw < fb) & (m < BIG))
        zb = torch.where(closer, m, zb)
        fb = torch.where(closer, fidw, fb)
        sb = torch.where(closer, slotw, sb)
    f = _gather_slots(rec_fwd_b, sb.to(torch.int64), list(range(25)))
    g = lambda k: f[..., k]
    q0 = g(0) * px + g(1) * py + g(2)
    q1 = g(3) * px + g(4) * py + g(5)
    s = g(6) * px + g(7) * py + g(8)
    inv_s = 1.0 / torch.where(s == 0.0, 1.0, s)
    u = q0 * inv_s
    v = q1 * inv_s
    covered = sb >= 0.0
    planes = (u, v, torch.where(covered, zb, 0.0), g(14), sb,
              u * g(16) + v * g(17) + g(18),
              u * g(19) + v * g(20) + g(21),
              u * g(22) + v * g(23) + g(24))
    return tuple(_from_tiles(p) for p in planes)


# ---------------------------------------------------------------------------
# 3. rasterize + interpolate (backward)
# ---------------------------------------------------------------------------

def raster_bwd(rec_bwd_b, counts_b, slot, d_col, d_u, d_v, resolution,
               row0=0):
    """Per-(camera, tile, slot) sums of the 18 analytic gradients of
    (u, v, colour) with respect to the owner's screen xy ×3, inverse w ×3
    and corner attributes ×9, over the TY tile rows from ``row0``.  slot
    (C, TY·32, W) float (−1 = background), d_col (C, TY·32, W, 3), d_u and
    d_v (C, TY·32, W).  Returns (C, TY, TX, cap, 32) with columns 0-17 =
    [dsx0 dsy0 dsx1 dsy1 dsx2 dsy2 diw0 diw1 diw2 dA00 .. dA22] and 18-31
    zero."""
    if _device_kind(rec_bwd_b, counts_b, slot, d_col, d_u, d_v) == "cpu":
        return raster_bwd_plain(rec_bwd_b, counts_b, slot, d_col, d_u, d_v,
                                resolution, row0)
    from .. import _cuda
    _check_cuda_inputs("raster_bwd", rec=rec_bwd_b, counts=counts_b,
                       slot=slot, d_col=d_col, d_u=d_u, d_v=d_v)
    _check_aligned("raster_bwd", rec_bwd_b)
    C, ty, tx, cap, _ = rec_bwd_b.shape
    _check_rows("raster_bwd", ty, row0, resolution)
    height, width = ty * TILE_H, resolution[1]
    # the kernel writes every element (zeros, then each slot's sums once)
    out = torch.empty((C, ty, tx, cap, 32), dtype=torch.float32,
                      device=rec_bwd_b.device)
    sxs, sys_ = _scales(resolution)
    err = _cuda.library("raster_bwd")(
        rec_bwd_b.data_ptr(), slot.data_ptr(), d_col.data_ptr(),
        d_u.data_ptr(), d_v.data_ptr(), out.data_ptr(),
        C, ty, tx, cap, height, width, int(row0), sxs, sys_, _stream())
    _cuda.check("raster_bwd", err)
    LAUNCHES["raster_bwd"] += 1
    return out


def _raster_bwd_fields(f, px, py, dc0, dc1, dc2, du_in, dv_in):
    """The 18 per-pixel gradient fields (``pallas_core.py:1070-1101``)."""
    g = lambda k: f[..., k]
    b0 = g(0) * px + g(1) * py + g(2)
    b1 = g(3) * px + g(4) * py + g(5)
    iw0, iw1, iw2 = g(6), g(7), g(8)
    du = dc0 * g(16) + dc1 * g(18) + dc2 * g(20) + du_in
    dv = dc0 * g(17) + dc1 * g(19) + dc2 * g(21) + dv_in
    b2 = 1.0 - b0 - b1
    s = b0 * iw0 + b1 * iw1 + b2 * iw2
    inv_s = 1.0 / torch.where(s == 0.0, 1.0, s)
    u = b0 * iw0 * inv_s
    v = b1 * iw1 * inv_s
    w2 = torch.where(s == 0.0, 0.0, 1.0 - u - v)
    h = du * u + dv * v
    db0 = (du * iw0 - h * (iw0 - iw2)) * inv_s
    db1 = (dv * iw1 - h * (iw1 - iw2)) * inv_s
    diw0 = b0 * (du - h) * inv_s
    diw1 = b1 * (dv - h) * inv_s
    diw2 = -h * b2 * inv_s
    inva = g(15)
    g0 = db0 * inva
    g1 = db1 * inva
    garea = -(b0 * db0 + b1 * db1) * inva
    sx0, sy0, sx1, sy1, sx2, sy2 = (g(9), g(10), g(11), g(12), g(13), g(14))
    return torch.stack([
        g1 * (py - sy2) + garea * (sy1 - sy2),
        g1 * (sx2 - px) + garea * (sx2 - sx1),
        g0 * (sy2 - py) + garea * (sy2 - sy0),
        g0 * (px - sx2) + garea * (sx0 - sx2),
        g0 * (py - sy1) + g1 * (sy0 - py) + garea * (sy0 - sy1),
        g0 * (sx1 - px) + g1 * (px - sx0) + garea * (sx1 - sx0),
        diw0, diw1, diw2,
        dc0 * u, dc1 * u, dc2 * u,
        dc0 * v, dc1 * v, dc2 * v,
        dc0 * w2, dc1 * w2, dc2 * w2,
    ], dim=-1)


def raster_bwd_plain(rec_bwd_b, counts_b, slot, d_col, d_u, d_v, resolution,
                     row0=0):
    """Plain PyTorch version of :func:`raster_bwd`."""
    C, ty, tx, cap, _ = rec_bwd_b.shape
    dev = rec_bwd_b.device
    _check_rows("raster_bwd", ty, row0, resolution)
    px, py = _pixel_coords(ty, tx, resolution, dev, row0)
    st = _to_tiles(slot).to(torch.int64)
    dct = _to_tiles(d_col)
    f = _gather_slots(rec_bwd_b, st, list(range(22)))
    G = _raster_bwd_fields(f, px, py, dct[..., 0], dct[..., 1], dct[..., 2],
                           _to_tiles(d_u), _to_tiles(d_v))
    tile = torch.arange(C * ty * tx, device=dev).reshape(C, ty, tx, 1)
    covered = st >= 0
    flat = (tile * cap + st)[covered]
    out = torch.zeros((C * ty * tx * cap, 18), dtype=torch.float32,
                      device=dev)
    out.index_add_(0, flat, G[covered])
    out = out.reshape(C, ty, tx, cap, 18)
    return torch.cat([out, torch.zeros_like(out[..., :14])], dim=-1)


# ---------------------------------------------------------------------------
# 2./4. antialias (nvdiffrast semantics), forward and backward
# ---------------------------------------------------------------------------
# For each right and down pixel pair whose face ids differ, the owner is the
# nearer face (background at +inf).  The owner's first silhouette edge that
# crosses the segment between the pixel centres gives the crossing t, and
# colour blends across the pair by t.  Only t is differentiable, through the
# edge functions, to the edge's two endpoints.  The last row and column pair
# with themselves (edge-replicated neighbours), so they never pair.

_AA_COLS = [9, 10, 11, 12, 13, 14, 23, 24, 25]   # sx0..sy2, opp1..opp3


def _aa_common(fid, z, fid_n, z_n):
    """Owner and other ids of one pair direction."""
    da = torch.where(fid > 0.0, z, BIG)
    db = torch.where(fid_n > 0.0, z_n, BIG)
    owner_is_a = da <= db
    owner = torch.where(owner_is_a, fid, fid_n)
    other = torch.where(owner_is_a, fid_n, fid)
    return owner, other, fid != fid_n


def _find_slots(rec, counts, key):
    """Slot of face id ``key`` (C, TY, TX, P) in its tile's bin, −1 when
    the key is 0 or absent; a search over chunks of the bin."""
    cap = rec.shape[3]
    dev = rec.device
    counts = counts.to(torch.int64)
    slot = torch.full(key.shape, -1, dtype=torch.int64, device=dev)
    n = min(int(counts.max()) if counts.numel() else 0, cap)
    for j0 in range(0, n, _CHUNK):
        j1 = min(j0 + _CHUNK, n)
        slots = torch.arange(j0, j1, device=dev)
        fids = rec[:, :, :, j0:j1, 22]
        live = slots < counts[..., None]
        match = (fids[..., :, None] == key[..., None, :]) & live[..., None]
        hit = match.any(dim=3) & (key > 0.0) & (slot < 0)
        first = match.to(torch.uint8).argmax(dim=3) + j0
        slot = torch.where(hit, first, slot)
    return slot


def _aa_pair_t(fields, pax, pay, d_ex, d_ey, other):
    """Crossing parameter of one pair direction
    (``pallas_core.py:_aa_pair_t``): (t, found, takes, geometry)."""
    sxs = (fields[..., 0], fields[..., 2], fields[..., 4])
    sys_ = (fields[..., 1], fields[..., 3], fields[..., 5])
    opps = (fields[..., 6], fields[..., 7], fields[..., 8])
    best_t = torch.zeros_like(pax)
    found = torch.zeros_like(pax, dtype=torch.bool)
    takes, geos = [], []
    for e in range(3):
        ax, ay = sxs[e], sys_[e]
        bx, by = sxs[(e + 1) % 3], sys_[(e + 1) % 3]
        ex, ey = bx - ax, by - ay
        ea = ex * (pay - ay) - ey * (pax - ax)
        # eb evaluated directly at the neighbour pixel, not from ea
        eb = ex * (pay + d_ey - ay) - ey * (pax + d_ex - ax)
        separates = (ea > 0.0) != (eb > 0.0)
        denom = ea - eb
        safe_den = torch.where(denom == 0.0, 1.0, denom)
        t = ea / safe_den
        cx = pax + t * d_ex
        cy = pay + t * d_ey
        along = (cx - ax) * ex + (cy - ay) * ey
        within = (along >= 0.0) & (along <= ex * ex + ey * ey)
        silhouette = (other == 0.0) | (opps[e] != other)
        valid = separates & within & silhouette
        take = valid & ~found
        best_t = torch.where(take, t, best_t)
        found = found | valid
        takes.append(take)
        geos.append((ea, eb, safe_den, ax, ay, bx, by))
    return best_t, found, takes, geos


def _aa_directions(rec, counts, fid, z, resolution, row0=0, halo=None):
    """Per direction (right, down): owner slot, other id, difference flag,
    NDC offset, the owner's 9 edge fields, all in tile layout, and the
    neighbour shift ``nb(x, x_halo)`` (the halo row is the down
    neighbour of the last row where ``halo`` is given)."""
    fid_h, z_h = (None, None) if halo is None else halo[:2]
    sxs, sys_ = _scales(resolution)
    right = lambda x, h=None: _shift_left(x)
    down = lambda x, h=None: _shift_up(x, h)
    out = []
    for nb, d_ex, d_ey in ((right, sxs, 0.0), (down, 0.0, sys_)):
        own, oth, dif = _aa_common(_to_tiles(fid), _to_tiles(z),
                                   _to_tiles(nb(fid, fid_h)),
                                   _to_tiles(nb(z, z_h)))
        slot = _find_slots(rec, counts, torch.where(dif, own, 0.0))
        fields = _gather_slots(rec, slot, _AA_COLS)
        out.append((own, oth, dif, slot, fields, d_ex, d_ey, nb))
    return out


def _aa_checks(name, rec, color, resolution, *planes, row0=0, halo=None):
    """What the antialias kernels take beyond _check_cuda_inputs: tiles that
    match the planes, 3 or 4 channels (silhouette or shaded), 16-byte
    aligned colour planes (D = 4 moves as float4), halo rows of the
    planes' width."""
    C, ty, tx = rec.shape[:3]
    D = color.shape[-1]
    if tuple(color.shape[:3]) != (C, ty * TILE_H, tx * TILE_W) \
            or resolution[1] != color.shape[2]:
        raise ValueError(f"{name}: colour {tuple(color.shape)} does not "
                         f"match {ty}x{tx} tiles at {tuple(resolution)}")
    _check_rows(name, ty, row0, resolution)
    if D not in (3, 4):
        raise ValueError(f"{name}: {D} channels; the kernel takes 3 or 4")
    if D == 4 and any(t.data_ptr() % 16 for t in (color, *planes)):
        raise ValueError(f"{name}: 4-channel planes must be 16-byte aligned")
    for h in halo or ():
        if tuple(h.shape[:2]) != (C, color.shape[2]):
            raise ValueError(f"{name}: halo row {tuple(h.shape)} is not "
                             f"({C}, {color.shape[2]}, ...)")


@functools.lru_cache(maxsize=64)
def _aa_scratch_bytes(tiles, cap):
    from .. import _cuda
    return _cuda.library("aa_fwd", "ls_aa_scratch")(tiles, cap)


def _aa_scratch(C, ty, tx, cap, device):
    """The zeroed global scratch of the owner tables where shared memory
    cannot hold them (large caps): one table a tile; None when it can."""
    n = _aa_scratch_bytes(C * ty * tx, cap)
    return torch.zeros(n // 8, dtype=torch.int64, device=device) if n else None


@functools.lru_cache(maxsize=64)
def _aa_pairs_bytes(tiles):
    from .. import _cuda
    return _cuda.library("aa_bwd", "ls_aa_pairs_bytes")(tiles)


def _ptrs(halo, n):
    """The halo rows' data pointers, n Nones without a halo."""
    return (None,) * n if halo is None else tuple(h.data_ptr() for h in halo)


def aa_fwd(rec_bwd_b, counts_b, fid, z, color, resolution, row0=0,
           halo=None):
    """Antialias forward: color (C, H, W, D) → antialiased (C, H, W, D).
    fid and z (C, H, W) are the forward rasterizer's outputs, of the H/32
    tile rows from ``row0``.  With ``halo`` = (fid, z, colour) rows (C, W),
    (C, W), (C, W, D) of the next row shard, returns (antialiased, the
    share (C, W, D) that the next shard adds to its row 0)."""
    if _device_kind(rec_bwd_b, counts_b, fid, z, color,
                    *(halo or ())) == "cpu":
        return aa_fwd_plain(rec_bwd_b, counts_b, fid, z, color, resolution,
                            row0, halo)
    from .. import _cuda
    planes = {} if halo is None else dict(zip(("hfid", "hz", "hcol"), halo))
    _check_cuda_inputs("aa_fwd", rec=rec_bwd_b, counts=counts_b, fid=fid,
                       z=z, color=color, **planes)
    out = torch.empty_like(color)
    share = None if halo is None else torch.empty_like(halo[2])
    _aa_checks("aa_fwd", rec_bwd_b, color, resolution, out, row0=row0,
               halo=halo)
    C, ty, tx, cap, _ = rec_bwd_b.shape
    height, width, D = color.shape[1:]
    scratch = _aa_scratch(C, ty, tx, cap, color.device)
    sxs, sys_ = _scales(resolution)
    err = _cuda.library("aa_fwd")(
        rec_bwd_b.data_ptr(), counts_b.data_ptr(), fid.data_ptr(),
        z.data_ptr(), color.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), *_ptrs(halo, 3),
        None if share is None else share.data_ptr(),
        C, ty, tx, cap, height, width, D, int(row0), sxs, sys_, _stream())
    _cuda.check("aa_fwd", err)
    LAUNCHES["aa_fwd"] += 1
    return out if halo is None else (out, share)


def _aa_fwd_combine(out, db_h, db_v):
    """The anchor's blend plus the neighbours' shares, shifted back."""
    return out + _shift_right_ch(db_h) + _shift_down_ch(db_v)


def aa_fwd_plain(rec_bwd_b, counts_b, fid, z, color, resolution, row0=0,
                 halo=None):
    """Plain PyTorch version of :func:`aa_fwd`."""
    C, ty, tx = counts_b.shape
    _check_rows("aa_fwd", ty, row0, resolution)
    px, py = _pixel_coords(ty, tx, resolution, rec_bwd_b.device, row0)
    col_h = None if halo is None else halo[2]
    w = []
    for own, oth, dif, slot, fields, d_ex, d_ey, _ in _aa_directions(
            rec_bwd_b, counts_b, fid, z, resolution, row0, halo):
        t, found, _, _ = _aa_pair_t(fields, px, py, d_ex, d_ey, oth)
        act = dif & (own > 0.0) & found & (slot >= 0)
        w.append((torch.where(act & (t < 0.5), 0.5 - t, 0.0),
                  torch.where(act & (t >= 0.5), t - 0.5, 0.0)))
    (wa_h, wb_h), (wa_v, wb_v) = [(_from_tiles(a)[..., None],
                                   _from_tiles(b)[..., None]) for a, b in w]
    dh = _shift_left(color) - color
    dv = _shift_up(color, col_h) - color
    db_v = -wb_v * dv
    out = _aa_fwd_combine(color + wa_h * dh + wa_v * dv, -wb_h * dh, db_v)
    return out if halo is None else (out, db_v[:, -1])


def aa_bwd(rec_bwd_b, counts_b, fid, z, color, d_out, resolution, row0=0,
           halo=None):
    """Antialias backward.  Returns (d_color (C, H, W, D), dslot_aa
    (C, TY, TX, cap, 8) whose columns 0-5 are [dsx0 dsy0 dsx1 dsy1 dsx2
    dsy2], summed per owner slot over both pair directions), for the H/32
    tile rows from ``row0``.  With ``halo`` = (fid, z, colour, d_out) rows
    of the next row shard, also the share (C, W, D) of d_colour that the
    next shard adds to its row 0."""
    if _device_kind(rec_bwd_b, counts_b, fid, z, color, d_out,
                    *(halo or ())) == "cpu":
        return aa_bwd_plain(rec_bwd_b, counts_b, fid, z, color, d_out,
                            resolution, row0, halo)
    from .. import _cuda
    planes = {} if halo is None else dict(zip(("hfid", "hz", "hcol",
                                               "hdout"), halo))
    _check_cuda_inputs("aa_bwd", rec=rec_bwd_b, counts=counts_b, fid=fid,
                       z=z, color=color, d_out=d_out, **planes)
    d_color = torch.empty_like(color)
    share = None if halo is None else torch.empty_like(halo[2])
    _aa_checks("aa_bwd", rec_bwd_b, color, resolution, d_out, d_color,
               row0=row0, halo=halo)
    if d_out.shape != color.shape:
        raise ValueError(f"aa_bwd: d_out {tuple(d_out.shape)} is not the "
                         f"colour's shape {tuple(color.shape)}")
    C, ty, tx, cap, _ = rec_bwd_b.shape
    height, width, D = color.shape[1:]
    # the kernels write every element of dslot; the pair lists need no
    # zeroing (a strip writes its count and the places it lists)
    dslot = torch.empty((C, ty, tx, cap, 8), dtype=torch.float32,
                        device=color.device)
    scratch = _aa_scratch(C, ty, tx, cap, color.device)
    pairs = torch.empty(_aa_pairs_bytes(C * ty * tx), dtype=torch.uint8,
                        device=color.device)
    sxs, sys_ = _scales(resolution)
    err = _cuda.library("aa_bwd")(
        rec_bwd_b.data_ptr(), counts_b.data_ptr(), fid.data_ptr(),
        z.data_ptr(), color.data_ptr(), d_out.data_ptr(), d_color.data_ptr(),
        dslot.data_ptr(), None if scratch is None else scratch.data_ptr(),
        pairs.data_ptr(),
        *_ptrs(halo, 4), None if share is None else share.data_ptr(),
        C, ty, tx, cap, height, width, D, int(row0), sxs, sys_, _stream())
    _cuda.check("aa_bwd", err)
    LAUNCHES["aa_bwd"] += 1
    return (d_color, dslot) if halo is None else (d_color, dslot, share)


def _aa_bwd_combine(acc, d_out, db_h, db_v):
    return acc + d_out + _shift_right_ch(db_h) + _shift_down_ch(db_v)


def aa_bwd_plain(rec_bwd_b, counts_b, fid, z, color, d_out, resolution,
                 row0=0, halo=None):
    """Plain PyTorch version of :func:`aa_bwd`."""
    C, ty, tx, cap, _ = rec_bwd_b.shape
    dev = rec_bwd_b.device
    _check_rows("aa_bwd", ty, row0, resolution)
    px, py = _pixel_coords(ty, tx, resolution, dev, row0)
    col_h, dout_h = (None, None) if halo is None else halo[2:4]
    col_t = _to_tiles(color)
    dout_t = _to_tiles(d_out)
    acc = torch.zeros_like(col_t)
    dcolb, sums = [], []
    tile = torch.arange(C * ty * tx, device=dev).reshape(C, ty, tx, 1)
    for own, oth, dif, slot, fields, d_ex, d_ey, nb in _aa_directions(
            rec_bwd_b, counts_b, fid, z, resolution, row0, halo):
        t, found, takes, geos = _aa_pair_t(fields, px, py, d_ex, d_ey, oth)
        act = dif & (own > 0.0) & found & (slot >= 0)
        lo = act & (t < 0.5)
        hi = act & (t >= 0.5)
        wa = torch.where(lo, 0.5 - t, 0.0)[..., None]
        wb = torch.where(hi, t - 0.5, 0.0)[..., None]
        diff = _to_tiles(nb(color, col_h)) - col_t
        doutn = _to_tiles(nb(d_out, dout_h))
        acc = acc - wa * dout_t + wb * doutn
        dcolb.append(wa * dout_t - wb * doutn)
        sel = torch.where(lo[..., None], dout_t,
                          torch.where(hi[..., None], doutn, 0.0))
        dt = torch.zeros_like(t)
        for c in range(color.shape[-1]):
            dt = dt - diff[..., c] * sel[..., c]
        pbx = px + d_ex
        pby = py + d_ey
        ds = [torch.zeros_like(t) for _ in range(6)]
        for e in range(3):
            ea, eb, den, ax, ay, bx, by = geos[e]
            dtm = torch.where(takes[e], dt, 0.0)
            inv_d2 = 1.0 / (den * den)
            # sliver guard: zero non-finite contributions (a near-zero den
            # overflows 1/den², and one inf NaNs every parameter through
            # AdamUniform's global max)
            dea = dtm * (-eb) * inv_d2
            dea = torch.where(torch.abs(dea) < BIG, dea, 0.0)
            deb = dtm * ea * inv_d2
            deb = torch.where(torch.abs(deb) < BIG, deb, 0.0)
            j0, j1 = e, (e + 1) % 3
            ds[2 * j0] = ds[2 * j0] + (dea * (by - py) + deb * (by - pby))
            ds[2 * j0 + 1] = ds[2 * j0 + 1] + (dea * (px - bx)
                                               + deb * (pbx - bx))
            ds[2 * j1] = ds[2 * j1] + (dea * (py - ay) + deb * (pby - ay))
            ds[2 * j1 + 1] = ds[2 * j1 + 1] + (dea * (ax - px)
                                               + deb * (ax - pbx))
        S = torch.zeros((C * ty * tx * cap, 6), dtype=torch.float32,
                        device=dev)
        S.index_add_(0, (tile * cap + slot)[act],
                     torch.stack(ds, dim=-1)[act])
        sums.append(S)
    dslot = (sums[0] + sums[1]).reshape(C, ty, tx, cap, 6)
    dslot = torch.cat([dslot, torch.zeros_like(dslot[..., :2])], dim=-1)
    db_v = _from_tiles(dcolb[1])
    d_color = _aa_bwd_combine(_from_tiles(acc), d_out,
                              _from_tiles(dcolb[0]), db_v)
    return (d_color, dslot) if halo is None else (d_color, dslot, db_v[:, -1])


# ---------------------------------------------------------------------------
# 5. the prebinned pipe's backward glue: chained per-slot sums → face rows
# ---------------------------------------------------------------------------

def chain_face_rows(dslot, dslot_aa, boost, rbb, fslots, up_rows):
    """The per-(camera, face) rows (C, F+1, 18) [per corner: dx dy dw dA0
    dA1 dA2] of a prebinned pipe's per-slot sums:
    ``slot_face_rows(chain_planes(dslot, dslot_aa, boost, rbb), fslots,
    upper)`` (:mod:`largesteps_torch.render.pipeline`), ``upper`` the first
    ``up_rows`` tile rows, the same bits on the card.

    dslot (C, TY, TX, cap, 32) raster sums, dslot_aa (C, TY, TX, cap, 8)
    antialias endpoint sums, rbb (C, TY, TX, cap, 32) backward records,
    fslots (C, F+1, K) int64 flat slot indices in tile order with the
    sentinel TY·TX·cap.  A CUDA tensor goes to the kernel (one launch,
    counted in ``LAUNCHES``; no (C, T, cap, 18) table), a CPU tensor to
    :func:`chain_face_rows_plain`."""
    if _device_kind(dslot, dslot_aa, rbb, fslots) == "cpu":
        return chain_face_rows_plain(dslot, dslot_aa, boost, rbb, fslots,
                                     up_rows)
    from .. import _cuda
    _check_cuda_inputs("chain_face_rows", dslot=dslot, dslot_aa=dslot_aa,
                       rbb=rbb)
    if fslots.dtype != torch.int64 or not fslots.is_contiguous():
        raise ValueError("chain_face_rows: fslots must be a contiguous "
                         f"torch.int64 tensor, got {fslots.dtype}"
                         f"{'' if fslots.is_contiguous() else ' (strided)'}")
    _check_aligned("chain_face_rows", dslot, dslot_aa, rbb)
    C, ty, tx, cap, _ = dslot.shape
    if (dslot.shape[-1] != 32 or rbb.shape != dslot.shape
            or dslot_aa.shape != (C, ty, tx, cap, 8)
            or fslots.dim() != 3 or fslots.shape[0] != C):
        raise ValueError(
            f"chain_face_rows: dslot {tuple(dslot.shape)}, dslot_aa "
            f"{tuple(dslot_aa.shape)}, rbb {tuple(rbb.shape)}, fslots "
            f"{tuple(fslots.shape)}: want (C, TY, TX, cap, 32), (..., 8), "
            "(..., 32) and (C, F+1, K)")
    if not 0 <= up_rows <= ty:
        raise ValueError(f"chain_face_rows: up_rows {up_rows} of {ty} tile "
                         "rows")
    F1, K = fslots.shape[1:]
    dface = torch.empty((C, F1, 18), dtype=torch.float32,
                        device=dslot.device)
    err = _cuda.library("chain_face_rows")(
        dslot.data_ptr(), dslot_aa.data_ptr(), rbb.data_ptr(),
        fslots.data_ptr(), dface.data_ptr(), C, F1, K, ty * tx * cap,
        tx * cap, int(up_rows), float(np.float32(boost)),
        _cuda.stream(dslot.device))
    _cuda.check("chain_face_rows", err)
    LAUNCHES["chain_face_rows"] += 1
    return dface


def chain_face_rows_plain(dslot, dslot_aa, boost, rbb, fslots, up_rows):
    """Plain PyTorch version of :func:`chain_face_rows`: the per-slot table
    of :func:`~largesteps_torch.render.pipeline.chain_planes`, summed into
    face rows by :func:`~largesteps_torch.render.pipeline.slot_face_rows`."""
    from .pipeline import chain_planes, slot_face_rows
    upper = torch.arange(dslot.shape[1], device=dslot.device) < up_rows
    return slot_face_rows(chain_planes(dslot, dslot_aa, boost, rbb), fslots,
                          upper)


# ---------------------------------------------------------------------------
# 6. the prebinned pipe's forward setup: each slot's two record rows
# ---------------------------------------------------------------------------

def setup_slots(v_clip, faces, attrs, opp, bins, height, width,
                need_fwd=True):
    """The binned records (rfb, rbb), each (C, T, cap, 32), of faces
    ``bins`` (C, T, cap) (−1 = dead slot) in the cameras of v_clip
    (C, V, 4): :func:`~largesteps_torch.render.pipeline.setup_from_bins`.
    rfb is None with ``need_fwd=False``.

    A CUDA tensor goes to the kernel: one launch, counted in ``LAUNCHES``,
    which computes each slot's rows from its face and writes them once (no
    face-major record, stack, cat or gather), the bits of
    :func:`setup_slots_plain` on the card.  It takes faces and opp (F, 3)
    int64, attrs (V, 3) float32 and bins int32 or int64 with any strides (a
    row shard's slice of whole-image bins).  A CPU tensor goes to
    :func:`setup_slots_plain`."""
    if _device_kind(v_clip, faces, attrs, opp, bins) == "cpu":
        return setup_slots_plain(v_clip, faces, attrs, opp, bins, height,
                                 width, need_fwd)
    from .. import _cuda
    _check_cuda_inputs("setup_slots", v_clip=v_clip, attrs=attrs)
    for arg, t in (("faces", faces), ("opp", opp)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"setup_slots: {arg} must be a contiguous "
                             f"torch.int64 tensor, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    if bins.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"setup_slots: bins must be int32 or int64, got "
                         f"{bins.dtype}")
    _check_aligned("setup_slots", v_clip)
    if (v_clip.dim() != 3 or v_clip.shape[2] != 4 or faces.dim() != 2
            or faces.shape[1] != 3 or opp.shape != faces.shape
            or attrs.shape != (v_clip.shape[1], 3) or bins.dim() != 3
            or bins.shape[0] != v_clip.shape[0]):
        raise ValueError(
            f"setup_slots: v_clip {tuple(v_clip.shape)}, faces "
            f"{tuple(faces.shape)}, attrs {tuple(attrs.shape)}, opp "
            f"{tuple(opp.shape)}, bins {tuple(bins.shape)}: want (C, V, 4), "
            "(F, 3), (V, 3), (F, 3) and (C, T, cap)")
    C, T, cap = bins.shape
    rbb = torch.empty((C, T, cap, 32), dtype=torch.float32,
                      device=v_clip.device)
    rfb = torch.empty_like(rbb) if need_fwd else None
    err = _cuda.library("setup_slots")(
        v_clip.data_ptr(), faces.data_ptr(), attrs.data_ptr(),
        opp.data_ptr(), bins.data_ptr(),
        None if rfb is None else rfb.data_ptr(), rbb.data_ptr(), C, T, cap,
        v_clip.shape[1], faces.shape[0], *bins.stride(),
        int(bins.dtype == torch.int64), float(np.float32(height / 2.0)),
        _cuda.stream(v_clip.device))
    _cuda.check("setup_slots", err)
    LAUNCHES["setup_slots"] += 1
    return rfb, rbb


def _gather_rows(rec, bins, fill):
    """Whole 32-float record rows by bins: rec (C, F, 32), bins (C, T, cap)
    with −1 for a dead slot, which gets the row ``fill``."""
    C, F, _ = rec.shape
    ext = torch.cat([rec, fill.expand(C, 1, 32)], dim=1)
    ids = torch.where(bins >= 0, bins, F)
    cam = torch.arange(C, device=rec.device)[:, None, None]
    return ext[cam, ids]


def setup_slots_plain(v_clip, faces, attrs, opp, bins, height, width,
                      need_fwd=True):
    """Plain PyTorch version of :func:`setup_slots`: the records built
    face-major, as :func:`~largesteps_torch.render.pipeline.triangle_setup`
    builds them, and whole rows gathered by ``bins``.  Dead slots get an
    empty y-range in rfb (a zeroed row would read as y = 0) and zeros in
    rbb."""
    from .pipeline import triangle_setup
    rec_fwd, rec_bwd = triangle_setup(v_clip, faces, attrs, opp, height,
                                      width, need_fwd)
    rbb = _gather_rows(rec_bwd, bins, rec_bwd.new_zeros(32))
    if not need_fwd:
        return None, rbb
    dead = rec_fwd.new_zeros(32)
    dead[12], dead[13] = 1e9, -1e9
    return _gather_rows(rec_fwd, bins, dead), rbb
