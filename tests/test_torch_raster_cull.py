"""The cull of the ``raster_fwd`` kernel never drops a slot that the z-test
of ``raster_fwd_plain`` makes cover a pixel of the region it culls for.

The kernel (``csrc/raster_fwd.cu``) drops a slot from a strip (8 rows by 128
columns of a tile) when its 1 px expanded y-range misses the strip's rows,
or when ``rf_misses`` (``csrc/common.cuh``) finds one of its edge functions
below a margin at all four corner pixel centres; each warp drops a slot
from its band (16 columns by the strip's rows) by the same corner test.
Both are mirrored here in float32 torch, operation for operation, with the
margin's constants read from the header, and checked against coverage
computed as ``raster_fwd_plain`` computes it, at every pixel:

* the main path's bins at a small size (icosphere-3 in 2 views of 128²);
* large triangles close to the camera (icosphere-1, 2 views of 256²);
* random slivers, near-degenerate triangles, and triangles reaching far
  outside the screen, binned as the main path bins.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from largesteps_torch.io.synth import make_scene
from largesteps_torch.render import kernels as K
from largesteps_torch.render.camera import project
from largesteps_torch.render.pipeline import (check_bin_overflow,
                                              setup_and_bin, suggest_cap)
from largesteps_torch.render.renderer import Renderer

HEADER = (Path(__file__).resolve().parents[1] / "largesteps_torch" / "csrc"
          / "common.cuh").read_text()
STRIP_H, BAND = 8, 16
_CHUNK = 64              # slots per step


def _constant(name):
    m = re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;", HEADER)
    assert m, name
    return float(np.float32(m.group(1)))


EPS, TINY, HUGE = (_constant(n) for n in ("RF_EPS", "RF_TINY", "RF_HUGE"))


def _misses(r, x0, x1, y0, y1):
    """``rf_misses`` of records r (..., >= 9) over the pixel centres
    [x0, x1] × [y0, y1] (float32 tensors broadcast against r[..., 0])."""
    c = [r[..., k] for k in range(9)]
    X = torch.maximum(x0.abs(), x1.abs())
    Y = torch.maximum(y0.abs(), y1.abs())
    a = [v.abs() for v in c]
    M = ((a[0] * X + a[1] * Y + a[2]) + (a[3] * X + a[4] * Y + a[5])) \
        + (a[6] * X + a[7] * Y + a[8])
    e = M * EPS + TINY
    out = [True, True, True]
    for x in (x0, x1):
        for y in (y0, y1):
            q0 = c[0] * x + c[1] * y + c[2]
            q1 = c[3] * x + c[4] * y + c[5]
            s = c[6] * x + c[7] * y + c[8]
            q2 = s - q0 - q1
            out = [o & (q < -e) for o, q in zip(out, (q0, q1, q2))]
    return (e < HUGE) & (out[0] | out[1] | out[2])


def _check(rfb, counts, res):
    """For every live slot and every strip and band of its tile: culled
    implies no covered pixel there.  Returns (slot-band pairs culled,
    pairs, covered slot-pixel pairs) to show the check has teeth."""
    C, TY, TX, cap, _ = rfb.shape
    px, py = K._pixel_coords(TY, TX, res, rfb.device)      # (TY, TX, P)
    px = px.reshape(1, TY, TX, 1, K.TILE_H, K.TILE_W)
    py = py.reshape(1, TY, TX, 1, K.TILE_H, K.TILE_W)
    ty0 = (torch.arange(TY) * K.TILE_H).float().reshape(1, TY, 1, 1)
    culled = pairs = covered = 0
    n = int(counts.max())
    for j0 in range(0, n, _CHUNK):
        r = rfb[:, :, :, j0:j0 + _CHUNK]
        live = (torch.arange(j0, j0 + r.shape[3]) < counts[..., None])
        c = lambda k: r[..., k, None, None]
        q0 = c(0) * px + c(1) * py + c(2)
        q1 = c(3) * px + c(4) * py + c(5)
        s = c(6) * px + c(7) * py + c(8)
        d = c(9) * px + c(10) * py + c(11)
        q2 = s - q0 - q1
        cov = (q0 >= 0.0) & (q1 >= 0.0) & (q2 >= 0.0) & (s > 0.0) \
            & (d < K.BIG) & live[..., None, None]     # (C,TY,TX,ch,32,128)
        covered += int(cov.sum())
        for st in range(K.TILE_H // STRIP_H):
            rows = slice(st * STRIP_H, (st + 1) * STRIP_H)
            y0 = py[..., st * STRIP_H, 0]
            y1 = py[..., (st + 1) * STRIP_H - 1, 0]
            row_lo = ty0 + st * STRIP_H
            row_hi = row_lo + (STRIP_H - 1)
            off_rows = (r[..., 13] < row_lo) | (r[..., 12] > row_hi)
            strip_out = off_rows | _misses(r, px[..., 0, 0], px[..., 0, -1],
                                           y0, y1)
            hit = cov[..., rows, :]
            assert not bool((strip_out & hit.flatten(-2).any(-1)
                             & live).any()), ("strip", j0, st)
            for w in range(K.TILE_W // BAND):
                cols = slice(w * BAND, (w + 1) * BAND)
                band_out = strip_out | _misses(
                    r, px[..., 0, w * BAND], px[..., 0, (w + 1) * BAND - 1],
                    y0, y1)
                band_hit = hit[..., cols].flatten(-2).any(-1)
                assert not bool((band_out & band_hit & live).any()), (
                    "band", j0, st, w)
                culled += int((band_out & live).sum())
                pairs += int(live.sum())
    return culled, pairs, covered


def _bins(v_ndc, faces, res):
    opp = torch.zeros_like(faces)
    cap = suggest_cap(check_bin_overflow(v_ndc, faces, res))
    attrs = torch.zeros((v_ndc.shape[1], 3))
    rfb, _, _, counts = setup_and_bin(v_ndc, faces, attrs, opp, *res, cap)
    return rfb, counts


def _scene_bins(level, n_views, res, distance=3.5):
    scene = make_scene(source=("icosphere", level), target=("gourd", 2),
                       n_views=n_views, res=res, distance=distance)
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64))
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"]),
                    Renderer(scene, device="cpu").mvps)
    return _bins(v_ndc, faces, (res, res))


def _random_clip(kind, n, seed):
    """n triangles of clip-space corners (1, 3n, 4)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.3, 3.0, size=(n, 3))
    if kind == "sliver":
        # the third corner a hair off the line through the first two
        a = rng.uniform(-1.2, 1.2, size=(n, 2))
        b = a + rng.normal(scale=0.3, size=(n, 2))
        t = rng.uniform(-0.5, 1.5, size=(n, 1))
        normal = np.stack([a[:, 1] - b[:, 1], b[:, 0] - a[:, 0]], -1)
        c = a + t * (b - a) + normal * 10.0 ** rng.uniform(-6, -2, (n, 1))
        xy = np.stack([a, b, c], 1)
    elif kind == "tiny":
        # a few pixels or less across, anywhere on the screen
        centre = rng.uniform(-1.0, 1.0, size=(n, 1, 2))
        xy = centre + rng.normal(size=(n, 3, 2)) * 10.0 ** rng.uniform(
            -5, -1.5, (n, 1, 1))
    else:                                       # "far": corners off screen
        xy = rng.uniform(-40.0, 40.0, size=(n, 3, 2))
    z = rng.uniform(0.0, 0.9, size=(n, 3))
    clip = np.concatenate([xy * w[..., None], (z * w)[..., None],
                           w[..., None]], -1)
    return torch.as_tensor(clip.reshape(1, 3 * n, 4).astype(np.float32))


def test_cull_keeps_every_covering_slot_main_path_bins():
    rfb, counts = _scene_bins(3, 2, 128)
    culled, pairs, covered = _check(rfb, counts, (128, 128))
    assert covered > 10000
    assert culled > pairs // 2          # the cull drops most slot-band pairs


def test_cull_keeps_every_covering_slot_large_triangles():
    rfb, counts = _scene_bins(1, 2, 256, distance=1.6)
    culled, pairs, covered = _check(rfb, counts, (256, 256))
    assert covered > 50000 and culled > 0


@pytest.mark.parametrize("kind", ["sliver", "tiny", "far"])
def test_cull_keeps_every_covering_slot_random(kind):
    n = 400
    faces = torch.arange(3 * n).reshape(n, 3)
    rfb, counts = _bins(_random_clip(kind, n, seed=len(kind)), faces,
                        (128, 128))
    culled, pairs, covered = _check(rfb, counts, (128, 128))
    assert covered > 0 and 0 < culled < pairs


def test_cull_keeps_an_edge_through_a_corner_centre():
    """q0 exactly 0 at a region's corner pixel centre (covered there) keeps
    the slot; one pixel further on, q0 < 0 at every corner drops it."""
    sxs = float(np.float32(2.0 / 128))
    x = ((torch.arange(83, 87, dtype=torch.float32) + 0.5) * sxs - 1.0)
    y = torch.full((1,), 0.5)
    r = torch.zeros(1, 9)
    r[0, 0], r[0, 2] = -1.0, float(x[1])     # q0 = x[1] - x: 0 at x[1]
    r[0, 5], r[0, 8] = 1.0, 3.0              # q1 = 1, s = 3, q2 = 2
    assert float((r[0, 0] * x[1] + r[0, 1] * y + r[0, 2])[0]) == 0.0
    assert not bool(_misses(r, x[1:2], x[2:3], y, y))
    assert bool(_misses(r, x[2:3], x[3:4], y, y))


def test_raster_wrappers_take_aligned_records():
    """The kernels read records 16 bytes at a time; the wrappers refuse a
    record array that does not start on 16 bytes."""
    rec = torch.zeros(33 * 32)
    K._check_aligned("raster_fwd", rec[32:])
    with pytest.raises(ValueError, match="16-byte"):
        K._check_aligned("raster_fwd", rec[1:])
