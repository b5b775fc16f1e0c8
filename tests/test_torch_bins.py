"""The two properties of the per-tile bins that the antialias kernels rely
on, at 2 views of 256×256 (two tiles each way) with icosphere-3, and the ids
and depths of ``raster_fwd_plain`` on those bins.  The bins are those of
``setup_and_bin`` (traced), of ``bin_triangles_host`` and of
``bin_triangles_device``, each of the last two at margins 0 and 4 px.

* Every pixel pair whose face ids differ has its owner (the nearer face) in
  the bin of the anchor's tile and in the bin of the neighbour's tile.  So
  the pairs that cross a tile border, anchored in column x0 − 1 or row
  y0 − 1 of a tile or crossing its top or right border, find their owner on
  both sides (the bins test the bbox expanded by one pixel on both sides).
* No face id occurs twice among a tile's live slots.

Besides, ``setup_from_bins`` on CPU tensors takes the plain route (no
launch of ``kernels.setup_slots``' kernel): each live slot holds its face's
rows of ``triangle_setup``'s records, each dead slot the fill rows.
"""
import numpy as np
import pytest
import torch

from largesteps_torch.io.synth import make_scene
from largesteps_torch.render import kernels as K
from largesteps_torch.render.antialias import face_adjacency
from largesteps_torch.render.camera import project
from largesteps_torch.render.pipeline import (bin_triangles_device,
                                              bin_triangles_host,
                                              check_bin_overflow,
                                              setup_and_bin, setup_from_bins,
                                              suggest_cap, triangle_setup)
from largesteps_torch.render.renderer import Renderer

RES = (256, 256)
TY, TX = RES[0] // K.TILE_H, RES[1] // K.TILE_W


@pytest.fixture(scope="module", params=[
    ("traced", 0.0), ("host", 0.0), ("host", 4.0), ("device", 0.0),
    ("device", 4.0)], ids=["traced", "host", "host_m4", "device",
                           "device_m4"])
def binned(request):
    kind, margin = request.param
    scene = make_scene(source=("icosphere", 3), target=("gourd", 2),
                       n_views=2, res=RES[0])
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64))
    opp = torch.as_tensor(face_adjacency(f).astype(np.int64))
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"]),
                    Renderer(scene, device="cpu").mvps)
    attrs = torch.zeros((v_ndc.shape[1], 3))
    if kind == "traced":
        cap = suggest_cap(check_bin_overflow(v_ndc, faces, RES))
        rfb, rbb, bins, counts = setup_and_bin(v_ndc, faces, attrs, opp,
                                               *RES, cap)
    else:
        b, c, occ, spans = bin_triangles_host(v_ndc.numpy(), f, RES,
                                              margin=margin,
                                              return_spans=True)
        cap = b.shape[-1]
        if kind == "device":
            assert spans[0] <= 2 and spans[1] <= 2   # its static bound
            b, c, _, d_occ = bin_triangles_device(v_ndc, faces, RES, cap,
                                                  margin=margin)
            assert int(d_occ) == occ
        bins = torch.as_tensor(b).long()
        rfb, _ = setup_from_bins(v_ndc, faces, attrs, opp, bins, *RES)
        C = bins.shape[0]
        rfb = rfb.reshape(C, TY, TX, cap, 32)
        bins = bins.reshape(C, TY, TX, cap)
        counts = torch.as_tensor(c).reshape(C, TY, TX).to(torch.int32)
    fwd = K.raster_fwd_plain(rfb, counts, RES)
    return {"bins": bins, "counts": counts, "fid": fwd[3], "z": fwd[2],
            "cap": cap}


def _tile_sets(bins, counts):
    """Face ids (1-based) of each (camera, ty, tx) bin's live slots."""
    C, TY, TX, cap = bins.shape
    out = {}
    for c in range(C):
        for ty in range(TY):
            for tx in range(TX):
                n = int(counts[c, ty, tx])
                out[c, ty, tx] = (bins[c, ty, tx, :n] + 1).tolist()
    return out


def test_pair_owners_are_in_both_tiles_bins(binned):
    fid, z = binned["fid"], binned["z"]
    assert int(binned["counts"].max()) < binned["cap"]      # no overflow
    sets = {k: set(v) for k, v in
            _tile_sets(binned["bins"], binned["counts"]).items()}
    C, H, W = fid.shape
    checked = {"right": 0, "down": 0, "border": 0}
    for name, nb in (("right", K._shift_left), ("down", K._shift_up)):
        own, _, dif = K._aa_common(fid, z, nb(fid), nb(z))
        c, y, x = torch.nonzero(dif & (own > 0), as_tuple=True)
        yn = y + (name == "down")
        xn = x + (name == "right")
        for i in range(c.numel()):
            o = int(own[c[i], y[i], x[i]])
            ci = int(c[i])
            anchor = (ci, int(y[i]) // K.TILE_H, int(x[i]) // K.TILE_W)
            neigh = (ci, int(yn[i]) // K.TILE_H, int(xn[i]) // K.TILE_W)
            assert o in sets[anchor], (name, anchor, o)
            assert o in sets[neigh], (name, neigh, o)
            checked[name] += 1
            checked["border"] += anchor != neigh
    # pairs cross both the vertical and the horizontal tile border
    assert checked["right"] > 1000 and checked["down"] > 1000
    assert checked["border"] > 100, checked


def test_no_face_twice_in_a_tile(binned):
    sets = _tile_sets(binned["bins"], binned["counts"])
    assert sum(len(v) for v in sets.values()) > 1000
    for key, ids in sets.items():
        assert len(ids) == len(set(ids)), key


def test_setup_from_bins_on_the_cpu_takes_the_plain_route():
    """CPU tensors: ``LAUNCHES["setup_slots"]`` unchanged, each live slot
    the rows of its face in ``triangle_setup``'s records, each dead slot the
    fill rows (rfb zeros but an empty y-range, rbb zeros); with
    ``need_fwd=False`` the same rbb and no rfb (icosphere-2, 2 views of
    128²)."""
    res = (128, 128)
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=2, res=res[0])
    f = scene["mesh-source"]["faces"]
    faces = torch.as_tensor(f.astype(np.int64))
    opp = torch.as_tensor(face_adjacency(f).astype(np.int64))
    v_ndc = project(torch.as_tensor(scene["mesh-source"]["vertices"]),
                    Renderer(scene, device="cpu").mvps)
    attrs = torch.as_tensor(np.random.default_rng(3).normal(
        size=(v_ndc.shape[1], 3)).astype(np.float32))
    b, _, _ = bin_triangles_host(v_ndc.numpy(), f, res, margin=2.0)
    bins = torch.as_tensor(b).long()
    before = K.LAUNCHES["setup_slots"]
    rfb, rbb = setup_from_bins(v_ndc, faces, attrs, opp, bins, *res)
    no_fwd, rbb_only = setup_from_bins(v_ndc, faces, attrs, opp, bins, *res,
                                       need_fwd=False)
    assert K.LAUNCHES["setup_slots"] == before
    rec_fwd, rec_bwd = triangle_setup(v_ndc, faces, attrs, opp, *res)
    live = bins >= 0
    assert live.any() and (~live).any()
    cam = torch.arange(bins.shape[0])[:, None, None].expand_as(bins)
    assert torch.equal(rfb[live], rec_fwd[cam[live], bins[live]])
    assert torch.equal(rbb[live], rec_bwd[cam[live], bins[live]])
    fill = torch.zeros(32)
    fill[12], fill[13] = 1e9, -1e9
    assert torch.equal(rfb[~live], fill.expand(int((~live).sum()), 32))
    assert not rbb[~live].any()
    assert no_fwd is None and torch.equal(rbb_only, rbb)
