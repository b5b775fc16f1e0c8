"""Rasterizer micro-benchmark: the dense rasterizer against the tile
kernels, forward and forward+backward, in ms and Mpix/s.

    python -m largesteps_torch.benchmarks.bench_raster [--views 13]
        [--res 256] [--subdiv 4] [--device cuda]

Port of ``benchmarks/bench_raster.py`` (its XLA scan is the dense
:func:`largesteps_torch.render.raster.rasterize` at ``chunk`` 256, its
Pallas kernel :func:`largesteps_torch.render.tile_raster.
rasterize_tiles_fwd`): icosphere-``subdiv`` in ``views`` turntable views.
Prints the max bin occupancy, each leg's time, and the share of pixels
whose face ids agree between the two.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..io.synth import turntable_views
from ..ops.shapes import icosphere
from ..render.camera import build_mvps, persp_proj, project
from ..render.kernels import TILE_H, TILE_W
from ..render.raster import interpolate, rasterize
from ..render.tile_raster import (check_bin_overflow, rasterize_tiles,
                                  rasterize_tiles_fwd, suggest_cap)
from . import device_name, time_ms

__all__ = ["main"]

CHUNK = 256             # the JAX script's faces a scan step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=13)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = (args.res, args.res)
    v, f = icosphere(args.subdiv)
    mvps = build_mvps(persp_proj(45, 1.0, 0.1, 100.0),
                      np.stack(turntable_views(args.views)))
    vc = project(torch.as_tensor(v, dtype=torch.float32, device=dev),
                 torch.as_tensor(mvps, device=dev))
    faces = torch.as_tensor(f.astype(np.int64), device=dev)
    mpix = args.views * args.res * args.res / 1e6
    out = {"device": device_name(dev), "verts": len(v), "faces": len(f),
           "views": args.views, "res": args.res, "mpix": mpix}
    print(f"device={out['device']} V={len(v)} F={len(f)} views={args.views} "
          f"res={args.res} ({mpix:.2f} Mpix)")
    t = lambda fn: time_ms(fn, dev, n=args.reps, warmup=1)

    def report(key, label, ms):
        out[key + "_ms"] = ms
        out[key + "_mpix_s"] = mpix / ms * 1e3
        print(f"{label}: {ms:.2f} ms  {mpix / ms * 1e3:.1f} Mpix/s",
              flush=True)

    dense = rasterize(vc, faces, res, CHUNK)
    report("dense_fwd", "dense fwd", t(lambda: rasterize(vc, faces, res,
                                                         CHUNK)))
    attr = torch.ones((len(v), 4), device=dev)

    def dense_fwd_bwd():
        x = vc.detach().requires_grad_(True)
        interpolate(attr, rasterize(x, faces, res, CHUNK), faces).mean() \
            .backward()
        return x.grad

    report("dense_fwd_bwd", "dense fwd+bwd", t(dense_fwd_bwd))
    if args.res % TILE_H or args.res % TILE_W:
        print(f"tiles: {args.res}² does not tile into {TILE_H}x{TILE_W}")
        return out
    occ = check_bin_overflow(vc, faces, res)
    cap = suggest_cap(occ)
    out.update(occupancy=occ, cap=cap)
    print("max bin occupancy:", occ, " cap:", cap)
    tiles = rasterize_tiles_fwd(vc, faces, res, cap)
    report("tiles_fwd", "tiles fwd", t(lambda: rasterize_tiles_fwd(
        vc, faces, res, cap)))

    def tiles_fwd_bwd():
        x = vc.detach().requires_grad_(True)
        interpolate(attr, rasterize_tiles(x, faces, res, cap), faces).mean() \
            .backward()
        return x.grad

    report("tiles_fwd_bwd", "tiles fwd+bwd", t(tiles_fwd_bwd))
    out["id_match"] = float((dense[..., 3] == tiles[..., 3]).float().mean())
    print(f"{device_name(dev)} id match: {out['id_match']}")
    return out


if __name__ == "__main__":
    main()
