"""Per-stage times of the fused pipe at suzanne's scale and of the big
pipe's per-camera stages at nefertiti's.

    python -m largesteps_torch.benchmarks.stage_times [suzanne|nefertiti]
        [--subdiv N] [--views 13] [--res 256] [--device cuda]

Port of ``benchmarks/stage_times.py``.  ``suzanne`` (icosphere-4, 13
views of 256², the traced bins at the renderer's fitted cap): the setup
and bin, raster_fwd, aa_fwd, aa_bwd, raster_bwd and the chain and scatter
to vertices, each on its own, as :class:`largesteps_torch.render.pipeline.
RenderPipeline` runs them.  ``nefertiti`` (icosphere-7, 327,680 faces,
host bins with the 4 px margin): the same stages for one camera, the
setup gathered by the bins (``setup_from_bins``), as the camera-sequential
pipe runs each camera.  The backward stages take a cotangent of 1e-3 on
every colour channel, as the JAX script's.  Prints one JSON line a stage,
each naming the device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..io.synth import make_scene
from ..ops.normals import compute_face_normals, compute_vertex_normals
from ..render import kernels
from ..render.camera import project
from ..render.pipeline import (bin_triangles_host, build_incidence,
                               chain_planes, scatter_via_faces,
                               setup_and_bin, setup_from_bins)
from ..render.renderer import Renderer, Topology
from ..render.sh import sh_eval
from . import device_name, time_ms

__all__ = ["main", "SCALES"]

# scale -> (the source's subdivision, the target's); the target only
# places the scene
SCALES = {"suzanne": (4, 4), "nefertiti": (7, 4)}


def _stages(renderer, v_ndc, faces, opp, attrs, rfb, rbb, bins, counts,
            setup, n_verts):
    """The stages after the setup, each a closure over the one before's
    outputs: [(name, fn)]."""
    res = renderer.res
    u, v, z, fid, slot, c0, c1, c2 = kernels.raster_fwd(rfb, counts, res)
    color = torch.stack([c0, c1, c2], dim=-1)
    cov = (fid > 0.0)[..., None]
    bgs = renderer.bgs[:v_ndc.shape[0]]
    comp = torch.where(cov, torch.cat([color, cov.to(color.dtype)], -1),
                       bgs).contiguous()
    g = torch.full_like(comp, 1e-3)
    d_comp, dslot_aa = kernels.aa_bwd(rbb, counts, fid, z, comp, g, res)
    dcol = g[..., :3].contiguous()
    zeros = torch.zeros_like(fid)
    dslot = kernels.raster_bwd(rbb, counts, slot, dcol, zeros, zeros, res)
    idx, mask = build_incidence(faces.cpu().numpy(), n_verts)
    inc = (torch.as_tensor(idx, device=v_ndc.device),
           torch.as_tensor(mask, dtype=torch.float32, device=v_ndc.device))
    F = faces.shape[0]
    return [
        ("setup", setup),
        ("raster_fwd", lambda: kernels.raster_fwd(rfb, counts, res)),
        ("aa_fwd", lambda: kernels.aa_fwd(rbb, counts, fid, z, comp, res)),
        ("aa_bwd", lambda: kernels.aa_bwd(rbb, counts, fid, z, comp, g,
                                          res)),
        ("raster_bwd", lambda: kernels.raster_bwd(rbb, counts, slot, dcol,
                                                  zeros, zeros, res)),
        ("chain_scatter", lambda: scatter_via_faces(
            chain_planes(dslot, dslot_aa, renderer.boost, rbb), bins, inc,
            F, n_verts)),
    ]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scale", nargs="?", default="suzanne",
                    choices=sorted(SCALES))
    ap.add_argument("--subdiv", type=int, default=None,
                    help="the source's subdivision (default: the scale's)")
    ap.add_argument("--views", type=int, default=13)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--reps", type=int, default=None,
                    help="calls timed a stage (default 20, nefertiti 5)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    big = args.scale == "nefertiti"
    subdiv, target = SCALES[args.scale]
    subdiv = args.subdiv if args.subdiv is not None else subdiv
    reps = args.reps or (5 if big else 20)
    scene = make_scene(source=("icosphere", subdiv), target=("gourd", target),
                       n_views=args.views, res=args.res)
    renderer = Renderer(scene, shading=True, boost=3, device=dev)
    topo = Topology(scene["mesh-source"]["faces"])
    faces, opp = topo.dense_tables(dev)
    with torch.no_grad():
        v = torch.as_tensor(scene["mesh-source"]["vertices"], device=dev)
        n = compute_vertex_normals(v, faces, compute_face_normals(v, faces))
        attrs = sh_eval(renderer.sh_M, n) / np.pi
        v_ndc = project(v, renderer.mvps)
        h, w = renderer.res
        if big:
            hb, hc, occ = bin_triangles_host(v_ndc.cpu().numpy(),
                                             topo.faces, renderer.res,
                                             margin=4.0)
            cap = hb.shape[-1]
            ty, tx = hb.shape[1] // (w // kernels.TILE_W), \
                w // kernels.TILE_W
            vc1 = v_ndc[:1]
            b1 = torch.as_tensor(hb[:1].astype(np.int64), device=dev)
            counts = torch.as_tensor(hc[:1], device=dev).reshape(
                1, ty, tx).to(torch.int32).contiguous()

            def setup():
                return setup_from_bins(vc1, faces, attrs, opp, b1, h, w)

            rfb, rbb = [t.reshape(1, ty, tx, cap, 32) for t in setup()]
            bins = b1.reshape(1, ty, tx, cap)
            stages = _stages(renderer, vc1, faces, opp, attrs, rfb, rbb,
                             bins, counts, setup, v.shape[0])
        else:
            occ = renderer.check_overflow(v, topo)
            cap = renderer.bin_cap

            def setup():
                return setup_and_bin(v_ndc, faces, attrs, opp, h, w, cap)

            rfb, rbb, bins, counts = setup()
            stages = _stages(renderer, v_ndc, faces, opp, attrs, rfb, rbb,
                             bins, counts, setup, v.shape[0])
        base = {"device": device_name(dev), "scale": args.scale,
                "verts": int(v.shape[0]), "faces": topo.n_faces,
                "views": 1 if big else args.views, "res": args.res,
                "cap": int(cap), "occupancy": int(occ)}
        lines = []
        for name, fn in stages:
            line = {**base, "metric": f"{name}_ms",
                    "value": time_ms(fn, dev, n=reps, warmup=2)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
