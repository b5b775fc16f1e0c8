"""How many pixels a step of the teaser's ``ours`` leg draws wrong because
its bins are stale.

    python -m largesteps_torch.benchmarks.stale_bins [--subdiv 7]
        [--target-subdiv 7] [--views 13] [--res 256] [--steps 60]
        [--checks 8] [--device cuda]

The large-F path bins the faces on the host with a margin of 4 px and
rebins when a step's measured screen displacement since the bins
passes margin/2 (read one step late) or every 16 steps.  A step that moved
a vertex more than margin/2 may render with bins that miss a face.  This
runs the leg (``largesteps_torch.profiling``'s ``LARGE_F_PARAMS``; at the
defaults ``large_f_scene``'s icosphere-7, 327,680 faces, fitted to gourd-7
in 13 views of 256²) through the driver's own step and rebin policy, with
the host bins forced on at any size, and at each of the first ``--checks``
steps whose displacement passed margin/2 rasterizes the vertices that step
rendered twice with the ``raster_fwd`` kernel: once on the step's own
(stale) bins and once on fresh ``bin_triangles_device`` bins of those
vertices.  Prints one JSON line a check (the displacement, the pixels
whose face id differs, those the stale bins leave uncovered or cover with
another face) and one line of totals, each naming the device.
"""
from __future__ import annotations

import argparse
import json

import torch

from .._device import resolve_device
from ..io.synth import make_scene
from . import device_name

__all__ = ["main"]


def fids(renderer, topology, v_render, bins, counts):
    """Face ids (C, H, W) of v_render rasterized on (bins (C, T, cap),
    counts (C, T))."""
    from ..render import kernels
    from ..render.camera import project
    from ..render.pipeline import setup_from_bins
    h, w = renderer.res
    ty, tx = h // kernels.TILE_H, w // kernels.TILE_W
    faces, opp = topology.dense_tables(renderer.device)
    v_ndc = project(v_render, renderer.mvps)
    attrs = torch.zeros_like(v_render)
    rfb, _ = setup_from_bins(v_ndc, faces, attrs, opp, bins, h, w)
    C, cap = bins.shape[0], bins.shape[-1]
    c3 = counts.reshape(C, ty, tx).to(torch.int32).contiguous()
    return kernels.raster_fwd(rfb.reshape(C, ty, tx, cap, 32).contiguous(),
                              c3, renderer.res)[3]


def measure(scene, p, dev, steps, max_checks):
    """Run ``steps`` steps of the driver on ``scene`` with params ``p``
    (defaults filled in) on ``dev``; check the first ``max_checks`` steps
    that moved past margin/2.  Returns (check lines, the rebin record)."""
    from ..driver.bins import rebin_record
    from ..driver.optimize_shape import _prepare
    from ..render.camera import project
    from ..render.pipeline import bin_triangles_device, suggest_cap
    run = _prepare(scene, p, dev)
    rebins, renderer, theta = run.st.bins, run.renderer, run.theta
    half = 0.5 * float(p["rebin_margin"])
    counts = rebin_record()
    v_last, checks = None, []
    for it in range(steps):
        rebins.before(it, v_last, theta["tr"], counts)
        tr = theta["tr"].detach().clone()
        bins_used = rebins.tensors
        _, v_last, disp, _ = run.step()
        rebins.after(it, disp)
        d = float(disp)
        if d <= half or len(checks) >= max_checks:
            continue
        with torch.no_grad():
            v_render = tr + v_last[rebins.dup_dev]
            _, _, _, occ = bin_triangles_device(
                project(v_render, renderer.mvps), rebins.faces_dev,
                renderer.res, rebins.cap, margin=float(p["rebin_margin"]))
            cap = max(rebins.cap, suggest_cap(int(occ)))
            fb, fc, _, _ = bin_triangles_device(
                project(v_render, renderer.mvps), rebins.faces_dev,
                renderer.res, cap, margin=float(p["rebin_margin"]))
            stale = fids(renderer, rebins.topology, v_render, *bins_used[:2])
            fresh = fids(renderer, rebins.topology, v_render, fb, fc)
        diff = stale != fresh
        checks.append({
            "step": it, "disp_px": d, "margin_px": p["rebin_margin"],
            "stale_cap": int(bins_used[0].shape[-1]), "fresh_cap": cap,
            "fresh_occupancy": int(occ), "pixels": int(stale.numel()),
            "covered_fresh": int((fresh > 0).sum()),
            "differ": int(diff.sum()),
            "uncovered_stale": int((diff & (stale == 0)).sum()),
            "other_face_stale": int((diff & (stale > 0)).sum())})
    return checks, counts


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--target-subdiv", type=int, default=7)
    ap.add_argument("--views", type=int, default=13)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--checks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from ..driver.optimize_shape import default_params
    from ..profiling import LARGE_F_PARAMS
    p = {**default_params(), **LARGE_F_PARAMS, "host_bin_faces": 0}
    scene = make_scene(source=("icosphere", args.subdiv),
                       target=("gourd", args.target_subdiv),
                       n_views=args.views, res=args.res, seed=args.seed)
    checks, counts = measure(scene, p, dev, args.steps, args.checks)
    base = {"device": device_name(dev), "faces": 20 * 4 ** args.subdiv,
            "views": args.views, "res": args.res}
    lines = [{**base, "leg": "check", **c} for c in checks]
    lines.append({
        **base, "leg": "total", "steps": args.steps,
        "rebins": counts["rebin_n"], "rebin_steps": counts["rebin_steps"],
        "checks": len(checks),
        "differ_total": sum(c["differ"] for c in checks),
        "steps_with_differing_pixels": [c["step"] for c in checks
                                        if c["differ"]]})
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
