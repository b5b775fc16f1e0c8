"""Micro-benchmark: the device rebin of the large-F path and its parts.

    python -m largesteps_torch.benchmarks.micro_rebin [--subdiv 7]
        [--views 13] [--res 256] [--cap 52992] [--device cuda]

Port of ``benchmarks/micro_rebin.py``: at nefertiti's scale (icosphere-7,
327,680 faces, 13 turntable views of 256², cap 52,992, margin 4 px) the
whole :func:`largesteps_torch.render.pipeline.bin_triangles_device`, then
its sort alone, as the JAX script times it: a stable sort of each camera's
(13, 4F) keys (JAX's vmapped argsort) and one sort of all of them flat.
Prints one JSON line a leg, each naming the device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..io.synth import turntable_views
from ..ops.shapes import icosphere
from ..render.camera import build_mvps, persp_proj, project
from ..render.pipeline import bin_triangles_device
from . import device_name, time_ms

__all__ = ["main"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--views", type=int, default=13)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--cap", type=int, default=52992)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    v, f = icosphere(args.subdiv)
    mvps = build_mvps(persp_proj(45, 1.0, 0.1, 100.0),
                      np.stack(turntable_views(args.views)))
    v_ndc = project(torch.as_tensor(v, device=dev),
                    torch.as_tensor(mvps, device=dev))
    faces = torch.as_tensor(f.astype(np.int64), device=dev)
    res = (args.res, args.res)
    F = len(f)
    K = 4
    keys = torch.randint(0, 16 * 4096, (args.views, K * F),
                         generator=torch.Generator().manual_seed(args.seed),
                         dtype=torch.int64).to(dev)
    base = {"device": device_name(dev), "faces": F, "views": args.views,
            "res": args.res, "cap": args.cap}
    t = lambda fn: time_ms(fn, dev, n=args.reps, warmup=1)
    occ = int(bin_triangles_device(v_ndc, faces, res, args.cap,
                                   margin=4.0)[3])
    legs = (
        ("bin_device_full_ms", lambda: bin_triangles_device(
            v_ndc, faces, res, args.cap, margin=4.0)),
        ("sort_per_camera_ms",
         lambda: torch.sort(keys, dim=1, stable=True)),
        ("sort_flat_ms",
         lambda: torch.sort(keys.reshape(-1), stable=True)),
    )
    lines = []
    for name, fn in legs:
        line = {**base, "metric": name, "value": t(fn)}
        if name == "bin_device_full_ms":
            line["occupancy"] = occ
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
