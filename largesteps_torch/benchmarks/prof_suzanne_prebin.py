"""The main path's step with traced bins against bins made once per rebin
window.

    python -m largesteps_torch.benchmarks.prof_suzanne_prebin [--steps 120]
        [--subdiv 4] [--views 13] [--res 256] [--device cuda]

Port of ``benchmarks/prof_suzanne_prebin.py``: three runs of the port's
``optimize_shape`` on the main path's scene (icosphere-4 to gourd-4, 13
views of 256²; step size 0.05, λ = 19, boost 3, the Cholesky solver):
``traced`` (the main path: bins made every step), ``prebin`` (host bins
with the 4 px margin, rebinned by the driver's policy:
``host_bin_faces`` 1) and ``prebin_cull`` (those bins without back faces:
``cull_backfaces``).  Each prints one JSON line, naming the device: its
steady it/s (the first step left out), first step, rebins and their
seconds, and last loss.  Had the prebinned runs been faster, every mesh on
the tile kernels could bin once a rebin window.
"""
from __future__ import annotations

import argparse
import json

from .._device import resolve_device
from ..driver import optimize_shape
from ..io.synth import make_scene
from . import device_name

__all__ = ["main", "LEGS"]

LEGS = (("traced", {}),
        ("prebin", {"host_bin_faces": 1}),
        ("prebin_cull", {"host_bin_faces": 1, "cull_backfaces": True}))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--views", type=int, default=13)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scene = make_scene(source=("icosphere", args.subdiv),
                       target=("gourd", 4), n_views=args.views, res=args.res)
    base = {"steps": args.steps, "step_size": 0.05, "lambda": 19.0,
            "boost": 3, "solver": "Cholesky"}
    lines = []
    for tag, extra in LEGS:
        r = optimize_shape(scene, {**base, **extra}, device=dev)
        prof = r["prof"]
        post = max(r["wall_time"] - prof["first_step_s"], 1e-9)
        line = {"device": device_name(dev), "leg": tag,
                "faces": int(len(scene["mesh-source"]["faces"])),
                "it_per_s_sustained": (r["iters"] - 1) / post,
                "first_step_s": prof["first_step_s"],
                "rebin_n": prof["rebin_n"], "rebin_s": prof["rebin_s"],
                "loss_last": float(r["losses"][-1][0])}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
