"""The experiment harness of the figures, on the port.

Port of ``figures/common.py``: run one configuration of the driver on a
named synthetic stand-in scene and write its final mesh (``<name>_final.ply``),
its loss curve (``<name>_loss.csv``: iteration, im_loss, reg_loss) and its
metrics (``<name>_metrics.csv``: hausdorff, iters, wall_time_s, iters_per_s,
rebin_s, rebin_n, setup_s, first_step_s) under ``OUTPUT_DIR/<subdir>``; a
run that remeshes also prints each remesh's record and each topology
epoch's steps and rate as JSON lines.
``OUTPUT_DIR`` is ``LS_OUTPUT_DIR`` or ``largesteps_torch/figures/output``
(the JAX experiments' results stay in ``figures/output``).
"""
from __future__ import annotations

import csv
import json
import os

from ..driver import optimize_shape
from ..io.ply import write_ply
from ..io.synth import make_scene
from ..metrics import symmetric_hausdorff

__all__ = ["OUTPUT_DIR", "SCENES", "run", "epochs", "cli"]

OUTPUT_DIR = os.environ.get(
    "LS_OUTPUT_DIR", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "output"))

# The named stand-in scenes of figures/common.py:31-48: roughly the
# reference's scales (suzanne ~7.8k verts, nefertiti 100k+), synthesized
# since the reference's assets are a separate download.
SCENES = {
    "suzanne":  dict(source=("icosphere", 4), target=("gourd", 4),      n_views=13, res=256),
    "bunny":    dict(source=("icosphere", 4), target=("gourd", 5),      n_views=13, res=256),
    "bob":      dict(source=("icosphere", 4), target=("torus", 48),     n_views=13, res=256),
    "tshirt":   dict(source=("icosphere", 4), target=("supershape", 4), n_views=13, res=256),
    "cranium":  dict(source=("icosphere", 4), target=("supershape", 6), n_views=13, res=256),
    "planck":   dict(source=("icosphere", 4), target=("supershape", 5), n_views=13, res=256),
    # the north star's scale: icosphere-7, 163,842 verts
    "nefertiti": dict(source=("icosphere", 7), target=("gourd", 7),     n_views=13, res=256),
    # the remesh leg's start, one subdivision coarser, so that the h/2
    # remesh at step 250 lands near 163k verts
    "nefertiti_coarse": dict(source=("icosphere", 6), target=("gourd", 7), n_views=13, res=256),
    "dragon":   dict(source=("icosphere", 4), target=("supershape", 5), n_views=13, res=256),
}


def epochs(result):
    """Each topology epoch of a driver run: its steps, faces, seconds on the
    host clock between the remeshes (the first step's included) and it/s,
    from ``prof["remeshes"]``."""
    events = result["prof"]["remeshes"]
    bounds = [0] + [e["it"] for e in events] + [result["iters"]]
    starts = [0.0] + [e["wall_at"] + e["seconds"] for e in events]
    ends = [e["wall_at"] for e in events] + [result["wall_time"]]
    out = []
    for k in range(len(bounds) - 1):
        n, s = bounds[k + 1] - bounds[k], ends[k] - starts[k]
        out.append({"steps": n, "faces": int(len(result["f"][k])), "s": s,
                    "it_per_s": n / s if n else None})
    return out


def run(name, scene_name, params, out_subdir, device=None):
    """Run one configuration on ``device`` (the card unless the caller asks
    for the CPU) on the scene ``scene_name`` of SCENES, or on the scene of
    a dict of ``make_scene`` arguments; write its final mesh, loss CSV and
    metrics CSV.  Returns (the driver's result, the symmetric Hausdorff
    distance to the target)."""
    os.makedirs(os.path.join(OUTPUT_DIR, out_subdir), exist_ok=True)
    spec = SCENES[scene_name] if isinstance(scene_name, str) else scene_name
    scene = make_scene(**spec)
    result = optimize_shape(scene, params, device=device)

    base = os.path.join(OUTPUT_DIR, out_subdir, name)
    write_ply(base + "_final.ply", result["v_final"], result["f_final"])
    with open(base + "_loss.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["iteration", "im_loss", "reg_loss"])
        for i, (im, reg) in enumerate(result["losses"]):
            w.writerow([i, im, reg])

    d = symmetric_hausdorff(
        result["v_final"], result["f_final"],
        scene["mesh-target"]["vertices"], scene["mesh-target"]["faces"],
    )
    prof = result.get("prof", {})
    it_s = result["iters"] / max(result["wall_time"], 1e-9)
    with open(base + "_metrics.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["hausdorff", "iters", "wall_time_s", "iters_per_s",
                    "rebin_s", "rebin_n", "setup_s", "first_step_s"])
        w.writerow([d, result["iters"], result["wall_time"], it_s,
                    prof.get("rebin_s", 0.0), prof.get("rebin_n", 0),
                    prof.get("setup_s", 0.0), prof.get("first_step_s", 0.0)])
    print(f"[{out_subdir}/{name}] hausdorff={d:.5f} "
          f"iters={result['iters']} ({it_s:.1f} it/s, "
          f"rebins={prof.get('rebin_n', 0)})", flush=True)
    if prof.get("remeshes"):
        tag = f"{out_subdir}/{name}"
        for event in prof["remeshes"]:
            print(json.dumps({"run": tag, "remesh": event}), flush=True)
        print(json.dumps({"run": tag, "epochs": epochs(result)}), flush=True)
    return result, d


def cli(argv, description):
    """The experiments' command line: ``--quick`` (a short run of each leg),
    ``--only NAME`` and ``--device`` (default ``cuda``)."""
    import argparse
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)
