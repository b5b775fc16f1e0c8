"""The readings a cell's limits are set from (not run by the benchmark).

    python3 -m perfbench.calibrate --workload NAME --seeds S1 S2 ... \\
        [--seconds S] [--sides program,control,half_views,roll_row,freeze]

For each seed it runs the cell as ``run.py`` does (a short window) and
prints one JSON line: the five numbers (``check.py``) of each side put in
the program's place against the reference (the program itself, the
control: the reference computed in TF32, ``reference.tf32``, and the
planted faults of ``reference.FAULTS``: half of the views left out of the
loss, every view's image a row off, the state left unchanged), each at the
seed's scene and at the program's own last-step parameters; the numbers
read for the record (``check.record``); and, as a
second witness of the last step, the program's renderer on fresh bins
sized for those parameters (``witness``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, reference, run as bench
from .reference import leaf_gap

SIDES = ("program", "control", "half_views", "roll_row", "freeze")


def norms(g):
    return {k: float(torch.linalg.vector_norm(x.double())) for k, x in
            g.items()}


def witness(keep, device):
    """The last step's image loss and gradients by the program's renderer
    on bins made for that step's vertices (traced bins, the cap grown to
    fit), and the program's own solve (none on a coordinate leg)."""
    from largesteps_torch.core.solvers import solve
    from largesteps_torch.core.sparse import coo_matvec
    from largesteps_torch.driver.optimize_shape import (_prepare,
                                                        default_params)
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    p = {**default_params(), **keep["params"], "host_bin_faces": 10 ** 9}
    runp = _prepare(keep["scene"], p, torch.device(device))
    st, rd = runp.st, runp.renderer
    th = keep["theta_last"]
    u = th["u"].clone().requires_grad_(True)
    tr = th["tr"].clone().requires_grad_(True)
    v = solve(st.solver, u) if p["smooth"] else u
    fu = torch.as_tensor(st.f_unique.astype(np.int64), device=device)
    dup = torch.as_tensor(st.duplicate_idx.astype(np.int64), device=device)
    n = compute_vertex_normals(v, fu, compute_face_normals(v, fu))[dup]
    vr = tr + v[dup]
    occ = rd.check_overflow(vr.detach(), st.topology)
    imgs = rd.render(vr, n, st.topology)
    im = (imgs - runp.ref_imgs).abs().mean()
    total = im
    if p["reg"]:
        Lv = coo_matvec(st.L, v)
        total = im + p["reg"] * (Lv.square().mean() if p["bilaplacian"]
                                 else (v * Lv).mean())
    gu, gt = torch.autograd.grad(total, (u, tr))
    return {"loss": float(im.detach()), "occupancy": int(occ),
            "cap": rd.bin_cap, "grad": {"tr": gt, "u": gu}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sides", default=",".join(SIDES))
    ap.add_argument("--witness", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--roots", nargs="*", default=[],
                    help="more directories of cells, searched first")
    args = ap.parse_args(argv)
    sides = args.sides.split(",")
    dev = args.device
    roots = (*args.roots, bench.HERE)
    for seed in args.seeds:
        t0 = time.perf_counter()
        keep = {}
        code, result = bench.run(bench.parse(
            ["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds)]), keep=keep, device=dev,
            require_card=dev == "cuda", roots=roots)
        if result is None:
            return code
        ref = reference.Reference(keep["scene"], keep["params"], dev)
        r3 = check.side_outputs(ref, keep["theta_last"], check.FOLLOW)
        out, prof = keep["out"], keep["prof"]
        line = {"workload": args.workload, "seed": seed,
                "card": torch.cuda.get_device_name(0) if dev == "cuda"
                else "cpu",
                "correct": result["correct"], "steps": result["attempted"],
                "prof": {k: prof.get(k) for k in (
                    "rebin_n", "bin_cap", "max_window_disp_px", "setup_s",
                    "ref_render_s", "topology_s", "host_bins_s",
                    "factor_s")},
                "losses": [out["losses"][:3], r3["losses"]],
                "loss_last": [out["loss_last"], r3["loss_last"]],
                "norms": {"grad0": [norms(out["grad0"]),
                                    norms(r3["grad0"])],
                          "grad_last": [norms(out["grad_last"]),
                                        norms(r3["grad_last"])]}}
        if args.witness:
            w = witness(keep, dev)
            line["witness"] = {
                "loss": w["loss"], "occupancy": w["occupancy"],
                "cap": w["cap"],
                "loss_gap": abs(w["loss"] - r3["loss_last"])
                / r3["loss_last"],
                "grad_gap": leaf_gap(w["grad"], r3["grad_last"]),
                "grad_norms": norms(w["grad"])}
        for side in sides:
            if side == "program":
                nums, o = keep["numbers"], out
            else:
                s = reference.Reference(
                    keep["scene"], keep["params"], dev,
                    lowp=side == "control",
                    fault=None if side == "control" else side)
                o = check.side_outputs(s, keep["theta_last"], check.FOLLOW)
                nums = check.numbers(o, keep["ref_out"], ref)
                del s
            line[side] = {**nums, **check.record(o, r3)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
