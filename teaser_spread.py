"""How far runs of the teaser's ``ours`` leg at nefertiti part from each
other on the card, unsharded and sharded.

    python3 teaser_spread.py [--runs 5] [--sharded 2] [--fresh 3] [--steps 10]

On the card, prints one JSON line a run, then one line of spreads, then the
card's name and power limit:

* ``--runs`` unsharded runs of the leg (``largesteps_torch.profiling``'s
  ``LARGE_F_PARAMS`` on ``large_f_scene``, as ``chip_smoke.py``'s
  ``sharding`` phase runs it), each line with its losses, rebin steps,
  largest screen displacement in a bin window, final bin cap and the
  driver's warnings (an overflowing bin warns);
* ``--sharded`` runs of the same leg on two gloo ranks sharing the card at
  ``{"dp": 1, "sp": 2}``, with whether their final vertices are the same
  bits on both ranks;
* ``--fresh`` unsharded runs that rebin every step with a 16 px margin, so
  that no vertex moves past its bins' margin before the next rebin (the
  spans then exceed the device binning's, so every rebin is a host one);
* the spreads: for every pair of unsharded runs, every sharded run against
  every unsharded one, and every pair of fresh-bin runs, the largest
  relative loss difference over the steps and the first step at which it
  passes 1e-3.

Needs a card.
"""
import argparse
import itertools
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def leg(steps, sharding=None, fresh=False):
    """One run of the leg: its losses and what parts runs."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.profiling import LARGE_F_PARAMS, large_f_scene
    p = {**LARGE_F_PARAMS, "steps": steps}
    if fresh:
        p.update(rebin_every=1, rebin_margin=16.0)
    if sharding is not None:
        p["sharding"] = sharding
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = optimize_shape(large_f_scene(), p, device="cuda")
    prof = res["prof"]
    return {"losses": res["losses"][:, 0].tolist(),
            "v_final": res["v_final"],
            "rebin_steps": prof.get("rebin_steps", []),
            "max_window_disp_px": prof["max_window_disp_px"],
            "bin_cap": prof["bin_cap"],
            "warnings": sorted({str(w.message)[:120] for w in caught}),
            "s": time.perf_counter() - t0}


def sharded_rank(rank, world, steps):
    return leg(steps, {"dp": 1, "sp": 2})


def spread(a, b):
    """(largest relative difference, first step past 1e-3 or None)."""
    rel = np.abs(np.array(a) - np.array(b)) / np.abs(np.array(b))
    past = np.flatnonzero(rel > 1e-3)
    return float(rel.max()), int(past[0]) if len(past) else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sharded", type=int, default=2)
    ap.add_argument("--fresh", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("teaser_spread: no CUDA device", file=sys.stderr)
        return 1
    from largesteps_torch.parallel.distributed import launch
    out = {"unsharded": [], "sharded": [], "fresh": []}

    def emit(kind, r, **extra):
        line = {k: v for k, v in r.items() if k != "v_final"}
        print(json.dumps({"run": kind, **line, **extra}), flush=True)

    for _ in range(args.runs):
        out["unsharded"].append(leg(args.steps))
        emit("unsharded", out["unsharded"][-1])
    for _ in range(args.sharded):
        ranks = launch(sharded_rank, 2, device="cuda", timeout=300.0,
                       args=(args.steps,))
        same = all(np.array_equal(r["v_final"], ranks[0]["v_final"])
                   for r in ranks)
        out["sharded"].append(ranks[0])
        emit("sharded", ranks[0], same_on_every_rank=same)
    for _ in range(args.fresh):
        out["fresh"].append(leg(args.steps, fresh=True))
        emit("fresh", out["fresh"][-1])
    losses = {k: [r["losses"] for r in v] for k, v in out.items()}
    print(json.dumps({"spreads": {
        "unsharded_pairs": [spread(a, b) for a, b in
                            itertools.combinations(losses["unsharded"], 2)],
        "sharded_vs_unsharded": [spread(a, b) for a in losses["sharded"]
                                 for b in losses["unsharded"]],
        "fresh_pairs": [spread(a, b) for a, b in
                        itertools.combinations(losses["fresh"], 2)]}}),
        flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
