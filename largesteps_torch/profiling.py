"""Where a step spends its time on the card.

    python -m largesteps_torch.profiling [--steps 10] [--trace DIR] [--large-f]

Builds the main-path scene (the ``bench.py:bench_step`` slice: icosphere-4
fitted to gourd-4, 13 views at 256², shaded, boost 3, λ = 19, l2 loss,
AdamUniform) or, with ``--large-f``, the large-F scene (the teaser's
``nefertiti`` ``ours`` leg: icosphere-7, 327,680 faces, fitted to gourd-7,
13 views at 256², boost 3, α = 0.98, l1 loss, AdamUniform at 2e-3, through
host bins, the banded solver and the prebinned pipe), warms the step up,
then runs ``--steps`` steps under ``torch.profiler`` and prints one JSON
line:

* ``wall_ms_per_step``: host clock around the profiled steps, ending in
  ``torch.cuda.synchronize()`` (the profiler's own overhead included);
* ``device_ms_per_step`` and ``device_busy``: the summed duration of every
  CUDA kernel and memory operation in the trace, per step and as a share
  of the wall time;
* ``spans``: per layer of the step (the ``record_function`` ranges of
  ``driver/optimize_shape.py``: solve, normals, render, loss, backward,
  optimizer, displacement, rebin), its host ms and the device ms of the
  kernels it launched;
* ``kernels``: the device ms per step of the heaviest kernels by name.

The large-F steps run inside the driver's rebin policy, as
``optimize_shape`` runs them: its rebins between steps (span ``rebin``,
counted in ``rebins``, their device ms each in ``rebin_device_ms_each``)
and its wait on the step ``max_inflight`` back are in the profiled
window.  Numbers are read from the exported Chrome trace
(``cat`` kernel, gpu_memcpy, gpu_memset, user_annotation,
gpu_user_annotation), which ``--trace`` keeps.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from ._device import resolve_device
from .driver.optimize_shape import _prepare, _Rebins, default_params
from .io.synth import make_scene

__all__ = ["main_path_scene", "MAIN_PATH_PARAMS", "large_f_scene",
           "LARGE_F_PARAMS", "profile_main_path"]

MAIN_PATH_PARAMS = {"step_size": 0.03, "lambda": 19.0, "boost": 3,
                    "loss": "l2", "optimizer": "AdamUniform"}
# figures/teaser/generate_data.py:19-23, the ``ours`` leg; every other
# setting at the driver's defaults
LARGE_F_PARAMS = {"boost": 3, "alpha": 0.98, "loss": "l1", "smooth": True,
                  "step_size": 2e-3, "optimizer": "AdamUniform"}
SPANS = ("solve", "normals", "render", "loss", "backward", "optimizer",
         "displacement", "rebin")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def main_path_scene(n_views: int = 13, seed: int = 0):
    """The scene of ``bench.py:bench_step``."""
    return make_scene(source=("icosphere", 4), target=("gourd", 4),
                      n_views=n_views, res=256, seed=seed)


def large_f_scene(n_views: int = 13, seed: int = 0):
    """The teaser's ``nefertiti`` scene (``figures/common.py:41``):
    icosphere-7 (163,842 verts, 327,680 faces) fitted to gourd-7."""
    return make_scene(source=("icosphere", 7), target=("gourd", 7),
                      n_views=n_views, res=256, seed=seed)


def _summarize(trace: dict, steps: int, wall_s: float) -> dict:
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"] in SPANS)
    host_span = defaultdict(float)
    for lo, hi, name in ranges:
        host_span[name] += hi - lo
    # device work belongs to the span whose host range holds its launch,
    # on whichever thread (the backward launches from autograd's thread)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    dev_span = defaultdict(float)
    for d in dev:
        ts = launch_ts.get(d.get("args", {}).get("correlation"))
        name = next((n for lo, hi, n in ranges
                     if ts is not None and lo <= ts <= hi), "other")
        dev_span[name] += d["dur"]
    per = 1e-3 / steps                              # µs total → ms a step
    busy_ms = sum(by_name.values()) * per
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_ms_per_step": busy_ms,
        "device_busy": busy_ms / (wall_s * 1e3 / steps),
        "device_events_per_step": len(dev) / steps,
        "spans": {s: {"host_ms": host_span[s] * per,
                      "device_ms": dev_span[s] * per}
                  for s in (*SPANS, "other")},
        "kernels": [{"name": n[:120], "ms_per_step": t * per}
                    for n, t in top],
    }


def profile_main_path(steps: int = 10, warmup: int = 5, trace_dir=None,
                      device=None, large_f: bool = False) -> dict:
    """Profile ``steps`` steady steps of the main path, or of the large-F
    path with ``large_f`` (see module doc)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profiling measures the card; no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    p = default_params()
    p.update(LARGE_F_PARAMS if large_f else MAIN_PATH_PARAMS)
    run = _prepare(large_f_scene() if large_f else main_path_scene(), p, dev)
    counts = {}
    rebins = _Rebins(run.st, p, run.renderer, run.theta, 0, counts)
    v_last = None

    def loop(its):
        nonlocal v_last
        for it in its:
            rebins.before(it, v_last)
            _, v_last, disp, _ = run.step()
            rebins.after(disp)

    loop(range(warmup))
    torch.cuda.synchronize()
    n_warm = counts["rebin_n"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(range(warmup, warmup + steps))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = trace_dir or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ("large_f" if large_f else "main_path")
                        + "_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        summary = _summarize(json.load(fh), steps, wall)
    summary["trace"] = path if trace_dir else None
    summary["card"] = torch.cuda.get_device_name(dev)
    summary["path"] = "large_f" if large_f else "main_path"
    summary["solver"] = run.st.solver.tier if run.st.solver else None
    summary["bin_cap"] = run.st.bin_cap if run.st.use_host_bins \
        else run.renderer.bin_cap
    summary["rebins"] = counts["rebin_n"] - n_warm
    summary["rebin_device_ms_each"] = (
        summary["spans"]["rebin"]["device_ms"] * steps / summary["rebins"]
        if summary["rebins"] else None)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default=None,
                    help="directory that keeps the Chrome trace")
    ap.add_argument("--large-f", action="store_true",
                    help="profile the large-F path (nefertiti) instead")
    args = ap.parse_args(argv)
    print(json.dumps(profile_main_path(args.steps, trace_dir=args.trace,
                                       large_f=args.large_f)), flush=True)


if __name__ == "__main__":
    main()
