"""Where a step spends its time on the card, and the timers and roofline.

    python -m largesteps_torch.profiling [--steps 10] [--trace DIR]
        [--large-f | --dense]

Port of ``largesteps_tpu/profiling.py`` (``trace``, ``time_fn``,
``Roofline``, ``roofline``, ``CHIP_SPECS``, with the H100's peaks in place
of the TPUs'), and the step profiler.  The profiler builds the main-path
scene (the ``bench.py:bench_step`` slice: icosphere-4 fitted to gourd-4, 13
views at 256², shaded, boost 3, λ = 19, l2 loss, AdamUniform); with
``--large-f`` the large-F scene (the teaser's ``nefertiti`` ``ours`` leg:
icosphere-7, 327,680 faces, fitted to gourd-7, 13 views at 256², boost 3,
α = 0.98, l1 loss, AdamUniform at 2e-3, through host bins, the banded
solver and the prebinned pipe); with ``--dense`` the main path's scene at
13 views of 250², a size that does not tile, which the dense renderer draws
(``chip_smoke.py``'s ``dense_path``).  It warms the step up, then runs
``--steps`` steps under :func:`trace` and prints one JSON line:

* ``wall_ms_per_step``: host clock around the profiled steps, ending in
  ``torch.cuda.synchronize()`` (the profiler's own overhead included);
* ``device_ms_per_step`` and ``device_busy``: the summed duration of every
  CUDA kernel and memory operation in the trace, per step and as a share
  of the wall time;
* ``spans``: per layer of the step (the ``record_function`` ranges of
  ``driver/optimize_shape.py``: solve, normals, render, loss, backward,
  optimizer, displacement, rebin; and inside ``render`` the dense
  renderer's forward stages, ``Renderer._render_dense``: zbuffer,
  interpolate, shade, antialias), its host ms and the device ms of the
  kernels it launched (a kernel counts in the innermost range around its
  launch, so ``render`` keeps only what its stages do not hold);
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
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_leaves

from ._device import resolve_device
from .driver.optimize_shape import _prepare, _Rebins, default_params
from .io.synth import make_scene

__all__ = ["trace", "time_fn", "Roofline", "roofline", "CHIP_SPECS",
           "main_path_scene", "MAIN_PATH_PARAMS", "large_f_scene",
           "LARGE_F_PARAMS", "DENSE_RES", "profile_main_path"]

# Spec-sheet peaks of the NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit
# (NVIDIA's data sheet): float32 outside the tensor cores, bf16 on the
# tensor cores without sparsity, HBM3 bandwidth.  A card set to a lower
# power limit runs below them.
CHIP_SPECS = {
    "h100": {"fp32_tflops": 67.0, "bf16_tflops": 989.4, "hbm_gbps": 3350.0},
}


@contextlib.contextmanager
def trace(logdir=None, name: str = "trace"):
    """Profile the block with ``torch.profiler`` (host, and the card's
    kernels and copies where there is a card) and export a Chrome trace to
    ``<logdir>/<name>.json`` (``logdir`` default: a new temporary
    directory).  Yields that path; the file exists once the block ends."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or tempfile.mkdtemp(prefix="ls_torch_trace_")
    path = os.path.join(logdir, name + ".json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(path)


def _sync(out):
    """Wait for every device that holds a tensor of ``out``."""
    for dev in {t.device for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds a call of ``fn(*args)``: ``warmup`` calls, then
    ``iters`` calls on the host clock, each end waiting for the devices of
    the outputs."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


@dataclass
class Roofline:
    seconds: float
    flops: float
    bytes: float
    achieved_tflops: float
    achieved_gbps: float
    flops_fraction: float
    bandwidth_fraction: float
    bound: str

    def __str__(self):
        return (
            f"{self.seconds*1e3:.3f} ms | {self.achieved_tflops:.2f} TFLOP/s "
            f"({100*self.flops_fraction:.1f}% peak) | {self.achieved_gbps:.1f} GB/s "
            f"({100*self.bandwidth_fraction:.1f}% peak) | {self.bound}-bound"
        )


def roofline(fn, *args, flops: float, bytes_moved: float,
             chip: str = "h100", iters: int = 10) -> Roofline:
    """Time ``fn`` (:func:`time_fn`) and place it against the chip's
    float32 and memory peaks: the achieved rates, their shares of the
    peaks, and which one bounds it (arithmetic intensity against the ridge
    point)."""
    spec = CHIP_SPECS[chip]
    dt = time_fn(fn, *args, iters=iters)
    tflops = flops / dt / 1e12
    gbps = bytes_moved / dt / 1e9
    ai = flops / max(bytes_moved, 1.0)
    ridge = spec["fp32_tflops"] * 1e12 / (spec["hbm_gbps"] * 1e9)
    return Roofline(
        seconds=dt, flops=flops, bytes=bytes_moved,
        achieved_tflops=tflops, achieved_gbps=gbps,
        flops_fraction=tflops / spec["fp32_tflops"],
        bandwidth_fraction=gbps / spec["hbm_gbps"],
        bound="compute" if ai > ridge else "memory",
    )

MAIN_PATH_PARAMS = {"step_size": 0.03, "lambda": 19.0, "boost": 3,
                    "loss": "l2", "optimizer": "AdamUniform"}
# figures/teaser/generate_data.py:19-23, the ``ours`` leg; every other
# setting at the driver's defaults
LARGE_F_PARAMS = {"boost": 3, "alpha": 0.98, "loss": "l1", "smooth": True,
                  "step_size": 2e-3, "optimizer": "AdamUniform"}
SPANS = ("solve", "normals", "render", "loss", "backward", "optimizer",
         "displacement", "rebin", "zbuffer", "interpolate", "shade",
         "antialias")
DENSE_RES = 250         # does not tile into 32×128 pixels: the dense path
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def main_path_scene(n_views: int = 13, seed: int = 0, res: int = 256):
    """The scene of ``bench.py:bench_step`` (``res`` 256; the dense path
    draws it at ``DENSE_RES``)."""
    return make_scene(source=("icosphere", 4), target=("gourd", 4),
                      n_views=n_views, res=res, seed=seed)


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
        # the innermost range: the last to start of those around the launch
        inside = [n for lo, hi, n in ranges
                  if ts is not None and lo <= ts <= hi]
        dev_span[inside[-1] if inside else "other"] += d["dur"]
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
                      device=None, large_f: bool = False,
                      dense: bool = False) -> dict:
    """Profile ``steps`` steady steps of the main path, of the large-F path
    with ``large_f`` or of the dense path with ``dense`` (see module
    doc)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profiling measures the card; no CUDA device")
    if large_f and dense:
        raise ValueError("large_f or dense, not both")
    p = default_params()
    p.update(LARGE_F_PARAMS if large_f else MAIN_PATH_PARAMS)
    path_name = "large_f" if large_f else "dense" if dense else "main_path"
    scene = large_f_scene() if large_f else main_path_scene(
        res=DENSE_RES if dense else 256)
    run = _prepare(scene, p, dev)
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
    with trace(trace_dir, path_name + "_trace") as path:
        t0 = time.perf_counter()
        loop(range(warmup, warmup + steps))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(path) as fh:
        summary = _summarize(json.load(fh), steps, wall)
    summary["trace"] = path if trace_dir else None
    summary["card"] = torch.cuda.get_device_name(dev)
    summary["path"] = path_name
    summary["backend"] = run.renderer.backend
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
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--large-f", action="store_true",
                       help="profile the large-F path (nefertiti) instead")
    which.add_argument("--dense", action="store_true",
                       help=f"profile the dense path (13 views of "
                            f"{DENSE_RES}²) instead")
    args = ap.parse_args(argv)
    print(json.dumps(profile_main_path(args.steps, trace_dir=args.trace,
                                       large_f=args.large_f,
                                       dense=args.dense)), flush=True)


if __name__ == "__main__":
    main()
