"""Where a step spends its time on the card, and the timers and roofline.

    python -m largesteps_torch.profiling [--steps 10] [--warmup 5]
        [--trace DIR] [--large-f | --dense]

Port of ``largesteps_tpu/profiling.py`` (``trace``, ``time_fn``,
``Roofline``, ``roofline``, ``CHIP_SPECS``, with the H100's peaks in place
of the TPUs'), and the step profiler.  The profiler builds the main-path
scene (the ``bench.py:bench_step`` slice: icosphere-4 fitted to gourd-4, 13
views at 256², shaded, boost 3, λ = 19, l2 loss, AdamUniform); with
``--large-f`` the large-F scene (the teaser's ``nefertiti`` ``ours`` leg:
icosphere-7, 327,680 faces, fitted to gourd-7, 13 views at 256², boost 3,
α = 0.98, l1 loss, AdamUniform at 2e-3, through host bins, the banded
solver, the prebinned pipe and the driver's rebins); with ``--dense`` the
main path's scene at 13 views of 250², a size that does not tile, which the
dense renderer draws (``chip_smoke.py``'s ``dense_path``).  It runs one
``optimize_shape`` call of ``--warmup`` + ``--steps`` steps with
``"trace": True`` (:mod:`largesteps_torch.spans`), under ``torch.profiler``
only with ``--trace DIR`` (which keeps the Chrome trace there), and prints
one JSON line over the last ``--steps`` steps:

* ``wall_ms_per_step``: host clock from the first counted step's start to
  the call's final drain of the card;
* ``spans``: per span name (the driver's step layers, ``pipe_setup``,
  ``pipe_scatter``, ``adjoint_solve``, ``rebin``, ``host_wait``, and on the
  dense path its forward stages), spans a step, host ms, self ms (host ms
  no child span covers) and stream ms (device end minus device start, from
  CUDA events) a step; on the main path the step's work replays from a
  CUDA graph after the first step, so its layers are one ``step_graph``
  span beside ``optimizer``;
* ``graph``: the call's CUDA-graph counts (``prof["graph"]``);
* ``host_waits``: per site, waits and host ms a step;
* ``setup``: the host seconds of the call's setup spans; ``rebins`` and
  ``rebin_routes`` in the counted steps and over the call.

Runs on the card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_leaves

from ._device import resolve_device
from .driver.optimize_shape import optimize_shape
from .io.synth import make_scene
from .spans import summarize

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
DENSE_RES = 250         # does not tile into 32×128 pixels: the dense path
# the Chrome trace's categories of the card's work (chip_smoke.py reads it)
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


def profile_main_path(steps: int = 10, warmup: int = 5, trace_dir=None,
                      device=None, large_f: bool = False,
                      dense: bool = False) -> dict:
    """Profile ``steps`` steps after ``warmup`` of the main path, of the
    large-F path with ``large_f`` or of the dense path with ``dense`` (see
    module doc)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profiling measures the card; no CUDA device")
    if large_f and dense:
        raise ValueError("large_f or dense, not both")
    path_name = "large_f" if large_f else "dense" if dense else "main_path"
    scene = large_f_scene() if large_f else main_path_scene(
        res=DENSE_RES if dense else 256)
    params = {**(LARGE_F_PARAMS if large_f else MAIN_PATH_PARAMS),
              "steps": warmup + steps, "trace": True}
    with (trace(trace_dir, path_name + "_trace") if trace_dir
          else contextlib.nullcontext()) as path:
        result = optimize_shape(scene, params, device=dev)
    prof = result["prof"]
    rec = prof["trace"]
    last = warmup + steps
    t_first = min(s["host"][0] for s in rec["spans"] if s["step"] == warmup)
    t_end = max(s["host"][1] for s in rec["spans"]
                if s["name"] == "host_wait" and s["site"] == "end")
    summary = summarize(rec, warmup, last)
    return {
        "card": torch.cuda.get_device_name(dev), "path": path_name,
        "steps": steps, "warmup": warmup,
        "wall_ms_per_step": (t_end - t_first) * 1e3 / steps,
        "spans": summary["spans"], "host_waits": summary["host_waits"],
        "setup": {s["name"]: s["host"][1] - s["host"][0]
                  for s in rec["spans"] if s["step"] is None
                  and s["name"].startswith("setup")},
        "rebins": sum(1 for k in prof["rebin_steps"] if warmup <= k < last),
        "rebin_routes": prof["rebin_routes"], "graph": prof["graph"],
        "backend": prof["backend"],
        "solver": prof.get("solver", {}).get("tier"),
        "bin_cap": prof["bin_cap"], "trace": path}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5,
                    help="steps run before the counted ones")
    ap.add_argument("--trace", default=None,
                    help="directory that keeps the Chrome trace")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--large-f", action="store_true",
                       help="profile the large-F path (nefertiti) instead")
    which.add_argument("--dense", action="store_true",
                       help=f"profile the dense path (13 views of "
                            f"{DENSE_RES}²) instead")
    args = ap.parse_args(argv)
    print(json.dumps(profile_main_path(args.steps, args.warmup,
                                       trace_dir=args.trace,
                                       large_f=args.large_f,
                                       dense=args.dense)), flush=True)


if __name__ == "__main__":
    main()
