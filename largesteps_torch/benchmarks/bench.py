"""End-to-end and component benchmarks of the port on one card.

    python -m largesteps_torch.benchmarks.bench [--device cuda]

The counterpart of the JAX package's ``bench.py``, with its metric names
and keys: one JSON line a metric, ``{"metric", "value", "unit",
"vs_baseline"}``, after a first line with the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  In order:

* ``from_differential_ms_{tier}_{n}v``: one solve of the ``"Cholesky"``
  solver at icosphere-4, 6 and 7 and of the ``"CG"`` solver at icosphere-7
  (λ = 19, cold starts), labelled with the tier that ran;
* ``raster_fwd_mpix_per_s``, ``raster_fwdbwd_mpix_per_s``: the renderer's
  forward, and forward and backward, at 13 views of 256² (icosphere-4);
* ``render_fwdbwd_ms_ablate_{none,aabwd,rbwd,scatter}``: the fused pipe's
  forward and backward with one backward stage zeroed
  (``RenderPipeline(ablate=)``); the difference to ``none`` is the stage's
  share;
* ``opt_iters_per_s_163842v_sustained``, ``nefertiti_first_step_s``,
  ``nefertiti_rebin_ms``, ``nefertiti_rebin_n``: the driver at icosphere-7
  (327,680 faces) fitted to gourd-4, 13 views of 256², λ = 19, step 0.05,
  the driver's default rebin policy;
* ``sharded_cg_163842v_<where>_ms`` beside ``cg_163842v_<one>_ms``: CG
  (λ = 19, tol 1e-5, cold) at icosphere-7 with its matvec's nonzeros
  sharded over 2 ranks (``parallel.tri_shard``), against one process;
  ``<where>`` says where the ranks ran: ``gpu2shared`` for 2 ranks on one
  card (gloo, host-staged), ``gpu2`` on two cards, ``cpu2`` on the CPU
  (the JAX package's line says ``cpu8virt``);
* last, ``opt_iters_per_s``: the hand-written ``bench_step`` (solve,
  normals, render, l2 loss, backward, AdamUniform at 0.03) on icosphere-4
  fitted to gourd-4, 3 warm-up and 50 timed steps, ``vs_baseline`` against
  the reference's 31.6 it/s.

Every time is the host clock around work that ends in
``torch.cuda.synchronize()``.  A failing benchmark stops the run with a
non-zero exit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core.geometry import compute_matrix
from ..core.optimize import AdamUniform
from ..core.parameterize import get_solver, to_differential
from ..core.solvers import solve
from ..io.synth import make_scene
from ..ops.normals import (compute_face_normals, compute_vertex_normals,
                           corner_segments)
from ..ops.shapes import icosphere
from ..render.camera import project
from ..render.pipeline import ABLATE, RenderPipeline
from ..render.renderer import Renderer, Topology
from ..render.sh import sh_eval

__all__ = ["bench_solve", "bench_raster", "bench_ablate",
           "bench_step_nefertiti", "bench_sharded_cg", "bench_step", "smi",
           "main",
           "REFERENCE_ITERS_PER_S"]

REFERENCE_ITERS_PER_S = 31.6  # BASELINE.md: mean of the 6 comparison scenes
ITERS = 20                    # calls a render timing


def _line(metric, value, unit, vs_baseline=None):
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, n, dev):
    """Host seconds of ``n`` calls of ``fn``, from a drained device to the
    end of the last call's device work."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(dev)
    return time.perf_counter() - t0


def smi() -> str:
    """The card's name and power limit, by nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _main_scene(n_views=13, res=256):
    return make_scene(source=("icosphere", 4), target=("gourd", 4),
                      n_views=n_views, res=res)


def _source(scene, renderer):
    """The source mesh on the device, its topology with the bins sized as
    the driver sizes them, and its vertex normals."""
    dev = renderer.device
    v = torch.as_tensor(scene["mesh-source"]["vertices"], device=dev)
    f = scene["mesh-source"]["faces"]
    topo = Topology(f)
    renderer.check_overflow(v, topo)
    with torch.no_grad():
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))
    return v, f, topo, n


def bench_solve(device=None):
    """One differentiable solve, chained as ``x ← solve(0.999 x + 0.001
    u)``: 50 solves (10 past 100k verts); the ``"Cholesky"`` solver at
    icosphere-4, 6 and 7, ``"CG"`` at 7."""
    dev = resolve_device(device)
    out = []
    for subdiv, method in ((4, "Cholesky"), (6, "Cholesky"), (7, "Cholesky"),
                           (7, "CG")):
        v, f = icosphere(subdiv)
        n = v.shape[0]
        M = compute_matrix(v, f, lambda_=19.0, device=dev)
        solver = get_solver(M, method)
        u = to_differential(M, torch.as_tensor(v, device=dev))
        iters = 50 if n < 100_000 else 10
        x = [u]

        def body():
            x[0] = solve(solver, x[0] * 0.999 + u * 0.001)

        body()                                    # warm-up
        ms = _seconds(body, iters, dev) / iters * 1e3
        out.append(_line(f"from_differential_ms_{solver.tier}_{n}v", ms,
                         "ms"))
        del solver, M, u, x
    return out


def bench_raster(n_views=13, res=256, device=None):
    """The renderer's forward, and forward and backward, in Mpix/s."""
    dev = resolve_device(device)
    scene = _main_scene(n_views, res)
    renderer = Renderer(scene, shading=True, boost=3, device=dev)
    v, _, topo, n = _source(scene, renderer)
    mpix = n_views * res * res / 1e6

    def fwd():
        with torch.no_grad():
            renderer.render(v, n, topo)

    def fwdbwd():
        x = v.detach().requires_grad_(True)
        renderer.render(x, n, topo).mean().backward()

    out = []
    for name, fn in (("raster_fwd_mpix_per_s", fwd),
                     ("raster_fwdbwd_mpix_per_s", fwdbwd)):
        fn()                                      # warm-up
        ms = _seconds(fn, ITERS, dev) / ITERS * 1e3
        out.append(_line(name, mpix / ms * 1e3, "Mpix/s"))
    return out


def bench_ablate(n_views=13, res=256, device=None):
    """The fused pipe's forward and backward with each backward stage
    zeroed in turn, at the renderer's fitted cap."""
    dev = resolve_device(device)
    scene = _main_scene(n_views, res)
    renderer = Renderer(scene, shading=True, boost=3, device=dev)
    v, _, topo, n = _source(scene, renderer)
    with torch.no_grad():
        attrs = sh_eval(renderer.sh_M, n) / np.pi
        v_ndc = project(v, renderer.mvps)
    out = []
    for ablate in ("",) + ABLATE:
        pipe = RenderPipeline(topo.faces, topo.opp, renderer.res,
                              shading=True, boost=3.0, cap=renderer.bin_cap,
                              ablate=ablate)

        def fb():
            x = v_ndc.detach().requires_grad_(True)
            pipe(x, attrs, renderer.bgs).mean().backward()

        fb()                                      # warm-up
        ms = _seconds(fb, ITERS, dev) / ITERS * 1e3
        out.append(_line(f"render_fwdbwd_ms_ablate_{ablate or 'none'}", ms,
                         "ms"))
    return out


def bench_step_nefertiti(steps=40, device=None):
    """The driver at the north star's scale: icosphere-7 (163,842 verts,
    327,680 faces) fitted to gourd-4, 13 views of 256², the default
    ``"Cholesky"`` solver (its banded tier), host bins and the driver's
    default rebin policy.  ``_sustained`` is (steps − 1) / (wall − first
    step): everything a long run pays a step, rebins included, with the
    first step's one-time costs reported apart; ``nefertiti_rebin_ms`` is
    the host time of one rebin."""
    from ..driver import optimize_shape
    scene = make_scene(source=("icosphere", 7), target=("gourd", 4),
                       n_views=13, res=256)
    p = {"steps": steps, "step_size": 0.05, "lambda": 19.0, "boost": 3,
         "solver": "Cholesky"}
    r = optimize_shape(scene, p, device=device)
    prof = r["prof"]
    post = max(r["wall_time"] - prof["first_step_s"], 1e-9)
    return [
        _line("opt_iters_per_s_163842v_sustained", (r["iters"] - 1) / post,
              "iter/s"),
        _line("nefertiti_first_step_s", prof["first_step_s"], "s"),
        _line("nefertiti_rebin_ms",
              prof["rebin_s"] / max(prof["rebin_n"], 1) * 1e3, "ms"),
        _line("nefertiti_rebin_n", prof["rebin_n"], "count"),
    ]


def _cg_system(dev):
    v, f = icosphere(7)
    M = compute_matrix(v, f, lambda_=19.0, device=dev)
    return M, to_differential(M, torch.as_tensor(v, device=dev))


CG_REPEATS = 5


def _cg_ms(fn, dev):
    """Milliseconds of a call of ``fn``: the median of ``CG_REPEATS`` timed
    calls after a warm-up call (each solve waits on the host for its
    stopping tests, so one call's time swings with the host's load)."""
    fn()
    return float(np.median([_seconds(fn, 1, dev)
                            for _ in range(CG_REPEATS)])) * 1e3


def _sharded_cg_rank(rank, world, device):
    from ..parallel.distributed import global_mesh
    from ..parallel.tri_shard import sharded_cg_solve
    dev = torch.device(device)
    M, u = _cg_system(dev)
    mesh = global_mesh(1)
    return _cg_ms(lambda: sharded_cg_solve(M, u, mesh, tol=1e-5), dev)


def bench_sharded_cg(ranks=2, device=None):
    """Edge-sharded CG (``parallel.tri_shard.sharded_cg_solve``) at
    icosphere-7 over ``ranks`` ranks (the slowest rank's time), beside
    ``core.solvers.cg_solve`` in this process.  On one card the ranks share
    it and their halos go through host memory: the line tracks the sharded
    solve's correctness and cost, not a multi-card speed-up."""
    from ..core.solvers import cg_solve
    from ..parallel.distributed import launch
    dev = resolve_device(device)
    M, u = _cg_system(dev)
    one = _cg_ms(lambda: cg_solve(M, u, tol=1e-5), dev)
    del M, u
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        cards = torch.cuda.device_count()
        where = f"gpu{ranks}" + ("shared" if cards < ranks else "")
    else:
        where = f"cpu{ranks}"
    ms = max(launch(_sharded_cg_rank, ranks, device=dev.type,
                    args=(dev.type,), timeout=600.0))
    return [_line(f"sharded_cg_163842v_{where}_ms", ms, "ms"),
            _line(f"cg_163842v_{dev.type}1_ms".replace("cuda", "gpu"), one,
                  "ms")]


def bench_step(device=None):
    """The reference's equal-time workload as one hand-written step:
    solve → normals → render (13 views of 256², shaded, boost 3) → l2
    loss → backward → AdamUniform (lr 0.03), icosphere-4 fitted to
    gourd-4; 3 warm-up steps, then 50 timed."""
    dev = resolve_device(device)
    scene = _main_scene()
    renderer = Renderer(scene, shading=True, boost=3, device=dev)
    vt = torch.as_tensor(scene["mesh-target"]["vertices"], device=dev)
    ft = scene["mesh-target"]["faces"]
    with torch.no_grad():
        ref = renderer.render(vt, compute_vertex_normals(
            vt, ft, compute_face_normals(vt, ft)), Topology(ft))
    vs, fs, topo, _ = _source(scene, renderer)
    f_dev = torch.as_tensor(fs.astype(np.int64), device=dev)
    corners = corner_segments(f_dev, len(vs), dev)     # as the driver's
    M = compute_matrix(vs, fs, lambda_=19.0, device=dev)
    solver = get_solver(M, "Cholesky")
    theta = {"u": to_differential(M, vs).detach().requires_grad_(True),
             "tr": torch.zeros((1, 3), device=dev, requires_grad=True)}
    opt = AdamUniform([theta["tr"], theta["u"]], lr=0.03)
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        v = solve(solver, theta["u"])
        n = compute_vertex_normals(v, f_dev,
                                   compute_face_normals(v, f_dev, corners),
                                   corners)
        imgs = renderer.render(theta["tr"] + v, n, topo)
        loss = (imgs - ref).square().mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    for _ in range(3):                            # warm-up
        step()
    n_iters = 50
    it_s = n_iters / _seconds(step, n_iters, dev)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError("bench_step: non-finite loss")
    return _line("opt_iters_per_s", it_s, "iter/s",
                 it_s / REFERENCE_ITERS_PER_S)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(smi(), flush=True)
    lines = []
    for fn in (bench_solve, bench_raster, bench_ablate, bench_step_nefertiti,
               bench_sharded_cg):
        for line in fn(device=dev):
            print(json.dumps(line), flush=True)
            lines.append(line)
    line = bench_step(device=dev)
    print(json.dumps(line), flush=True)
    return lines + [line]


if __name__ == "__main__":
    main()
