"""Smoke run of the PyTorch/CUDA port (largesteps_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``largesteps_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, holds a
2-view render on the card against the same render on the CPU (and the
unfused ``render_core``, forward and backward, likewise), and runs the
main path (the ``bench.py:bench_step`` scene: icosphere-4 fitted to gourd-4,
13 views at 256², shaded, boost 3, λ = 19, l2 loss, AdamUniform) for 20
steps through the port's ``optimize_shape``.  Then the large-F path at the
teaser's nefertiti scale (icosphere-7, 327,680 faces, fitted to gourd-7, 13
views at 256²): each kernel against its plain version on the 13 views'
host bins at the run's cap, the batched and the camera-sequential prebinned
pipes against each other, and 20 steps of the teaser's ``ours`` leg
(boost 3, α = 0.98, l1, AdamUniform at 2e-3; host bins, device rebins, the
banded solver).  Between the two, the rasterizer micro-benchmarks' path:
``largesteps_torch.benchmarks`` (micro_scatter at the main path's and at
nefertiti's shape, probe_mosaic, bench_raster) with the launch counts of
their two kernels read around it, each of the two kernels against its
plain version (``probe_kernels``: onehot_scatter also on the slot table
of one main-path backward, as ``scatter_via_faces`` lays it out; each
kernel's time by CUDA events and its device time by ``torch.profiler``;
the launch shape of each); the dense renderer against the tile
kernels at 13 × 256² (``dense_render``); and 20 steps of the driver on the
bench_step scene at 13 × 250², which only the dense renderer draws
(``dense_path``).  Last, the fit quality on the card (``fit_quality``: the
comparison figure's three suzanne legs at full length through
``largesteps_torch.figures.common.run``, their symmetric Hausdorff distances
held to the JAX package's order, ours < bilaplacian < Laplacian
regularization), remeshing (``remesh``: the remeshing figure's two
remeshed cranium legs at full length, the multiscale figure's ``--quick``
leg, the teaser's ``ours_remesh`` leg to 20 steps past its remesh, and the
host Cholesky solver on the main path; each leg's epochs and their
launches), the iterative solvers (``solvers``: 20 main-path steps under
``"CG"`` beside ``"Cholesky"``; at nefertiti's matrix the block-AMG tier,
its dense-block matvec and CG against the banded tier; 20 steps of the
teaser's ``ours`` leg under ``"AMG"``; the cotangent Laplacian and its
gradient on the card against the CPU), sharding (``sharding``: the four
tile kernels in their row-shard mode against their plain versions; ranks
of ``torch.distributed`` sharing the card over gloo, spawned by
``largesteps_torch.parallel.distributed.launch``: sharded renders at sp = 2
and 4 against the unsharded one, and three driver legs, the main path
under ``"CG"``, the viewpoints figure's ``views_16_ours`` and the teaser's
``ours`` at nefertiti, beside their unsharded runs; one NCCL rank; two
NCCL ranks on the card, which NCCL must refuse), determinism
(``determinism``: every sum of a step is added in a fixed order, so
raster_bwd and aa_bwd launched twice on the same inputs, at the main
path's shapes and at nefertiti's cap, give the same bits, and so do two
runs each of the main path, the main path under ``"CG"``, the dense path
and the teaser's ``ours`` leg, in every loss and final vertex), the figure
experiments (``figures``: the ``--quick`` legs of
viewpoints, influence and reg_fail), the figures' mesh pictures (``vis``:
``render_mesh_image`` on the card against the CPU, the teaser mesh's panel
against the dense rasterizer, every mesh panel of the run's outputs; the
card's host has no matplotlib, so the figures are drawn elsewhere) and the
port's benchmark (``bench``:
the functions of ``largesteps_torch.benchmarks.bench``, the nefertiti
line at 10 steps, the sharded-CG lines), the tile kernels' launches
counted around each.  Prints one JSON line per phase, then the kernel
table, the card's name and power limit, and as the last line ``{"ok":
true, "device": {...}}``.  Exits non-zero, without the ``ok`` line, if
there is no CUDA device or any phase fails.  Imports neither jax nor
largesteps_tpu.

    python3 chip_smoke.py --only kernels,determinism

runs the ``card`` phase and the named phases alone, each with the earlier
phases whose runs it reuses (``NEEDS``), and prints no kernel table and no
``ok`` line.
"""
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from largesteps_torch.profiling import CHIP_SPECS  # noqa: E402

SEED = 0
STEPS = 20
# published H100 SXM peaks (profiling.CHIP_SPECS): HBM3 bytes/s, float32
# non-tensor FLOP/s; the card's power limit is printed beside every number
PEAK_BYTES = CHIP_SPECS["h100"]["hbm_gbps"] * 1e9
PEAK_F32 = CHIP_SPECS["h100"]["fp32_tflops"] * 1e12
# float ops counted per unit of work (from the arithmetic in csrc/*.cu):
FLOPS_Z_TEST = 22        # raster_fwd: one slot tested at one pixel
FLOPS_FINISH = 20        # raster_fwd: interpolation at a covered pixel
FLOPS_RBWD = 100         # raster_bwd: 18 gradient fields at a covered pixel
FLOPS_PAIR = 75          # antialias: the three-edge crossing of one pair
FLOPS_PAIR_BWD = 60      # aa_bwd: endpoint gradients of one pair
FLOPS_BLEND = 6          # antialias: blend of one channel of one pair
# record columns each kernel must read (render/pipeline.py column maps)
COLS_ZLOOP = 15          # raster_fwd: cols 0-14 of every live slot
COLS_FINISH = 9          # raster_fwd: colour cols 16-24 of each winning slot
COLS_RBWD = 22           # raster_bwd: cols 0-21 of each slot owning a pixel
COLS_SEARCH = 1          # antialias: the face id of every live slot
COLS_EDGE = 9            # antialias: sx sy ×3 and opp ×3 of each pair owner
COLS_RBWD_OUT = 18       # raster_bwd: the per-slot sums of every live slot
COLS_AA_OUT = 6          # aa_bwd: the per-slot endpoint sums
F32 = 4
# kernels redesigned for the H100 after their first port, and the PR that
# did it (their earlier times: PERF.md)
REDESIGNED = {"aa_fwd": "PR 2", "aa_bwd": "PR 2", "raster_fwd": "PR 3",
              "raster_bwd": "PR 3"}
# kernels whose per-slot sums are added in a fixed order (sorted keys, no
# float atomics): the same bits on every launch (phase determinism)
FIXED_ORDER = ("raster_bwd", "aa_bwd")
# runs kept for the determinism phase: name -> (losses, final vertices),
# the first of each pair that must be bit-equal; and the two launches of
# the fixed-order kernels on the same inputs, by shape
REPEATS = {}
TWICE = {}
# the earlier phases whose runs a phase reuses, which --only runs with it
NEEDS = {"determinism": ("kernels", "main_path", "dense_path",
                         "large_f_kernels", "sharding"),
         "vis": ("fit_quality", "remesh", "figures")}
# the micro-benchmarks' kernels: float ops a valid entry (onehot_scatter:
# one add a channel) and a covered pixel (probe_tile: 18 products, 18 adds)
FLOPS_PROBE_PIXEL = 36
PROBE_CAP = 256          # the JAX probe's tile (benchmarks/probe_mosaic.py)
# nefertiti's slot table of benchmarks/micro_scatter_163k.py:28-31, one
# camera: 16 · 52,992 slots into 327,680 faces and a sentinel, 18 columns
NEFERTITI_SCATTER = (1, 16 * 52_992, 327_681, 18)
# the JAX package's symmetric Hausdorff distances of the comparison's
# suzanne legs (figures/output/comparison/suzanne_*_metrics.csv), and the
# most the port's ours leg may reach: JAX's + 25 %
JAX_SUZANNE = {"ours": 0.1400882866213893, "bilapreg": 0.5068336390561687,
               "lapreg": 0.6095732026042789}
FIT_OURS_MAX = 1.25 * JAX_SUZANNE["ours"]


def emit(obj):
    print(json.dumps(obj), flush=True)
    if obj.get("passed") is False:
        # a failed check also on standard error, whose end outlives a long
        # standard output
        print(f"chip_smoke: failed {json.dumps(obj)[:800]}", file=sys.stderr,
              flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_ms(fn, reps, warm=2):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps):
    """Mean milliseconds of device work (kernels, memsets, copies) per call
    of ``fn`` over ``reps`` calls, by ``torch.profiler``'s trace of the card;
    None where the trace holds no device work."""
    from torch.profiler import ProfilerActivity, profile
    from largesteps_torch import _cuda
    from largesteps_torch.profiling import _DEVICE_CATS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    os.makedirs(_cuda._BUILD, exist_ok=True)
    path = os.path.join(_cuda._BUILD, f"device_ms_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(path)
    us = sum(e["dur"] for e in events
             if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    return us / reps / 1e3 if us > 0 else None


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def holds(name, got, want):
    """(passed, max-abs errors, max|want|, tolerance) of a kernel's outputs
    against its plain version's."""
    errs = [max_abs(a, b) for a, b in zip(got, want)]
    scales = [float(b.abs().max()) for b in want]
    if name == "raster_fwd":
        # ids exact; every plane within 1e-5 (built with -fmad=false, the
        # kernel rounds as the plain version does)
        tol = "fid and slot exact, planes 1e-5 abs"
        passed = errs[3] == 0.0 and errs[4] == 0.0 and max(errs) <= 1e-5
    elif name == "aa_fwd":
        tol = "1e-5 abs"
        passed = errs[0] <= 1e-5
    elif name == "raster_bwd":
        # per-slot sums: the kernel adds in slot-sorted pixel order, the
        # plain version in index_add_'s
        tol = "1e-4 x max|plain|"
        passed = errs[0] <= 1e-4 * scales[0]
    else:
        # d_color is of the order of the loss cotangent (about 1e-7 here),
        # so it is held relative to its own size
        tol = "d_color 1e-5 x max|plain|; per-slot sums 1e-4 x max|plain|"
        passed = errs[0] <= 1e-5 * scales[0] and errs[1] <= 1e-4 * scales[1]
    return passed, errs, scales, tol


def work(rbb, counts, fid, z, slot, res):
    """What this run's data needs the kernels to touch: live slots, slots
    that win a pixel, distinct antialias pair owners (each per tile), the
    z-tests of every live slot over the pixels of its unexpanded bbox inside
    its tile, covered pixels and pairs whose ids differ."""
    from largesteps_torch.render import kernels as K
    C, TY, TX, cap, _ = rbb.shape
    H, W = res
    dev = rbb.device
    live = torch.arange(cap, device=dev) < counts[..., None]
    tile = torch.arange(C * TY * TX, device=dev).reshape(C, TY, TX, 1)
    st = K._to_tiles(slot).long()
    winners = torch.unique((tile * cap + st)[st >= 0]).numel()
    owners, pairs = [], 0
    for nb in (K._shift_left, K._shift_up):
        own, _, dif = K._aa_common(fid, z, nb(fid), nb(z))
        act = K._to_tiles(dif & (own > 0))
        owners.append((tile * (2 ** 32) + K._to_tiles(own).long())[act])
        pairs += int(act.sum())
    owners = torch.unique(torch.cat(owners)).numel()

    def extent(ndc, n_pix, start, size):
        # pixel centres inside [min, max] of the corners, within the tile
        lo = torch.ceil((ndc.amin(-1) + 1.0) * (n_pix / 2.0) - 0.5) - start
        hi = torch.floor((ndc.amax(-1) + 1.0) * (n_pix / 2.0) - 0.5) - start
        return (hi.clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0)

    ty0 = (torch.arange(TY, device=dev) * K.TILE_H).float()[None, :, None,
                                                              None]
    tx0 = (torch.arange(TX, device=dev) * K.TILE_W).float()[None, None, :,
                                                              None]
    rows = extent(rbb[..., [10, 12, 14]], H, ty0, K.TILE_H)
    cols = extent(rbb[..., [9, 11, 13]], W, tx0, K.TILE_W)
    return {"live": int(live.sum()), "winners": winners, "owners": owners,
            "z_tests": float((rows * cols * live).sum()),
            "covered": float((fid > 0).sum()), "pairs": float(pairs),
            "pixels": float(fid.numel())}


def phase_card():
    from largesteps_torch import _cuda
    name = torch.cuda.get_device_name(0)
    line = smi()
    shutil.rmtree(_cuda._BUILD, ignore_errors=True)   # build from sources
    t0 = time.perf_counter()
    built = _cuda.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {k: _cuda.ptxas_info(k) for k in sorted(built)}
    emit({"phase": "card", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": line, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "build_s": build_s, "built": sorted(built), "ptxas": ptxas})
    return name, line, ptxas


def ran(info, key):
    """ptxas's registers, stack and spills of the entry that ran: the only
    one, or the instantiation whose mangled name holds ``key``."""
    entries = [e for e in info if len(info) == 1 or key in e]
    if len(entries) != 1:
        raise RuntimeError(f"no single ptxas entry among {sorted(info)}")
    r = info[entries[0]]
    return {"registers": r["registers"], "stack_bytes": r["stack_bytes"],
            "spill_stores": r["spill_stores"],
            "spill_loads": r["spill_loads"]}


def instance(name, cap, channels):
    """What the mangled name of the kernel ``name`` that runs at ``cap``
    with ``channels`` colour channels holds: the antialias kernels'
    channels (aa_bwd's sums kernel, aa_bwd_sums, has its own line);
    raster_bwd's one kernel."""
    if name == "raster_bwd":
        return "raster_bwd_kernel"
    return f"ILi{channels}E"


def micro_instance(name, launch):
    """What the mangled name of the micro-benchmark kernel that ran holds:
    probe_tile's one kernel; onehot_scatter's instantiation for the vector
    width of its plan (``launch_shape``)."""
    if name == "probe_tile":
        return "probe_tile_kernel"
    return f"ILi{launch['vector']}EE"


def main_path_inputs():
    """The kernels' inputs of one forward and backward of the main path on
    the card: bins of the source mesh in 13 views at 256², the forward
    planes, the composited colour, and the loss cotangent against the target
    render."""
    from largesteps_torch.render import kernels as K
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import setup_and_bin
    from largesteps_torch.render.renderer import Renderer, Topology
    from largesteps_torch.render.sh import sh_eval
    from largesteps_torch.profiling import main_path_scene
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    dev = torch.device("cuda")
    scene = main_path_scene(seed=SEED)
    r = Renderer(scene, shading=True, boost=3, device=dev)
    f = scene["mesh-source"]["faces"]
    topo = Topology(f)
    v = torch.as_tensor(scene["mesh-source"]["vertices"], device=dev)
    occ = r.check_overflow(v, topo)
    cap = r.bin_cap
    vt = torch.as_tensor(scene["mesh-target"]["vertices"], device=dev)
    ft = scene["mesh-target"]["faces"]
    with torch.no_grad():
        ref = r.render(vt, compute_vertex_normals(
            vt, ft, compute_face_normals(vt, ft)), Topology(ft))
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))
        faces = torch.as_tensor(f.astype(np.int64), device=dev)
        opp = torch.as_tensor(topo.opp.astype(np.int64), device=dev)
        v_ndc = project(v, r.mvps)
        attrs = sh_eval(r.sh_M, n) / np.pi
        rfb, rbb, bins, counts = setup_and_bin(v_ndc, faces, attrs, opp,
                                               256, 256, cap)
    res = r.res
    u, vv, z, fid, slot, c0, c1, c2 = K.raster_fwd(rfb, counts, res)
    cov = (fid > 0)[..., None]
    comp = torch.where(cov, torch.cat([torch.stack([c0, c1, c2], -1),
                                       cov.float()], -1), r.bgs).contiguous()
    img = K.aa_fwd(rbb, counts, fid, z, comp, res)
    d_out = (2.0 * (img - ref) / img.numel()).contiguous()
    d_comp, _ = K.aa_bwd(rbb, counts, fid, z, comp, d_out, res)
    d_col = torch.where(cov, d_comp[..., :3], 0.0).contiguous()
    torch.cuda.synchronize()
    return {"occ": occ, "cap": cap, "res": res, "rfb": rfb, "rbb": rbb,
            "counts": counts, "fid": fid, "z": z, "slot": slot,
            "comp": comp, "d_out": d_out, "d_col": d_col,
            "n_faces": f.shape[0], "bins": bins}


def host_bins(renderer, verts, faces, margin, **kw):
    """Host bins of (V, 3) vertices in the renderer's views, projected on
    the host as the driver projects them."""
    from largesteps_torch.render.pipeline import bin_triangles_host
    vh = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1)
    return bin_triangles_host(np.einsum("cij,vj->cvi",
                                        renderer.mvps.cpu().numpy(), vh),
                              faces, renderer.res, margin=margin, **kw)


def large_f_inputs():
    """The kernels' inputs of the large-F run's first forward and backward,
    at its shapes: the nefertiti source (327,680 faces) in 13 views at 256²,
    host bins at the driver's margin (4 px) and fitted cap as its epoch
    makes them, the forward planes, the composited colour and the l1 loss
    cotangent against the target rendered through its own host bins."""
    from largesteps_torch.render import kernels as K
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import setup_from_bins
    from largesteps_torch.render.renderer import Renderer, Topology
    from largesteps_torch.render.sh import sh_eval
    from largesteps_torch.profiling import large_f_scene
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    dev = torch.device("cuda")
    scene = large_f_scene(seed=SEED)
    r = Renderer(scene, shading=True, boost=3, device=dev)
    res = r.res
    f = scene["mesh-source"]["faces"]
    topo = Topology(f)
    vs = scene["mesh-source"]["vertices"]
    bins, counts, occ = host_bins(r, vs, f, 4.0)
    cap = bins.shape[-1]
    vt_np, ft = scene["mesh-target"]["vertices"], scene["mesh-target"]["faces"]
    tb, tc, _ = host_bins(r, vt_np, ft, 0.0)
    up = lambda a: torch.as_tensor(a, device=dev)
    v, vt = up(vs), up(vt_np)
    with torch.no_grad():
        ref = r.render(vt, compute_vertex_normals(
            vt, ft, compute_face_normals(vt, ft)), Topology(ft),
            bins=(up(tb).long(), up(tc)))
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))
        faces = up(f.astype(np.int64))
        opp = up(topo.opp.astype(np.int64))
        rfb, rbb = setup_from_bins(project(v, r.mvps), faces,
                                   sh_eval(r.sh_M, n) / np.pi, opp,
                                   up(bins).long(), *res)
    C, TY, TX = len(r.view_mats), res[0] // K.TILE_H, res[1] // K.TILE_W
    rfb = rfb.reshape(C, TY, TX, cap, 32)
    rbb = rbb.reshape(C, TY, TX, cap, 32)
    counts = up(counts).reshape(C, TY, TX)
    u, vv, z, fid, slot, c0, c1, c2 = K.raster_fwd(rfb, counts, res)
    cov = (fid > 0)[..., None]
    comp = torch.where(cov, torch.cat([torch.stack([c0, c1, c2], -1),
                                       cov.float()], -1), r.bgs).contiguous()
    img = K.aa_fwd(rbb, counts, fid, z, comp, res)
    d_out = (torch.sign(img - ref) / img.numel()).contiguous()
    d_comp, _ = K.aa_bwd(rbb, counts, fid, z, comp, d_out, res)
    d_col = torch.where(cov, d_comp[..., :3], 0.0).contiguous()
    torch.cuda.synchronize()
    return {"occ": occ, "cap": cap, "res": res, "rfb": rfb, "rbb": rbb,
            "counts": counts, "fid": fid, "z": z, "slot": slot,
            "comp": comp, "d_out": d_out, "d_col": d_col,
            "n_faces": f.shape[0]}


def check_kernels(m, card, phase, reps, plain_reps):
    """Each kernel against its plain version on the inputs ``m``: its
    time (the wrapper's call by CUDA events, and the kernel's device time
    by ``torch.profiler`` over ``reps`` calls), its plain version's (the
    mean of ``plain_reps`` calls, or with 0 the one call compared), its
    bound by this data's work, and the errors; returns (passed, {name: row
    of the kernels line})."""
    from largesteps_torch.render import kernels as K
    occ, cap, res, rfb, rbb, counts = (m[k] for k in ("occ", "cap", "res",
                                                      "rfb", "rbb", "counts"))
    fid, z, slot, comp, d_out, d_col = (m[k] for k in (
        "fid", "z", "slot", "comp", "d_out", "d_col"))
    zeros = torch.zeros_like(fid)

    w = work(rbb, counts, fid, z, slot, res)
    live, pix, D = w["live"], w["pixels"], comp.shape[-1]
    plane = pix * F32
    # bytes each function must move: the record columns it reads for the
    # slots this data needs, the planes in and out, the live rows of the
    # per-slot tables out (the layout's padding is not counted)
    cases = [
        ("raster_fwd", "largesteps_tpu/render/pallas_core.py:988",
         lambda: K.raster_fwd(rfb, counts, res),
         lambda: K.raster_fwd_plain(rfb, counts, res),
         (live * COLS_ZLOOP + w["winners"] * COLS_FINISH) * F32
         + nbytes(counts) + 8 * plane,
         FLOPS_Z_TEST * w["z_tests"] + FLOPS_FINISH * w["covered"],
         (rfb, counts)),
        ("aa_fwd", "largesteps_tpu/render/pallas_core.py:1635",
         lambda: K.aa_fwd(rbb, counts, fid, z, comp, res),
         lambda: K.aa_fwd_plain(rbb, counts, fid, z, comp, res),
         (live * COLS_SEARCH + w["owners"] * COLS_EDGE) * F32
         + nbytes(counts) + (2 + 2 * D) * plane,
         (FLOPS_PAIR + FLOPS_BLEND * D) * w["pairs"],
         (rbb, counts, fid, z, comp)),
        ("raster_bwd", "largesteps_tpu/render/pallas_core.py:1120",
         lambda: K.raster_bwd(rbb, counts, slot, d_col, zeros, zeros, res),
         lambda: K.raster_bwd_plain(rbb, counts, slot, d_col, zeros, zeros,
                                    res),
         (w["winners"] * COLS_RBWD + live * COLS_RBWD_OUT) * F32
         + nbytes(counts) + 6 * plane,
         FLOPS_RBWD * w["covered"],
         (rbb, counts, slot, d_col, zeros, zeros)),
        ("aa_bwd", "largesteps_tpu/render/pallas_core.py:1819",
         lambda: K.aa_bwd(rbb, counts, fid, z, comp, d_out, res),
         lambda: K.aa_bwd_plain(rbb, counts, fid, z, comp, d_out, res),
         (live * (COLS_SEARCH + COLS_AA_OUT) + w["owners"] * COLS_EDGE) * F32
         + nbytes(counts) + (2 + 3 * D) * plane,
         (FLOPS_PAIR + FLOPS_PAIR_BWD + 2 * FLOPS_BLEND * D) * w["pairs"],
         (rbb, counts, fid, z, comp, d_out)),
    ]
    live_n = counts.float()
    table, ok = {}, True
    for name, replaces, kern, plain, nb_, ops, inputs in cases:
        got = kern()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = plain()
        b.record()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        passed, errs, scales, tol = holds(name, got, want)
        # the check must be able to fail: each output zeroed in turn
        caught = all(not holds(name, got[:i] + (torch.zeros_like(got[i]),)
                               + got[i + 1:], want)[0]
                     for i in range(len(got)))
        passed = passed and caught
        del got, want
        ms = time_ms(kern, reps)
        dev_ms = device_ms(kern, reps)
        plain_ms = time_ms(plain, plain_reps, warm=1) if plain_reps \
            else a.elapsed_time(b)
        t_bytes = nb_ / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32 * 1e3
        table[name] = {
            "name": name, "route": "cuda",
            "source": f"largesteps_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "device_ms": dev_ms}
        emit({"phase": phase, "name": name, "passed": passed,
              "max_abs_err": errs, "max_rel_err": [
                  e / s if s else 0.0 for e, s in zip(errs, scales)],
              "tolerance": tol, "planted_errors_caught": caught,
              "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
              "bytes": nb_, "flops": ops, "bytes_ms": t_bytes,
              "ops_ms": t_ops, "work": w, "cap": cap, "occupancy": occ,
              "live_slots_max": int(live_n.max()),
              "live_slots_mean": float(live_n.mean()),
              "input_bytes": nbytes(*inputs),
              "shapes": {"rec": list(rfb.shape), "planes": list(fid.shape),
                         "color": list(comp.shape)},
              "card": card})
        ok = ok and passed
    return ok, table


def launched_twice(m):
    """raster_bwd and aa_bwd launched twice each on the inputs ``m``:
    whether the two launches' outputs are the same bits, and the cap."""
    from largesteps_torch.render import kernels as K
    zeros = torch.zeros_like(m["fid"])
    runs = {
        "raster_bwd": lambda: (K.raster_bwd(
            m["rbb"], m["counts"], m["slot"], m["d_col"], zeros, zeros,
            m["res"]),),
        "aa_bwd": lambda: K.aa_bwd(m["rbb"], m["counts"], m["fid"], m["z"],
                                   m["comp"], m["d_out"], m["res"])}
    out = {"cap": m["cap"]}
    for name, fn in runs.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        out[name] = all(torch.equal(x, y) for x, y in zip(a, b))
    return out


def phase_kernels(card, ptxas):
    """Each kernel against its plain version on one forward+backward's real
    inputs at the main path's shapes."""
    m = main_path_inputs()
    ok, table = check_kernels(m, card, "kernel", 50, 3)
    TWICE["main_path"] = launched_twice(m)
    for name, row in table.items():
        if name in REDESIGNED:
            row.update({"redesigned": REDESIGNED[name],
                        "fixed_order_sums": name in FIXED_ORDER,
                        "ptxas": ran(ptxas[name], instance(
                            name, m["cap"], m["comp"].shape[-1]))})
    table["aa_bwd"]["ptxas_sums"] = ran(ptxas["aa_bwd"], "aa_bwd_sums")
    return ok, table


def phase_large_f_kernels(card):
    """Each kernel against its plain version at the large-F run's shapes:
    13 views of nefertiti through the epoch's host bins (the plain versions
    timed on the one call compared)."""
    m = large_f_inputs()
    ok, table = check_kernels(m, card, "large_f_kernel", 10, 0)
    TWICE["large_f"] = launched_twice(m)
    for row in table.values():
        row["cap"] = m["cap"]
    del m
    torch.cuda.empty_cache()
    return ok, table


def phase_render_cpu_vs_card(card):
    """2 views at 256²: images and the gradients w.r.t. v and n, through
    the kernels on the card and through the plain versions on the CPU."""
    from largesteps_torch.render.renderer import Renderer, Topology
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.profiling import main_path_scene
    scene = main_path_scene(n_views=2, seed=SEED)
    f = scene["mesh-source"]["faces"]
    v0 = torch.as_tensor(scene["mesh-source"]["vertices"])
    n0 = compute_vertex_normals(v0, f, compute_face_normals(v0, f))
    w = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(2, 256, 256, 4)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(scene, shading=True, boost=3, device=dev)
        topo = Topology(f)
        v = v0.to(dev).requires_grad_(True)
        n = n0.to(dev).requires_grad_(True)
        img = r.render(v, n, topo)
        (w.to(dev) * img).sum().backward()
        out[dev] = (img.detach().cpu(), v.grad.cpu(), n.grad.cpu())
    e_img = max_abs(out["cuda"][0], out["cpu"][0])
    e_v = max_abs(out["cuda"][1], out["cpu"][1])
    e_n = max_abs(out["cuda"][2], out["cpu"][2])
    s_v = float(out["cpu"][1].abs().max())
    s_n = float(out["cpu"][2].abs().max())
    passed = (e_img <= 1e-5 and e_v <= 1e-4 * s_v and e_n <= 1e-4 * s_n
              and bool(torch.isfinite(out["cuda"][0]).all()))
    emit({"phase": "render_card_vs_cpu", "passed": passed,
          "img_max_abs": e_img, "dv_max_abs": e_v, "dv_scale": s_v,
          "dn_max_abs": e_n, "dn_scale": s_n,
          "tolerance": "images 1e-5 abs, gradients 1e-4 x max|g|",
          "card": card})
    core_ok, launches = render_core_card_vs_cpu(scene, card)
    return passed and core_ok, launches


def render_core_card_vs_cpu(scene, card):
    """``render_core`` (the unfused rasterize + interpolate: raster_fwd,
    and raster_bwd in its backward) on the same 2 views at 256², card
    against CPU, forward and backward under random cotangents on the colour
    and on (u, v): ids and slots exact, u, v and colour 1e-5, the gradients
    of v_clip and of the attributes 1e-4 x max|g|.  Returns (passed, the
    tile kernels' launches on the card)."""
    from largesteps_torch.render.antialias import face_adjacency
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.renderer import Renderer
    from largesteps_torch.render.tile_raster import make_render_core
    f = scene["mesh-source"]["faces"]
    rng = np.random.default_rng(SEED)
    attrs = rng.normal(size=(len(scene["mesh-source"]["vertices"]), 3))
    wc = rng.normal(size=(2, 256, 256, 3)).astype(np.float32)
    wu = rng.normal(size=(2, 256, 256, 2)).astype(np.float32)
    core = make_render_core(f, face_adjacency(f), (256, 256))
    launches = _zero_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        vc = project(torch.as_tensor(scene["mesh-source"]["vertices"],
                                     device=dev),
                     Renderer(scene, device=dev).mvps).requires_grad_(True)
        at = torch.as_tensor(attrs.astype(np.float32),
                             device=dev).requires_grad_(True)
        rast, slot, col = core(vc, at)
        ((torch.as_tensor(wc, device=dev) * col).sum()
         + (torch.as_tensor(wu, device=dev) * rast[..., :2]).sum()
         ).backward()
        out[dev] = [t.detach().cpu() for t in (rast, slot, col, vc.grad,
                                               at.grad)]
        if dev == "cuda":
            launches = dict(launches)
    (r1, s1, c1, gv1, ga1), (r0, s0, c0, gv0, ga0) = out["cuda"], out["cpu"]
    errs = {"ids": max_abs(r1[..., 3], r0[..., 3]),
            "slot": max_abs(s1, s0), "uv": max_abs(r1[..., :2], r0[..., :2]),
            "color": max_abs(c1, c0), "dv_clip": max_abs(gv1, gv0),
            "d_attrs": max_abs(ga1, ga0)}
    scales = {"dv_clip": float(gv0.abs().max()),
              "d_attrs": float(ga0.abs().max())}
    passed = (errs["ids"] == 0.0 and errs["slot"] == 0.0
              and errs["uv"] <= 1e-5 and errs["color"] <= 1e-5
              and all(0 < scales[k] and errs[k] <= 1e-4 * scales[k]
                      for k in scales)
              and launches["raster_fwd"] >= 1 and launches["raster_bwd"] >= 1)
    emit({"phase": "render_core_card_vs_cpu", "passed": passed,
          "max_abs": errs, "grad_scale": scales, "cap": core.cap,
          "covered": int((r0[..., 3] > 0).sum()), "launches": launches,
          "tolerance": "ids and slots exact, u v colour 1e-5 abs, "
                       "gradients 1e-4 x max|g|", "card": card})
    return passed, launches


def phase_main_path(card):
    """The port's optimize_shape on the bench_step scene, on the card."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.render import kernels as K
    from largesteps_torch.profiling import MAIN_PATH_PARAMS, main_path_scene
    scene = main_path_scene(seed=SEED)
    params = {**MAIN_PATH_PARAMS, "steps": STEPS}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    res = optimize_shape(scene, params, device="cuda")
    launches = dict(K.LAUNCHES)
    REPEATS["main_path"] = (res["losses"], res["v_final"])
    losses = res["losses"][:, 0]
    first = res["prof"]["first_step_s"]
    steady = (STEPS - 1) / (res["wall_time"] - first)
    passed = (bool(np.isfinite(res["losses"]).all())
              and losses[-1] < losses[0]
              and all(n >= STEPS for n in launches.values()))
    emit({"phase": "main_path_first_step", "first_step_s": first,
          "card": card})
    emit({"phase": "main_path", "passed": passed, "steps": STEPS,
          "it_per_s": steady, "wall_s": res["wall_time"],
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "launches": launches,
          "launches_per_step": {k: n / STEPS for k, n in launches.items()},
          "setup_s": res["prof"]["setup_s"],
          "card": card})
    return passed, launches


def phase_large_f_pipes(card):
    """One forward and backward of the batched prebinned pipe and of the
    camera-sequential pipe at nefertiti (13 views at 256²) on the same host
    bins (margin 4 px, with the face→slot inverse): images within 1e-5,
    gradients within 1e-4 × max|g|; each pipe's time and peak memory, and
    which one the renderer picks."""
    from largesteps_torch.render import renderer as R
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import (RenderPipeline,
                                                  RenderPipelineBig)
    from largesteps_torch.render.sh import sh_eval
    from largesteps_torch.profiling import large_f_scene
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    dev = torch.device("cuda")
    scene = large_f_scene(seed=SEED)
    r = R.Renderer(scene, shading=True, boost=3, device=dev)
    f = scene["mesh-source"]["faces"]
    topo = R.Topology(f)
    vs = scene["mesh-source"]["vertices"]
    bins, counts, fslots, occ = host_bins(r, vs, f, 4.0, return_slots=True)
    cap, K = bins.shape[-1], fslots.shape[-1]
    up = lambda a: torch.as_tensor(a, device=dev)
    binned = (up(bins).long(), up(counts), up(fslots).long())
    v = up(vs)
    with torch.no_grad():
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))
        v_ndc = project(v, r.mvps)
        attrs = sh_eval(r.sh_M, n) / np.pi
    w = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(len(r.view_mats), *r.res, 4)).astype(np.float32), device=dev)
    out, times, peaks = {}, {}, {}
    for name, kind in (("batched", RenderPipeline),
                       ("camera_sequential", RenderPipelineBig)):
        kw = {"prebinned": True} if kind is RenderPipeline else {}
        pipe = kind(f, topo.opp, r.res, shading=True, boost=3.0, cap=cap,
                    slots_k=K, **kw)

        def run():
            vc = v_ndc.clone().requires_grad_(True)
            img = pipe(vc, attrs, r.bgs, *binned)
            (w * img).sum().backward()
            return img.detach(), vc.grad

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[name] = run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        times[name] = time_ms(run, 3, warm=1)
    (ia, ga), (ib, gb) = out["batched"], out["camera_sequential"]
    e_img, e_g = max_abs(ib, ia), max_abs(gb, ga)
    s_g = float(ga.abs().max())
    passed = (e_img <= 1e-5 and e_g <= 1e-4 * s_g and s_g > 0
              and bool(torch.isfinite(ia).all()))
    ws = R.batched_bytes(len(r.view_mats), bins.shape[1], cap, len(f))
    emit({"phase": "large_f_pipes", "passed": passed,
          "img_max_abs": e_img, "dv_max_abs": e_g, "dv_scale": s_g,
          "tolerance": "images 1e-5 abs, gradients 1e-4 x max|g|",
          "ms": times, "peak_bytes": peaks, "cap": cap, "occupancy": occ,
          "slots_k": K, "batched_bytes": ws,
          "device_bytes": R._device_bytes(dev),
          "batched_share": R.BATCHED_SHARE,
          "renderer_picks": ("camera_sequential"
                             if r.camera_sequential(cap, len(f))
                             else "batched"),
          "card": card})
    del out, binned
    torch.cuda.empty_cache()
    return passed


def phase_large_f(card):
    """The port's optimize_shape on the teaser's ``ours`` leg at nefertiti
    for STEPS steps, and one 3-column solve of its banded factor."""
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.solvers import CholeskySolver
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.render import kernels as K
    from largesteps_torch.profiling import LARGE_F_PARAMS, large_f_scene
    scene = large_f_scene(seed=SEED)
    params = {**LARGE_F_PARAMS, "steps": STEPS}
    vs = scene["mesh-source"]["vertices"]
    M = compute_matrix(vs, scene["mesh-source"]["faces"], alpha=0.98,
                       device="cuda")
    slv = CholeskySolver(M)
    b = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(len(vs), 3)).astype(np.float32), device="cuda")
    solve_ms = time_ms(lambda: slv.solve(b), 10)
    del slv, M, b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    res = optimize_shape(scene, params, device="cuda")
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"][:, 0]
    prof = res["prof"]
    first = prof["first_step_s"]
    steady = (STEPS - 1) / (res["wall_time"] - first)
    passed = (bool(np.isfinite(res["losses"]).all())
              and losses[-1] < losses[0] and prof["rebin_n"] >= 1
              and all(n >= STEPS for n in launches.values()))
    emit({"phase": "large_f", "passed": passed, "steps": STEPS,
          "faces": int(scene["mesh-source"]["faces"].shape[0]),
          "verts": int(vs.shape[0]), "solver": prof.get("solver"),
          "solve_ms": solve_ms, "setup_s": prof["setup_s"],
          "ref_render_s": prof["ref_render_s"],
          "topology_s": prof["topology_s"],
          "host_bins_s": prof["host_bins_s"], "factor_s": prof["factor_s"],
          "first_step_s": first, "it_per_s": steady,
          "wall_s": res["wall_time"], "rebin_n": prof["rebin_n"],
          "rebin_s": prof["rebin_s"],
          "max_window_disp_px": prof["max_window_disp_px"],
          "bin_cap": prof["bin_cap"], "peak_bytes": peak,
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "launches": launches,
          "launches_per_step": {k: n / STEPS for k, n in launches.items()},
          "card": card})
    return passed, launches, prof["bin_cap"]


def micro_benchmark_path(card):
    """The rasterizer micro-benchmarks as a user runs them (``python -m
    largesteps_torch.benchmarks.<name>``), with the launch counts of their
    two kernels set to 0 before and read after: micro_scatter at the main
    path's shape and at nefertiti's, probe_mosaic at the JAX probe's tile
    and at 208 tiles of cap 768, bench_raster at its defaults."""
    from largesteps_torch.benchmarks import (bench_raster, micro_scatter,
                                             probe_mosaic)
    counters = (micro_scatter.LAUNCHES, probe_mosaic.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    C, P, F, ch = NEFERTITI_SCATTER
    runs = {"micro_scatter": micro_scatter.main([]),
            "micro_scatter_nefertiti": micro_scatter.main(
                ["--cams", str(C), "--px", str(P), "--faces", str(F),
                 "--ch", str(ch), "--reps", "5"]),
            "probe_mosaic": probe_mosaic.main([]),
            "probe_mosaic_208": probe_mosaic.main(
                ["--tiles", "208", "--cap", "768", "--reps", "50"]),
            "bench_raster": bench_raster.main(["--reps", "3"])}
    launches = {k: n for c in counters for k, n in c.items()}
    for name, out in runs.items():
        emit({"phase": "micro_benchmark", "name": name, **out, "card": card})
    return runs, launches


def probe_cases(kinds=("onehot_scatter", "traffic", "probe_tile")):
    """The inputs of ``kinds``, the main path's shape of each kernel first,
    as (kernel, shape, arguments, extra): onehot_scatter at the main path's
    shape and at nefertiti's, ids and rows from the seed, and (``traffic``)
    on the main path's own traffic (the per-slot table of one backward, ``table18``,
    built as ``RenderPipeline.backward`` builds it, into ``face_ids``'
    rows, as ``scatter_via_faces`` sums it; extra: that function's
    ``face_sums`` and the share of slots on sentinels); probe_tile on the
    main path's real data (its 208 tiles at the fitted cap: the slot plane,
    the forward records' 32 columns as recT, and the colour cotangent's
    first channel as g0) and at the JAX probe's tile (one, cap 256,
    seeded)."""
    from types import SimpleNamespace
    from largesteps_torch.render import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    cases = []
    if "onehot_scatter" in kinds:
        for tag, (C, P, F, ch) in (("main", (13, 65_536, 5_121, 32)),
                                   ("nefertiti", NEFERTITI_SCATTER)):
            ids = torch.randint(0, F, (C, P), generator=gen,
                                dtype=torch.int32)
            m = torch.randn((C, P, ch), generator=gen)
            cases.append(("onehot_scatter", tag, {
                "ids": ids.to(dev), "m": m.to(dev), "n_faces": F}, {}))
    m = main_path_inputs()
    if "traffic" in kinds:
        from largesteps_torch.render.pipeline import (_backward_kernels,
                                                      face_ids, face_sums)
        pipe = SimpleNamespace(resolution=m["res"], shading=True, boost=3.0,
                               ablate="", row_shards=1, row0=0)
        cov = (m["fid"] > 0)[..., None]
        table18, _ = _backward_kernels(pipe, m["rbb"], m["counts"],
                                       m["slot"], m["fid"], m["z"],
                                       m["comp"], cov, m["d_out"])
        F, bins = m["n_faces"], m["bins"]
        cases.append(("onehot_scatter", "main_path_traffic", {
            "ids": face_ids(bins, F).to(torch.int32).reshape(1, -1)
            .contiguous(),
            "m": table18.reshape(1, -1, 18).contiguous(),
            "n_faces": table18.shape[0] * (F + 1)}, {
            "face_sums": face_sums(table18, bins, F),
            "sentinel_share": float((bins < 0).float().mean())}))
    if "probe_tile" in kinds:
        tiles = lambda x: K._to_tiles(x).reshape(-1, 32, 128).contiguous()
        rfb = m["rfb"]
        recT = rfb.reshape(-1, rfb.shape[3], 32).transpose(1, 2).contiguous()
        cases.append(("probe_tile", f"main_path_{recT.shape[0]}x{m['cap']}",
                      {"slot": tiles(m["slot"]), "recT": recT,
                       "g0": tiles(m["d_col"][..., 0].contiguous())}, {}))
        rng = np.random.default_rng(SEED)
        up = lambda a: torch.as_tensor(a, device=dev)
        cases.append(("probe_tile", f"seeded_1x{PROBE_CAP}", {
            "slot": up(rng.integers(-1, PROBE_CAP, (1, 32, 128)).astype(
                np.float32)),
            "recT": up(rng.standard_normal((1, 32, PROBE_CAP)).astype(
                np.float32)),
            "g0": up(rng.standard_normal((1, 32, 128)).astype(np.float32))},
            {}))
    del m
    return cases


def launch_shape(name, a):
    """The grid of kernel ``name`` at arguments ``a``: blocks, threads and
    dynamic shared bytes a block, blocks an SM holds, and waves of the
    card's SMs that many deep."""
    from largesteps_torch import _cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "probe_tile":
        B, _, cap = a["recT"].shape
        blocks, threads, smem, per_sm, items = _cuda.launch_shape(
            name, B, cap)[:5]
        out = {"work_items": items}
    else:
        C, P, ch = a["m"].shape
        vec, W, parts, windows, threads, smem, per_sm = \
            _cuda.launch_shape(name, C * P, ch)[:7]
        blocks = parts * windows
        out = {"vector": vec, "window": W, "windows": windows}
    return {**out, "blocks": blocks, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "sms": sms,
            "waves": blocks / (per_sm * sms)}


def _probe_library(name, a):
    """The PyTorch library calls that compute the kernel's function, inputs
    prepared outside the timed call: one ``index_add_`` (onehot_scatter);
    ``index_select`` of the named record rows and ``index_add_`` of the
    18 planes (probe_tile)."""
    if name == "onehot_scatter":
        ids = a["ids"].reshape(-1).long()
        rows = a["m"].reshape(-1, a["m"].shape[-1])
        F, ch = a["n_faces"], rows.shape[-1]
        return lambda: torch.zeros((F, ch), device=rows.device).index_add_(
            0, ids, rows)
    slot, recT, g0 = a["slot"], a["recT"], a["g0"]
    B, _, cap = recT.shape
    s = slot.reshape(B, -1)
    valid = (s >= 0) & (s < cap) & (s == torch.floor(s))
    flat = torch.where(valid, torch.arange(B, device=s.device)[:, None] * cap
                       + s.long(), B * cap).reshape(-1)
    table = torch.cat([recT.transpose(1, 2).reshape(B * cap, 32),
                       recT.new_zeros(1, 32)])
    g = (g0.reshape(-1, 1) * torch.arange(1, 19, device=s.device,
                                          dtype=torch.float32)).contiguous()
    return lambda: (table.index_select(0, flat),
                    torch.zeros((B * cap + 1, 18), device=s.device)
                    .index_add_(0, flat, g))


def _probe_holds(name, got, want):
    """(passed, max-abs errors, scales, tolerance) of a micro-benchmark
    kernel against its plain version."""
    errs = [max_abs(a, b) for a, b in zip(got, want)]
    scales = [float(b.abs().max()) for b in want]
    if name == "onehot_scatter":
        return (errs[0] <= 1e-5 * scales[0], errs, scales,
                "1e-5 x max|plain| (atomics add in another order)")
    return (errs[0] == 0.0 and errs[1] <= 1e-5 * scales[1], errs, scales,
            "fields exact; S 1e-5 x max|plain|")


def phase_probe_kernels(card):
    """The micro-benchmarks' path with its launch counts, then each of its
    two kernels against its plain version at the shapes of
    :func:`probe_cases` (on the main path's traffic, onehot_scatter also
    against ``face_sums``): errors, planted errors, ms (the wrapper's call,
    CUDA events), device ms (``torch.profiler``), plain ms, the library
    calls' ms, bytes, bound and the launch shape.  Returns (passed, {name:
    row})."""
    from largesteps_torch.benchmarks import micro_scatter, probe_mosaic
    runs, launches = micro_benchmark_path(card)
    ok = all(n >= 1 for n in launches.values()) \
        and runs["probe_mosaic"]["fields_max_err"] == 0.0 \
        and runs["bench_raster"]["id_match"] >= 0.9999
    fns = {"onehot_scatter": (micro_scatter.onehot_scatter,
                              micro_scatter.onehot_scatter_plain),
           "probe_tile": (probe_mosaic.probe_tile,
                          probe_mosaic.probe_tile_plain)}
    replaces = {"onehot_scatter": "benchmarks/micro_scatter.py:61",
                "probe_tile": "benchmarks/probe_mosaic.py:47"}
    table = {}
    for name, tag, a, extra in probe_cases():
        kern = lambda: fns[name][0](**a)
        plain = lambda: fns[name][1](**a)
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        passed, errs, scales, tol = _probe_holds(name, got, want)
        caught = all(not _probe_holds(name, got[:i] + (
            torch.zeros_like(got[i]),) + got[i + 1:], want)[0]
            for i in range(len(got)))
        traffic = {}
        if "face_sums" in extra:
            # the per-face table that scatter_via_faces builds by index_add_
            fs = extra["face_sums"]
            e_fs, s_fs = max_abs(got[0], fs), float(fs.abs().max())
            traffic = {"face_sums_max_abs_err": e_fs,
                       "face_sums_max": s_fs,
                       "face_sums_held": e_fs <= 1e-5 * s_fs,
                       "face_sums_planted_caught":
                           max_abs(torch.zeros_like(fs), fs) > 1e-5 * s_fs,
                       "sentinel_share": extra["sentinel_share"]}
            passed = passed and traffic["face_sums_held"] \
                and traffic["face_sums_planted_caught"]
        passed = passed and caught
        ms = time_ms(kern, 50)
        dev_ms = device_ms(kern, 20)
        shape = launch_shape(name, a)
        plain_ms = time_ms(plain, 3, warm=1)
        library_ms = time_ms(_probe_library(name, a), 20)
        if name == "onehot_scatter":
            ids = a["ids"]
            n_valid = int(((ids >= 0) & (ids < a["n_faces"])).sum())
            nb_ = nbytes(ids, a["m"], want[0])
            ops = n_valid * a["m"].shape[-1]
        else:
            s = a["slot"]
            cap = a["recT"].shape[-1]
            n_valid = int(((s >= 0) & (s < cap) & (s == torch.floor(s)))
                          .sum())
            nb_ = nbytes(a["slot"], a["recT"], a["g0"], *want)
            ops = FLOPS_PROBE_PIXEL * n_valid
        t_bytes = nb_ / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32 * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"largesteps_torch/csrc/{name}.cu",
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "device_ms": dev_ms,
               "launch": shape}
        emit({"phase": "probe_kernel", "name": name, "shape": tag,
              "passed": passed, "max_abs_err": errs,
              "max_rel_err": [e / sc if sc else 0.0
                              for e, sc in zip(errs, scales)],
              "tolerance": tol, "planted_errors_caught": caught,
              "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "bytes": nb_, "flops": ops, "bytes_ms": t_bytes,
              "ops_ms": t_ops, "valid_entries": n_valid,
              "launches": launches[name], "launch": shape, **traffic,
              "shapes": {k: list(v.shape) for k, v in a.items()
                         if isinstance(v, torch.Tensor)}, "card": card})
        ok = ok and passed
        # the row is the main path's shape; the others ride beside it
        if name not in table:
            table[name] = {**row, "shape": tag, "other_shapes": []}
        else:
            table[name]["other_shapes"].append({
                k: row[k] for k in ("ms", "device_ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "max_abs_err", "launch")}
                | {"shape": tag} | traffic)
        del got, want
    torch.cuda.empty_cache()
    return ok, table


def phase_dense_render(card):
    """One forward and backward of the bench_step scene (13 views at 256²,
    shaded, boost 3) through ``Renderer(backend="dense")`` and through
    ``backend="tiles"`` on the card, with the same random cotangent: the
    images, the gradients with respect to v and n, the share of matching
    face ids, and each backend's ms and peak bytes.

    The dense antialias takes every pair (``aa_cap`` = all pairs), so it is
    the capacity-free reference: its default cap, an eighth of the pairs,
    is below this scene's count of differing pairs a view.  The two
    backends compute coverage and depth by two formulations (edge functions
    and barycentric depth against per-tile plane equations) that round
    apart by an ulp, as ``tests/test_pallas.py`` notes of the JAX
    package's two.  That decides two things where the exact values tie:
    the face of a pixel whose centre lies on an edge, and the owner of an
    antialias pair whose two depths are equal (the scene is symmetric about
    the image's middle column, so pairs across it tie).  Those pixels (a
    pixel of another face with its four neighbours, the pairs it is in;
    both pixels of a pair of another owner) are counted, kept out of the
    image comparison and given a zero cotangent; everything else is held
    to the bars, the flipped faces to the id-match bar, and the pixels set
    aside to 1 in 10³ (a few hundred pairs of this scene tie)."""
    from largesteps_torch.render.antialias import _auto_cap
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.raster import rasterize
    from largesteps_torch.render.renderer import Renderer, Topology
    from largesteps_torch.render.tile_raster import rasterize_tiles_fwd
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.profiling import main_path_scene
    dev = torch.device("cuda")
    scene = main_path_scene(seed=SEED)
    f = scene["mesh-source"]["faces"]
    v0 = torch.as_tensor(scene["mesh-source"]["vertices"], device=dev)
    with torch.no_grad():
        n0 = compute_vertex_normals(v0, f, compute_face_normals(v0, f))
    all_pairs = 256 * 255 * 2
    rs = {b: Renderer(scene, shading=True, boost=3, backend=b,
                      aa_cap=all_pairs, device=dev)
          for b in ("dense", "tiles")}
    topo = Topology(f)
    rs["tiles"].check_overflow(v0, topo)    # as the driver sizes the bins
    with torch.no_grad():
        v_ndc = project(v0, rs["dense"].mvps)
        faces = torch.as_tensor(f.astype(np.int64), device=dev)
        rast_d = rasterize(v_ndc, faces, (256, 256))
        rast_t = rasterize_tiles_fwd(v_ndc, faces, (256, 256),
                                     rs["tiles"].bin_cap)
    ids_d, ids_t = rast_d[..., 3], rast_t[..., 3]
    flip = ids_d != ids_t
    near = flip.clone()
    near[:, 1:] |= flip[:, :-1]
    near[:, :-1] |= flip[:, 1:]
    near[:, :, 1:] |= flip[:, :, :-1]
    near[:, :, :-1] |= flip[:, :, 1:]
    owner_flips = 0
    for dim in (1, 2):                    # vertical, horizontal pairs
        n = ids_d.shape[dim] - 1
        a, b = (lambda x: x.narrow(dim, 0, n)), (lambda x: x.narrow(dim, 1, n))
        z = [torch.where(r[..., 3] > 0, r[..., 2], 3.4e38)
             for r in (rast_d, rast_t)]
        other = (a(z[0]) <= b(z[0])) != (a(z[1]) <= b(z[1]))
        other &= a(ids_d) != b(ids_d)
        owner_flips += int(other.sum())
        a(near).logical_or_(other)
        b(near).logical_or_(other)
    keep = (~near)[..., None].float()
    w = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(len(scene["view_mats"]), 256, 256, 4)).astype(np.float32),
        device=dev)
    out, ms, peaks = {}, {}, {}
    for backend, r in rs.items():
        def run(wk):
            v = v0.clone().requires_grad_(True)
            n = n0.clone().requires_grad_(True)
            img = r.render(v, n, topo)
            (wk * img).sum().backward()
            return img.detach(), v.grad, n.grad

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[backend] = run(w * keep)
        torch.cuda.synchronize()
        peaks[backend] = torch.cuda.max_memory_allocated()
        out[backend + "_all"] = run(w)
        ms[backend] = time_ms(lambda: run(w), 3, warm=0)
    (i_d, gv_d, gn_d), (i_t, gv_t, gn_t) = out["dense"], out["tiles"]
    d = (i_d.double() - i_t.double()).abs() * keep
    n_above = int((d > 1e-5).sum())
    e_v, e_n = max_abs(gv_t, gv_d), max_abs(gn_t, gn_d)
    s_v, s_n = float(gv_d.abs().max()), float(gn_d.abs().max())
    (a_d, av_d, an_d), (a_t, av_t, an_t) = out["dense_all"], \
        out["tiles_all"]
    id_match = float((~flip).double().mean())
    pairs = ((ids_d[:, :, 1:] != ids_d[:, :, :-1]).sum(dim=(1, 2))
             + (ids_d[:, 1:] != ids_d[:, :-1]).sum(dim=(1, 2)))
    passed = (n_above <= d.numel() // 10_000 and float(d.max()) <= 1e-3
              and e_v <= 1e-4 * s_v and e_n <= 1e-4 * s_n
              and id_match >= 0.9999 and s_v > 0 and s_n > 0
              and int(near.sum()) <= near.numel() // 1_000
              and bool(torch.isfinite(i_d).all()))
    emit({"phase": "dense_render", "passed": passed,
          "img_max_abs": float(d.max()), "img_values_above_1e-5": n_above,
          "img_values": d.numel(), "dv_max_abs": e_v, "dv_scale": s_v,
          "dn_max_abs": e_n, "dn_scale": s_n, "id_match": id_match,
          "id_mismatches": int(flip.sum()), "owner_flips": owner_flips,
          "pixels_set_aside": int(near.sum()),
          "with_them": {"img_max_abs": max_abs(a_d, a_t),
                        "dv_max_rel": max_abs(av_t, av_d)
                        / float(av_d.abs().max()),
                        "dn_max_rel": max_abs(an_t, an_d)
                        / float(an_d.abs().max())},
          "aa_pairs_max": int(pairs.max()), "aa_cap": all_pairs,
          "aa_auto_cap": _auto_cap(all_pairs),
          "tolerance": "images: at most 1 value in 1e4 above 1e-5, none "
                       "above 1e-3; gradients 1e-4 x max|g|; ids 99.99 %; "
                       "set aside (at most 1 in 1e3): pixels whose ids "
                       "differ with their 4 neighbours, pairs whose owner "
                       "differs",
          "ms": ms, "peak_bytes": peaks, "tiles_cap": rs["tiles"].bin_cap,
          "card": card})
    del out
    torch.cuda.empty_cache()
    return passed


def phase_dense_path(card):
    """The port's optimize_shape on the bench_step scene at 13 views of
    250², a size that does not tile, so ``"auto"`` draws it with the dense
    renderer: STEPS steps, the loss falling, no tile kernel launched."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.driver.optimize_shape import default_params
    from largesteps_torch.io.synth import make_scene
    from largesteps_torch.render import kernels as K
    from largesteps_torch.profiling import MAIN_PATH_PARAMS
    scene = make_scene(source=("icosphere", 4), target=("gourd", 4),
                       n_views=13, res=250, seed=SEED)
    params = {**MAIN_PATH_PARAMS, "steps": STEPS}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    res = optimize_shape(scene, params, device="cuda")
    launches = dict(K.LAUNCHES)
    REPEATS["dense_path"] = (res["losses"], res["v_final"])
    losses = res["losses"][:, 0]
    prof = res["prof"]
    first = prof["first_step_s"]
    steady = (STEPS - 1) / (res["wall_time"] - first)
    passed = (bool(np.isfinite(res["losses"]).all())
              and losses[-1] < losses[0] and prof["backend"] == "dense"
              and prof["raster_chunk"] == 128
              and default_params()["raster_chunk"] == 128
              and not any(launches.values()))
    emit({"phase": "dense_path", "passed": passed, "steps": STEPS,
          "res": 250, "backend": prof["backend"],
          "raster_chunk": prof["raster_chunk"], "it_per_s": steady,
          "first_step_s": first, "wall_s": res["wall_time"],
          "setup_s": prof["setup_s"], "loss_first": float(losses[0]),
          "loss_last": float(losses[-1]), "tile_launches": launches,
          "peak_bytes": torch.cuda.max_memory_allocated(), "card": card})
    return passed


def _zero_launches():
    from largesteps_torch.render import kernels as K
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    return K.LAUNCHES


def phase_fit_quality(card):
    """The comparison figure's three suzanne legs at full length through
    ``largesteps_torch.figures.common.run`` on the card (ours: 1,080 steps
    of AdamUniform at 2e-3; lapreg and bilapreg: 1,130 steps of Adam at
    1e-2 on the coordinates, weights 2.8 and 3.8; all boost 3, l1, α =
    0.95): each leg's symmetric Hausdorff distance to the target, it/s and
    first step.  Passes when all three are finite, ours < bilapreg <
    lapreg (the JAX package's order: 0.140 < 0.507 < 0.610,
    ``figures/output/comparison``) and ours is within 25 % of JAX's 0.140."""
    from largesteps_torch.figures import common, comparison
    launches = _zero_launches()
    legs = {}
    for name, params in comparison.legs("suzanne"):
        res, d = common.run(name, "suzanne", params, "comparison",
                            device="cuda")
        prof = res["prof"]
        first = prof["first_step_s"]
        legs[name.split("_", 1)[1]] = {
            "hausdorff": d, "steps": res["iters"],
            "optimizer": params["optimizer"], "smooth": params["smooth"],
            "it_per_s": (res["iters"] - 1) / (res["wall_time"] - first),
            "it_per_s_with_first": res["iters"] / res["wall_time"],
            "first_step_s": first, "setup_s": prof["setup_s"],
            "loss_first": float(res["losses"][0, 0]),
            "loss_last": float(res["losses"][-1, 0])}
    launches = dict(launches)
    h = {k: leg["hausdorff"] for k, leg in legs.items()}
    passed = (all(np.isfinite(x) for x in h.values())
              and h["ours"] < h["bilapreg"] < h["lapreg"]
              and h["ours"] <= FIT_OURS_MAX
              and all(n >= 1 for n in launches.values()))
    emit({"phase": "fit_quality", "passed": passed, "legs": legs,
          "jax_hausdorff": JAX_SUZANNE, "ours_max": FIT_OURS_MAX,
          "launches": launches, "output_dir": common.OUTPUT_DIR,
          "card": card})
    return passed, launches


REMESH_TEASER_STEPS = 270   # of the leg's 1,320: the remesh at 250 and
                            # 20 steps of the remeshed epoch
TEASER_REMESH_VERTS = (120_000, 200_000)


def _epochs(res, counts):
    """Each topology epoch of a run (``figures.common.epochs``) with its
    tile-kernel launches, from the launch counts taken as the run began,
    as each remesh began and at the end (``counts``)."""
    from largesteps_torch.figures.common import epochs
    out = epochs(res)
    for k, ep in enumerate(out):
        ep["launches"] = {key: counts[k + 1][key] - counts[k][key]
                          for key in counts[0]}
    return out


def _remesh_ok(res, epochs):
    """The remeshing run's criteria: finite losses that fell, each remesh
    to a mean edge length within the remesher's thresholds [4/5 h, 4/3 h]
    and to more faces, a first render within its bins' cap, and the tile
    kernels launched in every epoch (each of them at least once a step; in
    an epoch of no steps, before a remesh at step 0, the reference
    render's forward kernels)."""
    losses = res["losses"][:, 0]
    ok = (bool(np.isfinite(res["losses"]).all()) and len(losses) > 0
          and losses[-1] < losses[0])
    for e in res["prof"]["remeshes"]:
        ok = ok and (0.8 * e["h"] <= e["mean_edge_after"] <= 4 / 3 * e["h"]
                     and e["faces_after"] > e["faces_before"]
                     and e["occupancy"] <= e["bin_cap"])
    for ep in epochs:
        need = (("raster_fwd", "aa_fwd") if ep["steps"] == 0
                else tuple(ep["launches"]))
        ok = ok and all(ep["launches"][k] >= max(ep["steps"], 1)
                        for k in need)
    return ok


def phase_remesh(card):
    """Remeshing on the card, through the port's entry points: (a) the
    remeshing figure's two remeshed cranium legs at full length
    (``remesh_start``: 1,500 steps, a remesh before the first;
    ``remesh_middle``: 1,630 steps, a remesh at 750), (b) the multiscale
    figure's ``--quick`` leg (120 steps at lr 0.1, remeshes at 40 and 80,
    its last epoch on the banded solver and host bins), (c) the teaser's
    ``ours_remesh`` leg cut to 270 steps (nefertiti_coarse, remeshed at step
    250 to 120k-200k verts), then one forward and backward of the remeshed
    mesh through the renderer's pick of the prebinned pipes, (d) 20 main-path
    steps with the host Cholesky solver against the same with the dense
    inverse, twice: the first loss, where only the solve differs, within
    1e-4 relative, every loss within 5e-2 (the second dense run repeats
    the first to the bit: the step's sums are added in a fixed order).  The
    tile kernels' launches are counted over the phase, and per epoch of
    each leg."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.figures import common, multiscale, remeshing
    from largesteps_torch.figures import teaser
    from largesteps_torch.native import remesh as native_remesh
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.profiling import MAIN_PATH_PARAMS, main_path_scene
    from largesteps_torch.render import renderer as R
    from largesteps_torch.io.synth import make_scene
    launches = _zero_launches()
    snaps = []
    remesh_botsch = native_remesh.remesh_botsch

    def counted(*args, **kw):
        snaps.append(dict(launches))
        return remesh_botsch(*args, **kw)

    def leg(name, scene, params, subdir):
        snaps[:] = [dict(launches)]
        torch.cuda.reset_peak_memory_stats()
        res, d = common.run(name, scene, params, subdir, device="cuda")
        epochs = _epochs(res, snaps + [dict(launches)])
        ok = _remesh_ok(res, epochs)
        out = {"hausdorff": d, "steps": res["iters"],
               "passed": ok, "epochs": epochs,
               "remeshes": res["prof"]["remeshes"],
               "setup_s": res["prof"]["setup_s"],
               "first_step_s": res["prof"]["first_step_s"],
               "rebin_n": res["prof"]["rebin_n"],
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "loss_first": float(res["losses"][0, 0]),
               "loss_last": float(res["losses"][-1, 0])}
        emit({"phase": "remesh_leg", "name": name, **out, "card": card})
        return res, out

    native_remesh.remesh_botsch = counted
    try:
        legs = {}
        for name, params in remeshing.legs():
            if params["remesh"] >= 0:
                legs[name] = leg(name, remeshing.SCENE, params,
                                 "remeshing")[1]
        (name, params), = multiscale.legs(quick=True)
        legs[name] = leg(name, multiscale.SCENE, params, "multiscale")[1]
        params = dict(teaser.METHODS["ours_remesh"],
                      steps=REMESH_TEASER_STEPS)
        res, legs["ours_remesh"] = leg("ours_remesh", "nefertiti_coarse",
                                       params, "teaser")
    finally:
        native_remesh.remesh_botsch = remesh_botsch
    ms_last = legs["multiscale"]["remeshes"][-1]
    ours = legs["ours_remesh"]["remeshes"]
    checks = {
        "legs": all(leg_["passed"] for leg_ in legs.values()),
        "multiscale_banded_host_bins": (
            len(legs["multiscale"]["remeshes"]) == 2
            and ms_last["solver"]["tier"] == "banded"
            and ms_last["use_host_bins"]),
        "teaser_verts": (len(ours) == 1 and TEASER_REMESH_VERTS[0]
                         <= ours[0]["verts_after"]
                         <= TEASER_REMESH_VERTS[1]),
        "remeshed": all(len(leg_["remeshes"]) >= 1
                        for leg_ in legs.values()),
    }

    # (c)'s remeshed mesh through the renderer's pick of the prebinned pipes
    scene = make_scene(**common.SCENES["nefertiti_coarse"])
    r = R.Renderer(scene, shading=True, boost=3, device="cuda")
    f = res["f_final"]
    bins, counts, fslots, occ = host_bins(r, res["v_final"], f, 4.0,
                                          return_slots=True)
    up = lambda a: torch.as_tensor(a, device="cuda")
    binned = (up(bins).long(), up(counts), up(fslots).long())
    topo = R.Topology(f)
    v = up(res["v_final"])
    with torch.no_grad():
        n = compute_vertex_normals(v, f, compute_face_normals(v, f))

    def fwd_bwd():
        vc = v.clone().requires_grad_(True)
        r.render(vc, n, topo, bins=binned).sum().backward()

    del res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fwd_bwd()
    torch.cuda.synchronize()
    cap = bins.shape[-1]
    pick = lambda c: ("camera_sequential" if r.camera_sequential(c, len(f))
                      else "batched")
    pipe = {"picks": pick(cap), "cap": int(cap),
            "picks_at_epoch_cap": pick(ours[0]["bin_cap"]),
            "epoch_cap": ours[0]["bin_cap"], "occupancy": int(occ), "faces": int(len(f)),
            "peak_bytes": torch.cuda.max_memory_allocated() - base,
            "ms": time_ms(fwd_bwd, 3, warm=1),
            "batched_bytes": R.batched_bytes(len(r.view_mats), bins.shape[1],
                                             cap, len(f)),
            "batched_share": R.BATCHED_SHARE,
            "device_bytes": R._device_bytes(torch.device("cuda"))}
    del binned, topo, v, n
    torch.cuda.empty_cache()

    # (d) the host Cholesky solver against the dense inverse, and the dense
    # inverse against itself (the same bits): 1e-4 holds where only the
    # solve differs, the first step's loss
    scene = main_path_scene(seed=SEED)
    runs = {}
    for tag, solver in (("CholeskyHost", "CholeskyHost"),
                        ("Cholesky", "Cholesky"), ("Cholesky_again",
                                                   "Cholesky")):
        res = optimize_shape(scene, {**MAIN_PATH_PARAMS, "steps": STEPS,
                                     "solver": solver}, device="cuda")
        first = res["prof"]["first_step_s"]
        runs[tag] = {"losses": res["losses"][:, 0],
                     "tier": res["prof"]["solver"]["tier"],
                     "it_per_s": (STEPS - 1) / (res["wall_time"] - first)}
    ld = runs["Cholesky"]["losses"]
    rel = {k: (np.abs(runs[k]["losses"] - ld) / np.abs(ld)).tolist()
           for k in ("CholeskyHost", "Cholesky_again")}
    lh = runs["CholeskyHost"]["losses"]
    checks["cholesky_host"] = (bool(np.isfinite(lh).all()) and lh[-1] < lh[0]
                               and rel["CholeskyHost"][0] <= 1e-4
                               and max(rel["CholeskyHost"]) <= 5e-2
                               and runs["CholeskyHost"]["tier"] == "host")
    launches = dict(launches)
    checks["launches"] = all(n >= 1 for n in launches.values())
    passed = all(checks.values())
    emit({"phase": "remesh", "passed": passed, "checks": checks,
          "hausdorff": {k: leg_["hausdorff"] for k, leg_ in legs.items()},
          "teaser_steps_cut": {"steps": REMESH_TEASER_STEPS, "of": 1320},
          "teaser_remeshed_pipe": pipe,
          "cholesky_host": {"loss_rel": rel,
                            "tolerance": "first loss 1e-4, every loss 5e-2",
                            **{k: {"tier": x["tier"],
                                   "it_per_s": x["it_per_s"],
                                   "loss_first": float(x["losses"][0]),
                                   "loss_last": float(x["losses"][-1])}
                               for k, x in runs.items()}},
          "launches": launches, "output_dir": common.OUTPUT_DIR,
          "card": card})
    return passed, launches


def _steady(res):
    first = res["prof"]["first_step_s"]
    return (res["iters"] - 1) / (res["wall_time"] - first)


def phase_solvers(card):
    """The iterative solvers on the card, through the port's entry points:
    (a) 20 main-path steps with ``solver: "CG"`` beside 20 with
    ``"Cholesky"``: the first loss within 1e-4 relative, every loss within
    5e-2 (two runs of one solver part by up to 9.5e-3 in 20 steps, the
    ``remesh`` phase's finding), CG's iterations a step (forward, backward;
    step 0's forward starts at its solution up to the card's rounding, so
    it takes fewer than the cold backward); (b) at nefertiti's matrix
    (icosphere-7, α = 0.98): ``CholeskySolver(M, max_block=256)`` on the
    block-AMG tier (its levels, blocks, bytes, setup, iterations and solve
    ms) against the banded tier's solve of the same seeded right-hand
    sides (5e-4 abs, the JAX package's bar), its fine level's dense-block
    matvec against ``coo_matvec`` (2e-4 abs) and ``cg_solve`` against the
    banded solve (5e-4 abs); (c) 20 steps of the teaser's ``ours`` leg at
    nefertiti with ``solver: "AMG"``; (d) ``compute_matrix(cotan=True)``
    at the main path's mesh and the gradient in the vertices of
    ``Σ w ⊙ (L_cot v)`` on the card against the CPU (1e-5 relative to the
    largest entry).  The tile kernels' launches are counted over the phase
    and in each driver run."""
    from largesteps_torch.core import multigrid as mg
    from largesteps_torch.core.blocksp import BlockedOperator
    from largesteps_torch.core.geometry import compute_matrix, laplacian_cot
    from largesteps_torch.core.solvers import (CholeskySolver,
                                               ConjugateGradientSolver)
    from largesteps_torch.core.sparse import coo_matvec
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.profiling import (LARGE_F_PARAMS,
                                            MAIN_PATH_PARAMS,
                                            large_f_scene, main_path_scene)
    launches = _zero_launches()
    checks = {}
    dev = torch.device("cuda")

    def run(scene, params):
        before = dict(launches)
        torch.cuda.reset_peak_memory_stats()
        res = optimize_shape(scene, {**params, "steps": STEPS}, device=dev)
        prof = res["prof"]
        it = prof.get("solve_iters")
        out = {"tier": prof["solver"]["tier"], "solver": prof["solver"],
               "it_per_s": _steady(res), "first_step_s": prof["first_step_s"],
               "setup_s": {k: prof[k] for k in (
                   "setup_s", "ref_render_s", "topology_s", "host_bins_s",
                   "factor_s")},
               "solve_iters": None if it is None else it.tolist(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "losses": res["losses"][:, 0],
               "launches": {k: launches[k] - before[k] for k in launches}}
        losses = out["losses"]
        out["falls"] = (bool(np.isfinite(res["losses"]).all())
                        and losses[-1] < losses[0]
                        and all(n >= STEPS
                                for n in out["launches"].values()))
        return out

    # (a) the main path under CG, beside the dense inverse
    scene = main_path_scene(seed=SEED)
    main = {s: run(scene, {**MAIN_PATH_PARAMS, "solver": s})
            for s in ("CG", "Cholesky")}
    l_cg, l_ch = main["CG"]["losses"], main["Cholesky"]["losses"]
    rel = (np.abs(l_cg - l_ch) / np.abs(l_ch)).tolist()
    it = np.asarray(main["CG"]["solve_iters"])
    checks["main_cg"] = (main["CG"]["falls"] and main["CG"]["tier"] == "cg"
                         and rel[0] <= 1e-4 and max(rel) <= 5e-2
                         and it.shape == (STEPS, 2)
                         and it[0, 0] < it[0, 1]
                         and bool((it[:, 1] > 0).all()))
    checks["main_cholesky"] = main["Cholesky"]["falls"]

    # (b) nefertiti's matrix: block-AMG, its blocked matvec and CG against
    # the banded tier
    scene = large_f_scene(seed=SEED)
    vs, fs = scene["mesh-source"]["vertices"], scene["mesh-source"]["faces"]
    M = compute_matrix(vs, fs, alpha=LARGE_F_PARAMS["alpha"], device=dev)
    n = M.shape[0]
    b = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(n, 3)).astype(np.float32), device=dev)
    banded = CholeskySolver(M)
    x_ref = banded.solve(b)
    banded_ms = time_ms(lambda: banded.solve(b), 5)
    banded_tier = banded.tier
    del banded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bamg = CholeskySolver(M, max_block=256)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    h = bamg._big._mg.h
    fine = h.levels[0].op
    x = bamg.solve(b)
    bamg_iters = int(bamg.iters)
    x_warm = bamg.solve(b, x)
    warm_iters = int(bamg.iters)
    bamg_ms = time_ms(lambda: bamg.solve(b), 3, warm=1)
    e_bamg = max_abs(x, x_ref)
    perm, inv = bamg._big.perm, bamg._big.inv_perm
    xp = torch.zeros((bamg._big.n_pad, 3), device=dev)
    xp[:n] = b[perm]
    y_ref = coo_matvec(M, b)
    e_mv = max_abs(fine.matvec(xp)[inv], y_ref)
    block_mv_ms = time_ms(lambda: fine.matvec(xp), 20)
    coo_mv_ms = time_ms(lambda: coo_matvec(M, b), 20)
    blockamg = {"tier": bamg.tier, **mg.describe(h),
                "fine_blocked": isinstance(fine, BlockedOperator),
                "setup_s": setup_s, "iters_cold": bamg_iters,
                "iters_warm": warm_iters, "solve_ms": bamg_ms,
                "max_abs_err_vs_banded": e_bamg,
                "warm_max_abs_err_vs_banded": max_abs(x_warm, x_ref),
                "matvec_max_abs_err_vs_coo": e_mv,
                "block_matvec_ms": block_mv_ms, "coo_matvec_ms": coo_mv_ms}
    del bamg, h, fine, x, x_warm, xp
    torch.cuda.empty_cache()
    cg = ConjugateGradientSolver(M)
    x = cg.solve(b)
    cg_iters = int(cg.iters)
    cg_ms = time_ms(lambda: cg.solve(b), 3, warm=1)
    e_cg = max_abs(x, x_ref)
    del cg, x, M, b, x_ref, y_ref
    torch.cuda.empty_cache()
    checks["blockamg"] = (blockamg["tier"] == "blockamg"
                          and blockamg["fine_blocked"] and e_bamg <= 5e-4
                          and blockamg["warm_max_abs_err_vs_banded"] <= 5e-4
                          and e_mv <= 2e-4 and banded_tier == "banded")
    checks["cg_163842v"] = e_cg <= 5e-4

    # (c) the nefertiti leg under AMG
    amg = run(scene, {**LARGE_F_PARAMS, "solver": "AMG"})
    checks["amg_leg"] = amg["falls"] and amg["tier"] == "amg"
    del scene
    torch.cuda.empty_cache()

    # (d) the cotangent Laplacian on the card against the CPU
    ms = main_path_scene(seed=SEED)["mesh-source"]
    v, f = ms["vertices"], ms["faces"]
    w = np.random.default_rng(SEED).normal(size=v.shape).astype(np.float32)
    cot = {}
    for d in ("cpu", "cuda"):
        vt = torch.as_tensor(v, device=d).requires_grad_(True)
        vals = compute_matrix(vt, f, lambda_=19.0, cotan=True).vals
        (torch.as_tensor(w, device=d)
         * coo_matvec(laplacian_cot(vt, f), vt)).sum().backward()
        cot[d] = (vals.detach().cpu(), vt.grad.cpu())
    cot_err = [max_abs(a, b) / float(b.abs().max())
               for a, b in zip(cot["cuda"], cot["cpu"])]
    checks["cotan"] = max(cot_err) <= 1e-5

    launches = dict(launches)
    checks["launches"] = all(n >= 3 * STEPS for n in launches.values())
    passed = all(checks.values())
    for r in (*main.values(), amg):
        r["losses"] = {"first": float(r["losses"][0]),
                       "last": float(r["losses"][-1])}
    emit({"phase": "solvers", "passed": passed, "checks": checks,
          "main_path": main, "main_loss_rel": rel,
          "tolerance": {"main_path": "first loss 1e-4, every loss 5e-2",
                        "blockamg, cg_163842v": "5e-4 abs vs banded",
                        "matvec": "2e-4 abs vs coo_matvec",
                        "cotan": "1e-5 x max|cpu|"},
          "nefertiti": {"verts": n, "alpha": LARGE_F_PARAMS["alpha"],
                        "banded_tier": banded_tier,
                        "banded_solve_ms": banded_ms,
                        "blockamg": blockamg,
                        "cg": {"iters_cold": cg_iters, "solve_ms": cg_ms,
                               "max_abs_err_vs_banded": e_cg}},
          "amg_leg": amg, "cotan_rel_err": {"vals": cot_err[0],
                                            "grad": cot_err[1]},
          "launches": launches, "card": card})
    return passed, launches


# ---------------------------------------------------------------------------
# sharding: ranks of torch.distributed on the card
# ---------------------------------------------------------------------------

SHARD_LEG_STEPS = {"main_path": 20, "viewpoints": 20, "teaser": 10}


def _views_16_ours():
    """The viewpoints figure's ``views_16_ours`` leg: (scene, params)."""
    from largesteps_torch.figures.viewpoints import legs
    return next((scene, params) for name, scene, params in legs()
                if name == "views_16_ours")


def _shard_scene(leg):
    from largesteps_torch.io.synth import make_scene
    from largesteps_torch.profiling import large_f_scene, main_path_scene
    if leg == "main_path":
        return main_path_scene(seed=SEED)
    if leg == "teaser":
        return large_f_scene(seed=SEED)
    return make_scene(**_views_16_ours()[0])


def _shard_params(leg):
    from largesteps_torch.profiling import LARGE_F_PARAMS, MAIN_PATH_PARAMS
    p = {"main_path": {**MAIN_PATH_PARAMS, "solver": "CG"},
         "teaser": LARGE_F_PARAMS, "viewpoints": _views_16_ours()[1]}[leg]
    return {**p, "steps": SHARD_LEG_STEPS[leg]}


def _shard_render(sharding):
    """One forward and backward of the main path's source mesh on the card
    (13 views at 256²), sharded by ``sharding`` (None: unsharded): the
    whole images, the face ids of the forward raster, and the gradients of
    v and n (summed over the ranks)."""
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.parallel.sharding import (gather_images,
                                                    make_mesh,
                                                    shard_renderer)
    from largesteps_torch.render import kernels as K
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import setup_and_bin, TILE_H
    from largesteps_torch.render.renderer import Renderer, Topology
    from largesteps_torch.render.sh import sh_eval
    dev = torch.device("cuda")
    scene = _shard_scene("main_path")
    r = Renderer(scene, shading=True, boost=3, device=dev)
    if sharding is not None:
        shard_renderer(r, make_mesh(sharding["dp"], sharding["sp"]))
    f = scene["mesh-source"]["faces"]
    topo = Topology(f)
    v = torch.tensor(scene["mesh-source"]["vertices"], device=dev,
                     requires_grad=True)
    with torch.no_grad():
        n0 = compute_vertex_normals(v, f, compute_face_normals(v, f))
    n = n0.clone().requires_grad_(True)
    r.check_overflow(v.detach(), topo)
    img = r.render(v, n, topo)
    w = np.random.default_rng(SEED).normal(size=(13, 256, 256, 4))
    if r.mesh is not None:
        w = w[r.cam_slice, r.row_slice]
    (img * torch.as_tensor(w.astype(np.float32), device=dev)).sum() \
        .backward()
    with torch.no_grad():           # the rank's face ids, as the pipe's
        faces = torch.as_tensor(f.astype(np.int64), device=dev)
        rfb, _, _, counts = setup_and_bin(
            project(v, r.mvps), faces, sh_eval(r.sh_M, n) / np.pi,
            torch.as_tensor(topo.opp.astype(np.int64), device=dev), 256,
            256, r.bin_cap, (r.row_slice.start // TILE_H,
                             8 // r.row_shards))
        fid = K.raster_fwd(rfb, counts, r.res, r.row_slice.start // TILE_H)[3]
    img, fid = img.detach(), fid[..., None]
    if r.mesh is not None:
        img, fid = gather_images(img, r), gather_images(fid, r)
    else:
        img, fid = img.cpu().numpy(), fid.cpu().numpy()
    return {"img": img, "fid": fid[..., 0], "gv": v.grad.cpu().numpy(),
            "gn": n.grad.cpu().numpy()}


def _shard_leg(leg, sharding, transport=False):
    """One driver leg on this rank: losses, final vertices, it/s, peak
    bytes, the tile kernels' launches, rebins; with ``transport`` the
    seconds the collectives took (each behind a device sync, so that the
    wait for the step's kernels is not counted: the run is slower)."""
    import torch.distributed as dist
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.parallel import distributed as pdist
    from largesteps_torch.render import kernels as K
    spent = {"s": 0.0, "calls": 0}
    undo = []
    if transport:
        def timed(mod, name):
            fn = getattr(mod, name)

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
                return out
            setattr(mod, name, wrapper)
            undo.append((mod, name, fn))
        for name in ("all_reduce", "all_gather", "broadcast"):
            timed(dist, name)
        timed(pdist, "ppermute")
    params = _shard_params(leg)
    if transport:
        params["steps"] = 5
    if sharding is not None:
        params["sharding"] = sharding
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    try:
        res = optimize_shape(_shard_scene(leg), params, device="cuda")
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    prof = res["prof"]
    return {"losses": res["losses"][:, 0], "v_final": res["v_final"],
            "losses_all": res["losses"],
            "it_per_s": _steady(res), "wall_s": res["wall_time"],
            "first_step_s": prof["first_step_s"], "setup_s": prof["setup_s"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": dict(K.LAUNCHES),
            "rebin_steps": prof.get("rebin_steps", []),
            "rebin_n": prof["rebin_n"], "sharding": prof.get("sharding"),
            "solver": prof.get("solver", {}).get("tier"),
            "transport_s": spent["s"] if transport else None,
            "transport_calls": spent["calls"] if transport else None}


def _shard_rank(rank, world, jobs):
    """A rank of the ``sharding`` phase: each job (name, kind, args) in
    order; kinds ``render`` (:func:`_shard_render`) and ``leg``
    (:func:`_shard_leg`)."""
    import torch.distributed as dist
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    for name, kind, args in jobs:
        fn = _shard_render if kind == "render" else _shard_leg
        out[name] = fn(*args)
    return out


def _nccl_pair_rank(rank, world):
    """One all-reduce of two NCCL ranks on one card, which NCCL is
    expected to refuse."""
    import torch.distributed as dist
    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def _nccl_pair_refused(card):
    """Whether NCCL refuses two ranks on one card, as the gloo transport of
    ranks that share a card assumes: the refusal's line of the ranks'
    standard error, or None where the all-reduce ran."""
    from largesteps_torch.parallel.distributed import RankFailed, launch
    line = None
    try:
        launch(_nccl_pair_rank, 2, backend="nccl", device="cuda",
               timeout=90.0)
    except RankFailed as e:
        line = next((ln.strip() for ln in str(e).splitlines()
                     if "Duplicate GPU" in ln), str(e).splitlines()[0])
    refused = line is not None and "Duplicate GPU" in line
    emit({"phase": "sharding_nccl_pair", "ranks": 2, "refused": refused,
          "line": line, "card": card})
    return refused


def _halo_kernels(m, sp):
    """The four kernels on row shards 1 and sp − 1 of the main path's
    inputs (a shard with row0 > 0 and the last one), with the tile-row
    offset and halo rows, against their plain versions on the card: ids
    exact, images 1e-5, per-slot sums 1e-4 of the largest."""
    from largesteps_torch.render import kernels as K
    res, rfb, rbb, counts = m["res"], m["rfb"], m["rbb"], m["counts"]
    fid, z, slot, comp, d_out, d_col = (m[k] for k in (
        "fid", "z", "slot", "comp", "d_out", "d_col"))
    H = res[0]
    tyl, hl = H // 32 // sp, H // sp
    out = []
    for s in sorted({1, sp - 1}):
        rows, tiles = slice(s * hl, (s + 1) * hl), slice(s * tyl,
                                                         (s + 1) * tyl)
        nxt = rows.stop - 1 if s == sp - 1 else rows.stop
        C = lambda a, sl: a[:, sl].contiguous()
        halo = tuple(a[:, nxt].contiguous() for a in (fid, z, comp))
        halo_b = halo + (d_out[:, nxt].contiguous(),)
        r0 = s * tyl
        zero = torch.zeros_like(C(fid, rows))
        pl = (C(rbb, tiles), C(counts, tiles), C(fid, rows), C(z, rows),
              C(comp, rows))
        got = {"raster_fwd": K.raster_fwd(C(rfb, tiles), C(counts, tiles),
                                          res, r0),
               "aa_fwd": K.aa_fwd(*pl, res, r0, halo),
               "raster_bwd": (K.raster_bwd(C(rbb, tiles), C(counts, tiles),
                                           C(slot, rows), C(d_col, rows),
                                           zero, zero, res, r0),),
               "aa_bwd": K.aa_bwd(*pl, C(d_out, rows), res, r0, halo_b)}
        want = {"raster_fwd": K.raster_fwd_plain(C(rfb, tiles),
                                                 C(counts, tiles), res, r0),
                "aa_fwd": K.aa_fwd_plain(*pl, res, r0, halo),
                "raster_bwd": (K.raster_bwd_plain(
                    C(rbb, tiles), C(counts, tiles), C(slot, rows),
                    C(d_col, rows), zero, zero, res, r0),),
                "aa_bwd": K.aa_bwd_plain(*pl, C(d_out, rows), res, r0,
                                         halo_b)}
        for name in got:
            g, w = got[name], want[name]
            errs = [max_abs(a, b) for a, b in zip(g, w)]
            scale = [float(b.abs().max()) for b in w]
            if name == "raster_fwd":
                ok = errs[3] == 0.0 and errs[4] == 0.0 and max(errs) <= 1e-5
            elif name == "raster_bwd":
                ok = errs[0] <= 1e-4 * scale[0]
            elif name == "aa_fwd":
                ok = max(errs) <= 1e-5
            else:       # d_colour, per-slot sums, the share row
                ok = (errs[0] <= 1e-5 * scale[0]
                      and errs[1] <= 1e-4 * scale[1]
                      and errs[2] <= 1e-5 * max(scale[2], scale[0]))
            out.append({"sp": sp, "shard": s, "row0": r0, "name": name,
                        "passed": ok, "max_abs_err": errs})
    return out


def phase_sharding(card):
    """Sharding on the card: (a) the four kernels in their row-shard mode
    (tile-row offset, halo rows) against their plain versions at the main
    path's inputs, sp = 2 and 4; (b) one forward and backward of the main
    path's scene sharded ``{"dp": 1, "sp": 2}`` and ``{"dp": 1, "sp": 4}``
    against the unsharded render on the card (ids exact, images 1e-5, the
    summed vertex gradient 1e-4 × max|g|); (c) three driver legs, each
    beside its unsharded run: the main path under ``"CG"`` (so
    ``ShardedCGSolver``) at ``{"dp": 1, "sp": 2}``, 20 steps; the viewpoints
    figure's ``views_16_ours`` leg at ``{"dp": 2, "sp": 2}``, 20 steps; the
    teaser's ``ours`` leg at nefertiti at ``{"dp": 1, "sp": 2}``, 10 steps
    (host bins sliced to rows, rebins decided together): the first loss
    within 1e-4 relative of the unsharded run's, every loss finite and
    falling and within 5e-2 relative, the final vertices the same bits on
    every rank, a rebin in the teaser leg on the same steps on every rank
    and in the unsharded run;
    (d) the main path sharded at 5 steps with its collectives timed
    (transport share), one NCCL rank (world size 1) on the card, and two
    NCCL ranks on the one card, which NCCL must refuse.  The
    ranks share the card (gloo, host-staged halos): their it/s measure the
    plumbing, not a multi-card speed-up."""
    from largesteps_torch.parallel.distributed import launch
    checks = {}
    m = main_path_inputs()
    halo = _halo_kernels(m, 2) + _halo_kernels(m, 4)
    for h in halo:
        emit({"phase": "sharding_kernel", **h, "card": card})
    checks["halo_kernels"] = all(h["passed"] for h in halo)
    halo_err = {k: max(max(h["max_abs_err"]) for h in halo if h["name"] == k)
                for k in ("raster_fwd", "aa_fwd", "raster_bwd", "aa_bwd")}
    del m
    torch.cuda.empty_cache()

    single = {"render": _shard_render(None)}
    for leg in SHARD_LEG_STEPS:
        single[leg] = _shard_leg(leg, None)
        torch.cuda.empty_cache()
    # the unsharded main path under "CG" and teaser leg, for determinism
    REPEATS["main_path_cg"] = (single["main_path"]["losses_all"],
                               single["main_path"]["v_final"])
    REPEATS["teaser"] = (single["teaser"]["losses_all"],
                         single["teaser"]["v_final"])
    sp2 = {"dp": 1, "sp": 2}
    runs = {}
    t0 = time.perf_counter()
    runs[2] = launch(_shard_rank, 2, device="cuda", timeout=400.0, args=(
        [("render", "render", (sp2,)),
         ("main_path", "leg", ("main_path", sp2)),
         ("transport", "leg", ("main_path", sp2, True)),
         ("teaser", "leg", ("teaser", sp2))],))
    runs[4] = launch(_shard_rank, 4, device="cuda", timeout=300.0, args=(
        [("render4", "render", ({"dp": 1, "sp": 4},)),
         ("viewpoints", "leg", ("viewpoints", {"dp": 2, "sp": 2}))],))
    runs[1] = launch(_shard_rank, 1, backend="nccl", device="cuda",
                     timeout=200.0, args=(
                         [("nccl", "leg", ("main_path", {"dp": 1}))],))
    launch_s = time.perf_counter() - t0
    checks["nccl_pair_refused"] = _nccl_pair_refused(card)

    ref = single["render"]
    for world, name in ((2, "render"), (4, "render4")):
        got = [r[name] for r in runs[world]]
        e_img = max(float(np.abs(g["img"] - ref["img"]).max()) for g in got)
        e_fid = max(float(np.abs(g["fid"] - ref["fid"]).max()) for g in got)
        e_gv = max(float(np.abs(g["gv"] - ref["gv"]).max()) for g in got)
        e_gn = max(float(np.abs(g["gn"] - ref["gn"]).max()) for g in got)
        same = all(np.array_equal(g["gv"], got[0]["gv"]) for g in got)
        checks[name] = (e_fid == 0.0 and e_img <= 1e-5 and same
                        and e_gv <= 1e-4 * float(np.abs(ref["gv"]).max())
                        and e_gn <= 1e-4 * float(np.abs(ref["gn"]).max()))
        emit({"phase": "sharding_render", "ranks": world,
              "passed": checks[name], "fid_err": e_fid, "img_err": e_img,
              "gv_err": e_gv, "gv_max": float(np.abs(ref["gv"]).max()),
              "gn_err": e_gn, "same_on_every_rank": same, "card": card})

    launches = {}
    for leg, world, sh in (("main_path", 2, sp2), ("teaser", 2, sp2),
                           ("viewpoints", 4, {"dp": 2, "sp": 2}),
                           ("nccl", 1, {"dp": 1})):
        got = [r[leg] for r in runs[world]]
        want = single["main_path" if leg == "nccl" else leg]
        lw, lg = want["losses"], got[0]["losses"]
        rel = (np.abs(lg - lw) / np.abs(lw)).tolist()
        same = all(np.array_equal(g["v_final"], got[0]["v_final"])
                   and np.array_equal(g["losses"], lg) for g in got)
        rebins = [g["rebin_steps"] for g in got]
        ok = (bool(np.isfinite(lg).all()) and lg[-1] < lg[0]
              and rel[0] <= 1e-4 and max(rel) <= 5e-2 and same
              and all(rb == rebins[0] for rb in rebins)
              and all(n >= 1 for g in got for n in g["launches"].values()))
        if leg == "teaser":
            # the rebin decisions lag a fixed step, so the unsharded run
            # rebins on the same steps
            ok = ok and len(rebins[0]) >= 1 \
                and rebins[0] == want["rebin_steps"]
        checks[leg] = ok
        launches[leg] = [g["launches"] for g in got]
        emit({"phase": "sharding_leg", "leg": leg, "passed": ok,
              "sharding": sh, "ranks": world,
              "backend": runs[world][0]["backend"],
              "steps": len(lg), "loss_first": float(lg[0]),
              "loss_last": float(lg[-1]), "max_rel_loss": max(rel),
              "first_rel_loss": rel[0], "same_on_every_rank": same,
              # reported: at sp = 2 with the cameras unsplit the run takes
              # the unsharded run's steps to the bit
              "v_final_as_unsharded": bool(np.array_equal(
                  got[0]["v_final"], want["v_final"])),
              "it_per_s": [g["it_per_s"] for g in got],
              "unsharded_it_per_s": want["it_per_s"],
              "first_step_s": [g["first_step_s"] for g in got],
              "setup_s": [g["setup_s"] for g in got],
              "peak_bytes": [g["peak_bytes"] for g in got],
              "unsharded_peak_bytes": want["peak_bytes"],
              "solver": got[0]["solver"], "rebin_steps": rebins[0],
              "unsharded_rebin_steps": want["rebin_steps"],
              "layout": [g["sharding"] for g in got],
              "launches": launches[leg], "card": card})
    tr = [r["transport"] for r in runs[2]]
    emit({"phase": "sharding_transport", "leg": "main_path", "steps": 5,
          "ranks": 2, "backend": runs[2][0]["backend"],
          "transport_s": [t["transport_s"] for t in tr],
          "calls": [t["transport_calls"] for t in tr],
          "wall_s": [t["wall_s"] for t in tr],
          "share": [t["transport_s"] / t["wall_s"] for t in tr],
          "card": card})
    passed = all(checks.values())
    emit({"phase": "sharding_summary", "passed": passed, "checks": checks,
          "launch_s": launch_s, "card": card})
    return passed, launches, halo_err


def _repeat(name):
    """(losses, final vertices) of one more run of the determinism pair
    ``name``, made as its first run was."""
    from largesteps_torch.driver import optimize_shape
    from largesteps_torch.io.synth import make_scene
    from largesteps_torch.profiling import MAIN_PATH_PARAMS, main_path_scene
    if name in ("main_path_cg", "teaser"):
        r = _shard_leg("main_path" if name == "main_path_cg" else name, None)
        return r["losses_all"], r["v_final"]
    scene = main_path_scene(seed=SEED) if name == "main_path" else \
        make_scene(source=("icosphere", 4), target=("gourd", 4), n_views=13,
                   res=250, seed=SEED)
    res = optimize_shape(scene, {**MAIN_PATH_PARAMS, "steps": STEPS},
                         device="cuda")
    return res["losses"], res["v_final"]


def phase_determinism(card):
    """Every sum of a step on the card is added in a fixed order, so a run
    repeats itself to the bit: raster_bwd and aa_bwd launched twice on the
    same inputs, at the main path's shapes (phase ``kernels``) and at
    nefertiti's cap (``large_f_kernels``), must give the same bits; so must
    two runs each of the main path (20 steps), the main path under
    ``"CG"`` (20), the dense path (20) and the teaser's ``ours`` leg at
    nefertiti (10 steps, rebins included), in every loss and in the final
    vertices.  The first run of each pair is the one an earlier phase made
    (``main_path``, ``dense_path``, ``sharding``'s unsharded legs); a pair
    whose first run is missing (its phase failed) fails."""
    pairs = {}
    for name in ("main_path", "main_path_cg", "dense_path", "teaser"):
        if name not in REPEATS:
            pairs[name] = {"bit_equal": False, "first_run": "missing"}
            continue
        t0 = time.perf_counter()
        first = REPEATS[name]
        again = _repeat(name)
        torch.cuda.empty_cache()
        (la, va), (lb, vb) = first, again
        rel = np.abs(la - lb) / np.maximum(np.abs(la), 1e-30)
        pairs[name] = {"steps": int(la.shape[0]),
                       "bit_equal": bool(np.array_equal(la, lb)
                                         and np.array_equal(va, vb)),
                       "max_rel_loss_diff": float(rel.max()),
                       "max_abs_vert_diff": float(np.abs(va - vb).max()),
                       "s": time.perf_counter() - t0}
    kernels = {shape: TWICE.get(shape) for shape in ("main_path", "large_f")}
    passed = (all(p["bit_equal"] for p in pairs.values())
              and all(k is not None and k["raster_bwd"] and k["aa_bwd"]
                      for k in kernels.values()))
    emit({"phase": "determinism", "passed": passed, "runs": pairs,
          "kernels_twice": kernels, "card": card})
    return passed


FIGURES_QUICK = ("viewpoints", "influence", "reg_fail")


def phase_figures(card):
    """The ``--quick`` leg of each figure experiment the port added
    (``python -m largesteps_torch.figures.<name> --quick``: viewpoints'
    4-camera pair, influence at α = 0.95, reg_fail's ``ours`` and
    ``reg_400``) on the card: every leg's three files written (the JAX
    experiment's names), its image loss finite and falling, and the tile
    kernels launched in every experiment."""
    import csv
    import importlib
    from largesteps_torch.figures import common
    launches = _zero_launches()
    exps, passed = {}, True
    for exp in FIGURES_QUICK:
        mod = importlib.import_module(f"largesteps_torch.figures.{exp}")
        before = dict(launches)
        t0 = time.perf_counter()
        hausdorff = mod.main(["--quick"])
        legs = {}
        for name, d in hausdorff.items():
            base = os.path.join(common.OUTPUT_DIR, exp, name)
            files = all(os.path.exists(base + s) for s in (
                "_final.ply", "_loss.csv", "_metrics.csv"))
            with open(base + "_loss.csv") as fh:
                im = np.array([float(r[1]) for r in list(csv.reader(fh))[1:]])
            legs[name] = {"hausdorff": d, "files": files, "steps": len(im),
                          "loss_first": float(im[0]),
                          "loss_last": float(im[-1]),
                          "falls": bool(np.isfinite(im).all()
                                        and im[-1] < im[0])}
        ran_ = {k: launches[k] - before[k] for k in launches}
        ok = (bool(legs) and all(l["files"] and l["falls"]
                                 for l in legs.values())
              and all(n >= 1 for n in ran_.values()))
        exps[exp] = {"passed": ok, "legs": legs, "launches": ran_,
                     "s": time.perf_counter() - t0}
        passed = passed and ok
    launches = dict(launches)
    emit({"phase": "figures", "passed": passed, "experiments": exps,
          "output_dir": common.OUTPUT_DIR, "card": card})
    return passed, launches


# the figures' mesh panels (largesteps_torch/figures/draw.py): the
# experiments that draw their final meshes, and the panel's resolution
PANEL_RES = {"comparison": 320, "multiscale": 384, "reg_fail": 320,
             "teaser": 320}
VIS_MAIN_RES = (384, 320)       # mesh_panel's (tiles), a grid's (dense)
VIS_CPU_RES = (256, 192)        # card against CPU: tiles, dense
VIS_TEASER_RES = 384
JAX_VIS_CAP = 768               # largesteps_tpu/vis.py's Renderer default
# a face id that differs from the dense rasterizer's passes when the pixel
# centre lies this close to the boundary of the face in dispute (float32
# edge functions at these sizes round some 1e-5 px apart; the faces are
# ~0.5 px across)
EDGE_EPS_PX = 1e-3


def _flips(rast_a, rast_b):
    """Pixels whose face ids differ between two rasterizations, split into
    depth ties (both covered, depths equal to 1e-6 relative: two faces
    meeting at the pixel centre) and the rest."""
    fa, fb = rast_a[..., 3], rast_b[..., 3]
    flip = fa != fb
    both = flip & (fa > 0) & (fb > 0)
    tie = both & ((rast_a[..., 2] - rast_b[..., 2]).abs()
                  <= 1e-6 * rast_b[..., 2].abs())
    return {"differ": int(flip.sum()), "depth_ties": int(tie.sum()),
            "other": int((flip & ~tie).sum()),
            "covered": int((fb > 0).sum())}


def _edge_px(v_clip, faces, rast_a, rast_b):
    """For each pixel where two rasterizations drew different faces: the
    distance in pixels, in float64, from its centre to the boundary of the
    face in dispute.  That is the face that one drew and the other did not
    (the nearer of the two, or the only one), or at a depth tie (``_flips``)
    the farther from its boundary of the two, since a tie is where two
    faces meet."""
    fa, fb = rast_a[..., 3].long(), rast_b[..., 3].long()
    za, zb = rast_a[..., 2], rast_b[..., 2]
    cam, row, col = torch.nonzero(fa != fb, as_tuple=True)
    if cam.numel() == 0:
        return []
    a, b = fa[cam, row, col], fb[cam, row, col]
    za, zb = za[cam, row, col], zb[cam, row, col]
    both = (a > 0) & (b > 0)
    tie = both & ((za - zb).abs() <= 1e-6 * zb.abs())
    height, width = rast_a.shape[1:3]
    p = torch.stack([col, row], -1).double().cpu()[:, None] + 0.5

    def dist(face):                 # pixel centre to the face's boundary
        tri = v_clip[cam[:, None], faces[(face - 1).clamp_min(0)]]
        tri = tri.double().cpu()                                # (N, 3, 4)
        e0 = torch.stack([(tri[..., 0] / tri[..., 3] + 1) * width / 2,
                          (tri[..., 1] / tri[..., 3] + 1) * height / 2], -1)
        d = e0.roll(-1, dims=1) - e0                            # 3 edges
        t = (((p - e0) * d).sum(-1) / (d * d).sum(-1).clamp_min(1e-300)) \
            .clamp(0, 1)
        return (p - (e0 + t[..., None] * d)).norm(dim=-1).min(dim=1).values

    da, db = dist(a), dist(b)
    near_a = torch.where(both, za <= zb, a > 0).cpu()
    out = torch.where(tie.cpu(), torch.maximum(da, db),
                      torch.where(near_a, da, db))
    return [float(x) for x in out]


def phase_vis(card):
    """The port's ``vis`` on the card.  ``render_mesh_image`` of the main
    path's icosphere-4, with the wireframe and a highlight, at the panels'
    384² (tiles) and 320² (dense) on the card: finite, of its shape, both
    masks drawn; and at 256² (tiles) and 192² (dense) against the same call
    on the CPU (the plain versions): images 1e-5, the wireframe and
    highlight masks exact.  The teaser's nefertiti mesh (icosphere-7,
    327,680 faces) at 384²: its panel's time, and the face ids the tile
    kernels draw at the cap the panel sizes against the dense rasterizer's
    on the card: equal but at pixels whose centre lies within
    ``EDGE_EPS_PX`` of the boundary of the face in dispute (each distance
    printed; depth ties and the rest counted apart), at most 1 in 10⁴ of
    the covered pixels;
    beside the same at JAX's unsized cap of 768, and the tiles whose bins
    pass 768 (counted on the CPU).
    ``self_intersections`` on two triangles that cross and on a closed
    sphere.  Every mesh panel the figures draw from this run's outputs
    (``fit_quality``, ``remesh``, ``figures``) rendered on the card: finite,
    of its shape, its time.  The card's host has no matplotlib, so the
    figures themselves are drawn elsewhere from these outputs
    (``python -m largesteps_torch.figures.draw``).  The tile kernels'
    launches are counted around the phase."""
    from largesteps_torch import vis
    from largesteps_torch.figures import common
    from largesteps_torch.io.ply import read_ply
    from largesteps_torch.ops.shapes import icosphere
    from largesteps_torch.profiling import main_path_scene, large_f_scene
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import (bin_triangles,
                                                  triangle_setup)
    from largesteps_torch.render.raster import rasterize
    from largesteps_torch.render.tile_raster import rasterize_tiles_fwd
    launches = _zero_launches()
    checks, out = {}, {}
    scene = main_path_scene(seed=SEED)
    v, f = scene["mesh-source"]["vertices"], scene["mesh-source"]["faces"]
    hl = np.arange(0, len(f), 37)
    for res in VIS_MAIN_RES:
        t0 = time.perf_counter()
        img, *masks, r = vis.render_panel(v, f, res=res, wireframe=True,
                                          highlight_faces=hl, device="cuda")
        ok = (img.shape == (res, res, 3) and bool(np.isfinite(img).all())
              and all(m.any() for m in masks))
        out[f"card_{res}"] = {"backend": r.backend,
                              "mask_pixels": [int(m.sum()) for m in masks],
                              "s": time.perf_counter() - t0, "passed": ok}
        checks[f"card_{res}"] = ok
    for res in VIS_CPU_RES:
        imgs, masks, secs = {}, {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            imgs[dev], *masks[dev], r = vis.render_panel(
                v, f, res=res, wireframe=True, highlight_faces=hl,
                device=dev)
            secs[dev] = time.perf_counter() - t0
        err = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
        same = [bool(np.array_equal(a, b))
                for a, b in zip(masks["cuda"], masks["cpu"])]
        backend = r.backend
        ok = (err <= 1e-5 and all(same) and imgs["cuda"].shape == (res, res, 3)
              and bool(np.isfinite(imgs["cuda"]).all())
              and all(m.any() for m in masks["cuda"]))
        out[f"main_{res}"] = {"backend": backend, "img_max_abs": err,
                              "masks_equal": same,
                              "mask_pixels": [int(m.sum())
                                              for m in masks["cuda"]],
                              "s": secs, "passed": ok}
        checks[f"main_{res}"] = ok

    # the teaser's mesh: its panel, and its face ids against the dense ones
    big = large_f_scene(seed=SEED)
    vb, fb = big["mesh-source"]["vertices"], big["mesh-source"]["faces"]
    t0 = time.perf_counter()
    img, _, _, renderer = vis.render_panel(vb, fb, res=VIS_TEASER_RES,
                                           device="cuda")
    secs = time.perf_counter() - t0
    res2 = (VIS_TEASER_RES, VIS_TEASER_RES)
    with torch.no_grad():
        faces = torch.as_tensor(fb.astype(np.int64), device="cuda")
        v_ndc = project(torch.as_tensor(vb, device="cuda"), renderer.mvps)
        dense = rasterize(v_ndc, faces, res2, 256)
        tiles = rasterize_tiles_fwd(v_ndc, faces, res2, renderer.bin_cap)
        sized = _flips(tiles, dense)
        edge_px = _edge_px(v_ndc, faces, tiles, dense)
        at_jax = _flips(rasterize_tiles_fwd(v_ndc, faces, res2, JAX_VIS_CAP),
                        dense)
        # the bins' occupancy a tile at JAX's cap, counted on the CPU
        vc, fc = v_ndc.cpu(), faces.cpu()
        rec_fwd, _ = triangle_setup(vc, fc, torch.zeros((len(vb), 3)),
                                    torch.zeros_like(fc), *res2)
        counts = bin_triangles(rec_fwd, vc, fc, *res2, 8)[1]
    sized["edge_px"] = edge_px
    ok = (sized["differ"] <= sized["covered"] // 10_000
          and len(edge_px) == sized["differ"]
          and all(d <= EDGE_EPS_PX for d in edge_px)
          and bool(np.isfinite(img).all()) and img.shape == (*res2, 3))
    out["teaser_mesh"] = {
        "faces": len(fb), "res": VIS_TEASER_RES, "cap": renderer.bin_cap,
        "occupancy_max": int(counts.max()), "panel_s": secs,
        "fids_vs_dense": sized, f"fids_vs_dense_at_cap_{JAX_VIS_CAP}": at_jax,
        f"tiles_over_{JAX_VIS_CAP}": int((counts > JAX_VIS_CAP).sum()),
        "tiles": int(counts.numel()), "passed": ok}
    checks["teaser_mesh"] = ok

    # self-intersections: two crossing triangles, and a closed sphere
    cross_v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.2, 0.2, -0.5],
                        [0.2, 0.2, 0.5], [0.8, 0.1, 0]], np.float64)
    cross = vis.self_intersections(cross_v, np.array([[0, 1, 2], [3, 4, 5]]))
    sphere = vis.self_intersections(*icosphere(2))
    checks["self_intersections"] = cross == [0, 1] and sphere == []
    out["self_intersections"] = {"crossing": cross, "sphere": sphere}

    # every mesh panel of this run's figures, on the card
    panels = {}
    for exp, res in PANEL_RES.items():
        d = os.path.join(common.OUTPUT_DIR, exp)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            if not name.endswith("_final.ply"):
                continue
            mesh = read_ply(os.path.join(d, name))
            t0 = time.perf_counter()
            img = vis.render_mesh_image(mesh["vertices"], mesh["faces"],
                                        res=res, device="cuda")
            panels[f"{exp}/{name}"] = {
                "faces": len(mesh["faces"]), "res": res,
                "s": time.perf_counter() - t0,
                "ok": bool(np.isfinite(img).all())
                and img.shape == (res, res, 3)
                and float(np.percentile(img, 99.5)) > 0}
    checks["panels"] = bool(panels) and all(p["ok"] for p in panels.values())
    launches = dict(launches)
    checks["launches"] = (launches["raster_fwd"] >= 1
                          and launches["aa_fwd"] >= 1)
    passed = all(checks.values())
    emit({"phase": "vis", "passed": passed, "checks": checks, **out,
          "panels": panels, "launches": launches,
          "matplotlib_on_host": False, "output_dir": common.OUTPUT_DIR,
          "tolerance": "main-path panels card vs CPU: images 1e-5 abs, "
                       "masks exact; nefertiti ids vs dense: differing "
                       "pixels at most 1 in 1e4 of the covered, each "
                       f"within {EDGE_EPS_PX} px of the disputed face's "
                       "edge",
          "card": card})
    return passed, launches


def phase_bench(card):
    """``largesteps_torch.benchmarks.bench``'s functions as its ``main``
    runs them, the nefertiti line at 10 steps: their JSON lines, each
    printed, with the launch counts of the tile kernels around them.
    Passes when every metric is there, finite, and ``opt_iters_per_s``
    comes last."""
    from largesteps_torch.benchmarks import bench
    launches = _zero_launches()
    lines = []
    for fn in (bench.bench_solve, bench.bench_raster, bench.bench_ablate,
               lambda: bench.bench_step_nefertiti(steps=10),
               bench.bench_sharded_cg, lambda: [bench.bench_step()]):
        for line in fn():
            emit({"phase": "bench", **line})
            lines.append(line)
    launches = dict(launches)
    names = [line["metric"] for line in lines]
    want = [*(f"raster_{k}_mpix_per_s" for k in ("fwd", "fwdbwd")),
            *(f"render_fwdbwd_ms_ablate_{k}" for k in
              ("none", "aabwd", "rbwd", "scatter")),
            "opt_iters_per_s_163842v_sustained", "nefertiti_first_step_s",
            "nefertiti_rebin_ms", "nefertiti_rebin_n", "cg_163842v_gpu1_ms",
            "opt_iters_per_s"]
    solves = [n for n in names if n.startswith("from_differential_ms_")]
    passed = (all(n in names for n in want) and len(solves) == 4
              and "from_differential_ms_cg_163842v" in solves
              and any(n.startswith("sharded_cg_163842v_gpu2") for n in names)
              and names[-1] == "opt_iters_per_s"
              and all(np.isfinite(line["value"]) for line in lines)
              and all(n >= 1 for n in launches.values()))
    emit({"phase": "bench_summary", "passed": passed, "metrics": names,
          "launches": launches, "card": card})
    return passed, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else None
    if only:
        only = [p for name in only for p in (*NEEDS.get(name, ()), name)]
    name, line, ptxas = phase_card()
    card = {"name": name, "nvidia_smi": line}
    results = {}
    for phase, fn in (("kernels", lambda c: phase_kernels(c, ptxas)),
                      ("render", phase_render_cpu_vs_card),
                      ("main_path", phase_main_path),
                      ("probe_kernels", phase_probe_kernels),
                      ("dense_render", phase_dense_render),
                      ("dense_path", phase_dense_path),
                      ("large_f_kernels", phase_large_f_kernels),
                      ("large_f_pipes", phase_large_f_pipes),
                      ("large_f", phase_large_f),
                      ("fit_quality", phase_fit_quality),
                      ("remesh", phase_remesh),
                      ("solvers", phase_solvers),
                      ("sharding", phase_sharding),
                      ("determinism", phase_determinism),
                      ("figures", phase_figures),
                      ("vis", phase_vis),
                      ("bench", phase_bench)):
        if only and phase not in only:
            continue
        t0 = time.perf_counter()
        try:
            results[phase] = fn(card)
        except Exception:                 # report, and run the next phase
            traceback.print_exc()
            emit({"phase": phase, "passed": False, "error": "exception"})
            results[phase] = None
        emit({"phase": f"{phase}_seconds", "s": time.perf_counter() - t0})
    if only:
        # a part of the run: each phase's own pass, no kernels line
        bad = [p for p in only if not (results.get(p) is True or (
            isinstance(results.get(p), tuple) and results[p][0]))]
        print(f"chip_smoke: phases {only}, failed {bad}", file=sys.stderr)
        return 1 if bad else 0
    k_ok, table = results["kernels"] or (False, {})
    m_ok, launches = results["main_path"] or (False, {})
    fk_ok, f_table = results["large_f_kernels"] or (False, {})
    f_ok, f_launches, f_cap = results["large_f"] or (False, {}, None)
    p_ok, p_table = results["probe_kernels"] or (False, {})
    q_ok, q_launches = results["fit_quality"] or (False, {})
    r_ok, r_launches = results["remesh"] or (False, {})
    s_ok, s_launches = results["solvers"] or (False, {})
    sh_ok, sh_launches, sh_err = results["sharding"] or (False, {}, {})
    fg_ok, fg_launches = results["figures"] or (False, {})
    v_ok, v_launches = results["vis"] or (False, {})
    rd_ok, rd_launches = results["render"] or (False, {})
    b_ok, b_launches = results["bench"] or (False, {})
    # the kernels were held at the run's shapes: its cap is theirs
    fk_ok = fk_ok and all(row["cap"] == f_cap for row in f_table.values())
    failed = [p for p, ok in (("kernels", k_ok),
                              ("render", rd_ok),
                              ("main_path", m_ok),
                              ("probe_kernels", p_ok),
                              ("dense_render", results["dense_render"]),
                              ("dense_path", results["dense_path"]),
                              ("large_f_kernels", fk_ok),
                              ("large_f_pipes", results["large_f_pipes"]),
                              ("large_f", f_ok),
                              ("fit_quality", q_ok),
                              ("remesh", r_ok),
                              ("solvers", s_ok),
                              ("sharding", sh_ok),
                              ("determinism", results["determinism"]),
                              ("figures", fg_ok),
                              ("vis", v_ok),
                              ("bench", b_ok)) if not ok]
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    for k, row in table.items():
        row["launches"] = launches[k]
        big = f_table[k]
        row["large_f"] = {key: big[key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "cap")}
        row["large_f"]["launches"] = f_launches[k]
        row["fit_quality_launches"] = q_launches[k]
        row["remesh_launches"] = r_launches[k]
        row["solvers_launches"] = s_launches[k]
        # each sharded leg's launches, rank by rank
        row["sharding_launches"] = {leg: [r[k] for r in ranks]
                                    for leg, ranks in sh_launches.items()}
        row["sharding_max_abs_err"] = sh_err[k]
        row["figures_launches"] = fg_launches[k]
        row["vis_launches"] = v_launches[k]
        row["render_core_launches"] = rd_launches[k]
        row["bench_launches"] = b_launches[k]
    # the micro-benchmarks' kernels: their own launches, no large-F run;
    # ptxas's line of the instantiation that ran at each shape
    for k, row in p_table.items():
        for r in (row, *row["other_shapes"]):
            r["ptxas"] = ran(ptxas[k], micro_instance(k, r["launch"]))
    emit({"kernels": list(table.values()) + list(p_table.values())})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
