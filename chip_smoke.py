"""Smoke run of the PyTorch/CUDA port (largesteps_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``largesteps_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, holds a
2-view render on the card against the same render on the CPU, and runs the
main path (the ``bench.py:bench_step`` scene: icosphere-4 fitted to gourd-4,
13 views at 256², shaded, boost 3, λ = 19, l2 loss, AdamUniform) for 20
steps through the port's ``optimize_shape``.  Then the large-F path at the
teaser's nefertiti scale (icosphere-7, 327,680 faces, fitted to gourd-7, 13
views at 256²): each kernel against its plain version on the 13 views'
host bins at the run's cap, the batched and the camera-sequential prebinned
pipes against each other, and 20 steps of the teaser's ``ours`` leg
(boost 3, α = 0.98, l1, AdamUniform at 2e-3; host bins, device rebins, the
banded solver).  Prints one JSON line per phase, then the kernel table, the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Exits non-zero, without the ``ok`` line, if there is no CUDA
device or any phase fails.  Imports neither jax nor largesteps_tpu.
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

SEED = 0
STEPS = 20
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# non-tensor FLOP/s; the card's power limit is printed beside every number
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
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


def emit(obj):
    print(json.dumps(obj), flush=True)


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
        # per-slot sums by atomics: the summation order differs
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
    """The template argument, as mangled, of the kernel ``name`` that runs
    at ``cap`` with ``channels`` colour channels: the antialias kernels'
    channels; raster_bwd's whether its per-slot table fits shared memory
    (``RB_TABLE_MAX`` in ``csrc/common.cuh``)."""
    if name == "raster_bwd":
        return "ILb1E" if cap * 18 * F32 <= 200 * 1024 else "ILb0E"
    return f"ILi{channels}E"


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
            "n_faces": f.shape[0]}


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
    time, its plain version's (the mean of ``plain_reps`` calls, or with 0
    the one call compared), its bound by this data's work, and the errors;
    returns (passed, {name: row of the kernels line})."""
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
            "library_ms": None}
        emit({"phase": phase, "name": name, "passed": passed,
              "max_abs_err": errs, "max_rel_err": [
                  e / s if s else 0.0 for e, s in zip(errs, scales)],
              "tolerance": tol, "planted_errors_caught": caught,
              "ms": ms, "plain_ms": plain_ms,
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


def phase_kernels(card, ptxas):
    """Each kernel against its plain version on one forward+backward's real
    inputs at the main path's shapes."""
    m = main_path_inputs()
    ok, table = check_kernels(m, card, "kernel", 50, 3)
    for name, row in table.items():
        if name in REDESIGNED:
            row.update({"redesigned": REDESIGNED[name],
                        "ptxas": ran(ptxas[name], instance(
                            name, m["cap"], m["comp"].shape[-1]))})
    return ok, table


def phase_large_f_kernels(card):
    """Each kernel against its plain version at the large-F run's shapes:
    13 views of nefertiti through the epoch's host bins (the plain versions
    timed on the one call compared)."""
    m = large_f_inputs()
    ok, table = check_kernels(m, card, "large_f_kernel", 10, 0)
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
    return passed


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, line, ptxas = phase_card()
    card = {"name": name, "nvidia_smi": line}
    results = {}
    for phase, fn in (("kernels", lambda c: phase_kernels(c, ptxas)),
                      ("render", phase_render_cpu_vs_card),
                      ("main_path", phase_main_path),
                      ("large_f_kernels", phase_large_f_kernels),
                      ("large_f_pipes", phase_large_f_pipes),
                      ("large_f", phase_large_f)):
        t0 = time.perf_counter()
        try:
            results[phase] = fn(card)
        except Exception:                 # report, and run the next phase
            traceback.print_exc()
            emit({"phase": phase, "passed": False, "error": "exception"})
            results[phase] = None
        emit({"phase": f"{phase}_seconds", "s": time.perf_counter() - t0})
    k_ok, table = results["kernels"] or (False, {})
    m_ok, launches = results["main_path"] or (False, {})
    fk_ok, f_table = results["large_f_kernels"] or (False, {})
    f_ok, f_launches, f_cap = results["large_f"] or (False, {}, None)
    # the kernels were held at the run's shapes: its cap is theirs
    fk_ok = fk_ok and all(row["cap"] == f_cap for row in f_table.values())
    failed = [p for p, ok in (("kernels", k_ok),
                              ("render", results["render"]),
                              ("main_path", m_ok),
                              ("large_f_kernels", fk_ok),
                              ("large_f_pipes", results["large_f_pipes"]),
                              ("large_f", f_ok)) if not ok]
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    for k, row in table.items():
        row["launches"] = launches[k]
        big = f_table[k]
        row["large_f"] = {key: big[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "cap")}
        row["large_f"]["launches"] = f_launches[k]
    emit({"kernels": list(table.values())})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
