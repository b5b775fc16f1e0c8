"""The optimization driver: the small-F, unsharded, no-remesh path.

Port of ``largesteps_tpu/driver/optimize_shape.py``: render the reference
images, parameterize v → u with M = I + λL (or optimize the coordinates
directly), then loop [solve → normals → render → image loss + Laplacian
regularizer → backward → optimizer step].  Loss history stays on the device
and is fetched at the end; every ``nan_check_every`` steps the host checks
it for divergence.  Checkpoints use the JAX package's format, so a run of
either package resumes in the other.

Remeshing, host-computed bins (meshes of ``host_bin_faces`` or more) and
sharding are later slices (ROADMAP.md Queue 1) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..core.geometry import compute_matrix, laplacian_uniform
from ..core.optimize import AdamUniform
from ..core.parameterize import get_solver, to_differential
from ..core.solvers import solve
from ..core.sparse import coo_matvec
from ..ops.mesh import remove_duplicates
from ..ops.normals import compute_face_normals, compute_vertex_normals
from ..render.renderer import Renderer, Topology
from .checkpoint import load_checkpoint, save_checkpoint, state_from_numpy

__all__ = ["optimize_shape", "default_params"]


def default_params():
    """Defaults of the JAX driver (reference scripts/main.py:30-44)."""
    return {
        "time": -1,            # optimization time (minutes); overrides steps
        "steps": 100,
        "step_size": 0.01,
        "boost": 1,            # antialias position-gradient boost
        "smooth": True,        # large-steps parameterization vs coordinates
        "shading": True,       # shaded vs silhouette rendering
        "reg": 0.0,
        "solver": "Cholesky",
        "lambda": 1.0,
        "alpha": None,
        "remesh": -1,
        "optimizer": "AdamUniform",
        "use_tr": True,        # optimize a global translation too
        "loss": "l2",
        "bilaplacian": True,
        "record_verts": False,
        "sharding": None,
        "host_bin_faces": 32768,
        "checkpoint_every": 0,  # steps between checkpoints (0 = off)
        "checkpoint_path": None,
        "resume": None,         # checkpoint to resume from
        "nan_check_every": 25,  # steps between divergence checks (0 = off)
    }


# the step's layers as named ranges for torch.profiler (largesteps_torch.
# profiling reads them); a few microseconds a step when no profiler runs
_span = torch.profiler.record_function


@dataclass
class _Epoch:
    """Everything tied to one topology epoch."""
    v_unique: np.ndarray
    f_unique: np.ndarray
    duplicate_idx: np.ndarray
    f_src: np.ndarray
    topology: Topology
    L: Any = None
    M: Any = None
    u: Any = None
    solver: Any = None


def _check_supported(p, n_faces):
    remesh = p["remesh"]
    if (isinstance(remesh, (list, tuple)) and len(remesh)) or \
            (isinstance(remesh, int) and remesh >= 0):
        raise NotImplementedError("remeshing is a later slice "
                                  "(ROADMAP.md Queue 1, item 7)")
    if p["sharding"]:
        raise NotImplementedError("sharding is a later slice "
                                  "(ROADMAP.md Queue 1, item 9)")
    if n_faces >= int(p["host_bin_faces"]):
        raise NotImplementedError(
            f"{n_faces} faces need host-computed bins, the large-F slice "
            f"(ROADMAP.md Queue 1, item 8)")
    if p["optimizer"] == "Adam":
        raise NotImplementedError("plain Adam is still to port "
                                  "(ROADMAP.md Queue 1, item 1)")
    if p["optimizer"] != "AdamUniform":
        raise ValueError(f"unknown optimizer {p['optimizer']!r}")


def _build_epoch(v_src, f_src, p, renderer, device):
    v_unique, f_unique, duplicate_idx = remove_duplicates(v_src, f_src)
    st = _Epoch(v_unique=v_unique, f_unique=f_unique,
                duplicate_idx=duplicate_idx,
                f_src=np.asarray(f_src, np.int32), topology=Topology(f_src))
    st.L = laplacian_uniform(len(v_unique), f_unique, device=device)
    # size the bins for this epoch before the first render: an overflowing
    # bin under-draws its tile with no signal
    renderer.check_overflow(v_src, st.topology)
    if p["smooth"]:
        st.M = compute_matrix(v_unique, f_unique, lambda_=p["lambda"],
                              alpha=p["alpha"], device=device)
        st.u = to_differential(
            st.M, torch.as_tensor(v_unique, dtype=torch.float32,
                                  device=device))
        st.solver = get_solver(st.M, p["solver"])   # factor once per epoch
    return st


def _make_step(st: _Epoch, p, renderer, ref_imgs, theta, optimizer):
    """One optimizer step; returns the device scalars (image loss, logged
    bilaplacian magnitude)."""
    dev = renderer.device
    dup = torch.as_tensor(st.duplicate_idx.astype(np.int64), device=dev)
    f_unique = torch.as_tensor(st.f_unique.astype(np.int64), device=dev)
    reg = float(p["reg"])
    l1 = p["loss"] == "l1"

    def step():
        optimizer.zero_grad(set_to_none=True)
        with _span("solve"):
            v_unique = solve(st.solver, theta["u"]) if p["smooth"] \
                else theta["u"]
        with _span("normals"):
            fn = compute_face_normals(v_unique, f_unique)
            n_opt = compute_vertex_normals(v_unique, f_unique, fn)[dup]
        with _span("render"):
            tr = theta["tr"] if p["use_tr"] \
                else torch.zeros_like(theta["tr"])
            imgs = renderer.render(tr + v_unique[dup], n_opt, st.topology)
        with _span("loss"):
            diff = imgs - ref_imgs
            im_loss = diff.abs().mean() if l1 else diff.square().mean()
            Lv = coo_matvec(st.L, v_unique)
            reg_loss = Lv.square().mean() if p["bilaplacian"] \
                else (v_unique * Lv).mean()
            loss = im_loss + reg * reg_loss
        with _span("backward"):
            loss.backward()
        with _span("optimizer"):
            if not p["use_tr"]:
                theta["tr"].grad = torch.zeros_like(theta["tr"])
            optimizer.step()
        # always log the bilaplacian magnitude, like reference main.py:200
        return im_loss.detach(), Lv.detach().square().mean()

    return step


def _solved(st, theta, p):
    with torch.no_grad():
        return solve(st.solver, theta["u"]) if p["smooth"] \
            else theta["u"].detach()


@dataclass
class _Run:
    """What the step loop needs, as :func:`_prepare` builds it."""
    st: _Epoch
    renderer: Renderer
    ref_imgs: torch.Tensor
    v_ref: torch.Tensor
    f_ref: np.ndarray
    v_src: np.ndarray
    f_src: np.ndarray
    theta: dict
    optimizer: torch.optim.Optimizer
    step: Any
    step_size: float
    resume: Any


def _prepare(scene, p, dev) -> _Run:
    """Reference images, the first epoch, theta and the optimizer (or their
    state from ``p["resume"]``), and the step function."""
    v_src = np.asarray(scene["mesh-source"]["vertices"], np.float32)
    f_src = np.asarray(scene["mesh-source"]["faces"], np.int32)
    resume = load_checkpoint(p["resume"]) if p["resume"] else None
    if resume is not None:
        v_src = resume["v_src"].astype(np.float32)
        f_src = resume["f_src"].astype(np.int32)
    _check_supported(p, f_src.shape[0])

    f_ref = np.asarray(scene["mesh-target"]["faces"], np.int32)
    v_ref = torch.as_tensor(np.asarray(scene["mesh-target"]["vertices"],
                                       np.float32), device=dev)
    with torch.no_grad():
        if "normals" in scene["mesh-target"]:
            n_ref = torch.as_tensor(np.asarray(
                scene["mesh-target"]["normals"], np.float32), device=dev)
        else:
            n_ref = compute_vertex_normals(
                v_ref, f_ref, compute_face_normals(v_ref, f_ref))
        renderer = Renderer(scene, shading=p["shading"], boost=p["boost"],
                            device=dev)
        ref_topo = Topology(f_ref)
        renderer.check_overflow(v_ref, ref_topo)
        ref_imgs = renderer.render(v_ref, n_ref, ref_topo)

    st = _build_epoch(v_src, f_src, p, renderer, dev)
    step_size = float(p["step_size"])
    if resume is not None:
        step_size = float(resume["meta"]["step_size"])
        theta, load_moments = state_from_numpy(resume["theta"],
                                               resume["opt_state"], dev)
    else:
        u0 = st.u if p["smooth"] else torch.as_tensor(
            st.v_unique, dtype=torch.float32, device=dev)
        theta = {"u": u0.detach().clone().requires_grad_(True),
                 "tr": torch.zeros((1, 3), dtype=torch.float32, device=dev,
                                   requires_grad=True)}
    optimizer = AdamUniform([theta["tr"], theta["u"]], lr=step_size)
    if resume is not None:
        load_moments(optimizer)
    step = _make_step(st, p, renderer, ref_imgs, theta, optimizer)
    return _Run(st=st, renderer=renderer, ref_imgs=ref_imgs,
                v_ref=v_ref, f_ref=f_ref, v_src=v_src, f_src=f_src,
                theta=theta, optimizer=optimizer, step=step,
                step_size=step_size, resume=resume)


def optimize_shape(scene, params=None, device=None):
    """Run the shape optimization on ``device`` (CUDA unless the caller
    asks for the CPU).  ``scene`` is a scene-params dict
    (:func:`largesteps_torch.io.synth.make_scene`).  Returns the JAX
    driver's result dict: losses (steps, 2) = (image loss, bilaplacian
    magnitude), v_final, f_final, tr, iters, wall_time, prof and the
    reference images and mesh."""
    dev = resolve_device(device)
    p = default_params()
    if params:
        p.update(params)
    t_setup0 = time.perf_counter()
    run = _prepare(scene, p, dev)
    st, theta, optimizer, step = run.st, run.theta, run.optimizer, run.step
    v_src, f_src, resume = run.v_src, run.f_src, run.resume
    step_size = run.step_size

    steps = int(p["steps"])
    opt_time = float(p["time"]) * 60.0
    if float(p["time"]) > 0:
        steps = -1
    start_it = int(resume["meta"]["step"]) if resume is not None else 0

    result = {"vert_steps": [], "tr_steps": [], "f": [f_src.copy()],
              "losses": [], "im_ref": run.ref_imgs.cpu().numpy(),
              "v_ref": run.v_ref.cpu().numpy(), "f_ref": run.f_ref.copy()}
    prof = {"first_step_s": 0.0,
            "setup_s": time.perf_counter() - t_setup0}

    def checkpoint(it):
        save_checkpoint(p["checkpoint_path"], theta=theta,
                        optimizer=optimizer, v_src=v_src, f_src=f_src,
                        step=it, step_size=step_size, remesh_schedule=[])

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    it = start_it
    loss_log = []
    t0 = time.perf_counter()
    t = t0
    while (steps > 0 and it < steps) or (steps < 0 and (t - t0) < opt_time):
        if p["checkpoint_every"] and p["checkpoint_path"] and it > start_it \
                and it % p["checkpoint_every"] == 0:
            checkpoint(it)
        t_st = time.perf_counter()
        losses = step()
        if it == start_it:
            sync()
            prof["first_step_s"] = time.perf_counter() - t_st
        loss_log.append(torch.stack(losses))
        if p["nan_check_every"] and (it + 1) % int(p["nan_check_every"]) == 0:
            # both scalars: NaN vertices render as background, leaving the
            # image loss finite while the bilaplacian magnitude goes NaN
            if not bool(torch.isfinite(loss_log[-1]).all()):
                warnings.warn(f"non-finite loss/reg at iteration {it}; "
                              f"aborting optimization (diverged)")
                result["diverged"] = True
                it += 1
                break
        if p["record_verts"]:
            v_now = _solved(st, theta, p)
            result["vert_steps"].append(
                v_now.cpu().numpy()[st.duplicate_idx])
            result["tr_steps"].append(theta["tr"].detach().cpu().numpy())
        it += 1
        if steps < 0:
            sync()       # a time budget counts executed seconds
        t = time.perf_counter()
    sync()
    t = time.perf_counter()

    if p["checkpoint_every"] and p["checkpoint_path"]:
        checkpoint(it)

    result["losses"] = (torch.stack(loss_log).cpu().numpy().astype(np.float64)
                        if loss_log else np.zeros((0, 2)))
    result["v_final"] = _solved(st, theta, p).cpu().numpy()[st.duplicate_idx]
    result["f_final"] = st.f_src.copy()
    result["tr"] = theta["tr"].detach().cpu().numpy()
    result["iters"] = it
    result["wall_time"] = t - t0
    result["prof"] = prof
    return result
