"""The optimization driver, with remeshing and sharding.

Port of ``largesteps_tpu/driver/optimize_shape.py``: render the reference
images, parameterize v → u with M = I + λL (or optimize the coordinates
directly), then loop [solve → normals → render → image loss + Laplacian
regularizer → backward → optimizer step].  Loss history stays on the device
and is fetched at the end; every ``nan_check_every`` steps the host checks
it for divergence.  Checkpoints use the JAX package's format, so a run of
either package resumes in the other.

The renderer takes the tile kernels where the resolution tiles into
32×128 pixels and the dense rasterizer (``raster_chunk`` faces a step)
elsewhere.  On the tiles, meshes of ``host_bin_faces`` faces or more take
the large-F path: precomputed bins, which one :class:`.bins.EpochBins` an
epoch owns, with their rebin policy.

``scene`` is a scene dict or the path of a scene XML file.  The optimizer
is AdamUniform, plain Adam or a callable (see :func:`_make_optimizer`).
``solver`` is ``"Cholesky"`` (dense inverse, banded or block-AMG by size
and bandwidth), ``"CholeskyHost"``, ``"CG"`` or ``"AMG"``.  The iterative
ones are warm-started as the JAX driver does it: a step's forward solve
from the last step's solved vertices, its backward solve from the last
step's gradient in u; at an epoch's start (and on resume) from the epoch's
source vertices and from zero.  ``prof["solve_iters"]`` holds each step's
(forward, backward) iteration counts.

``remesh`` schedules Botsch-Kobbelt remeshes: an int ≥ 0 is one remesh at
that step (0: before the first), a list is a schedule taken in order.  At a
scheduled step the solved vertices are remeshed on the host to half their
mean edge length (``native/remesh.cpp``), the old epoch is freed, the new
one is built, and the optimizer starts afresh at 0.8 × the step size,
keeping the translation.

``sharding`` (an int dp, or ``{"dp", "sp"}``) runs the step on a ``(dp,
sp)`` mesh of ranks: ``dp · sp`` processes of an initialized
``torch.distributed`` process group, each calling ``optimize_shape`` with
the same arguments (``parallel.distributed.launch`` starts them); without
that process group it raises.  Each rank renders its shard of the views
(``parallel.sharding``): the reference images, the loss over its pixels as
its share of the mean over all of them, and the gradients of the
renderer's inputs summed over the ranks.  The parameters, the optimizer,
the solver (``"CG"`` takes the edge-sharded ``ShardedCGSolver``), the
remesher and the checkpoints (written by rank 0) see replicated state, and
the host decisions that could part the ranks (a rebin, its route, a time
budget's end) are taken together.  Every sum of a step is added in a fixed
order on the card (``ops/segment.py``, the tile kernels' sorted sums), so
the ranks' replicated work gives them the same bits without a broadcast,
and every rank returns the same result; with the tile rows in two shards
and the cameras unsplit it is the unsharded run's, bit for bit.

On the card, an epoch that bins on the device each step (no host bins),
on an unsharded mesh and the tile renderer, whose solver reads nothing on
the host (the dense inverse, or ``smooth`` off) runs its step from one CUDA
graph (:class:`_StepGraph`): the epoch's first step runs eagerly, the
second captures the step's work (solve → normals → render → loss →
backward) and replays it, and every later step replays it.  The optimizer
runs outside the graph, on the gradients the graph writes, so every step
still calls its ``zero_grad`` and ``step``.  A replay runs the eager
step's kernels in its order, so a graphed fit is the eager fit's bits.
``prof["graph"]`` counts the captures, their seconds, the replays and the
eager steps by reason (:func:`_graph_reason`, and ``before_capture``).

The step's layers, the pipe's setup and scatter, the adjoint solve and
every host wait on the card are spans (:mod:`largesteps_torch.spans`),
recorded while a ``torch.profiler`` runs or, with ``trace``, in every step;
their records go out in ``prof["trace"]``.  The setup's spans always time
its parts (``prof``'s ``ref_render_s``, ``topology_s``, ``host_bins_s``).
Tracing changes no result.
"""
from __future__ import annotations

import gc
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import spans as _spans
from .._device import resolve_device
from ..core.geometry import compute_matrix, laplacian_uniform
from ..core.optimize import Adam, AdamUniform
from ..core import banded as _banded
from ..core.banded import BandedSolver
from ..core.multigrid import describe
from ..core.parameterize import get_solver, to_differential
from ..core.solvers import solve
from ..core.sparse import coo_matvec
from ..io.xml_scene import load_scene
from ..native import remesh as native_remesh
from ..ops.mesh import average_edge_length, remove_duplicates
from ..ops.normals import (compute_face_normals, compute_vertex_normals,
                           corner_segments)
from ..parallel import distributed as pdist
from ..parallel.sharding import gather_images, make_mesh, shard_renderer
from ..parallel.tri_shard import ShardedCGSolver
from ..render import kernels as _kernels
from ..render.renderer import Renderer, Topology
from ..spans import Recorder, setup_span, span as _span
from .bins import EpochBins, host_bins, rebin_record, takes_bins
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
        "raster_chunk": 128,    # faces a step of the dense rasterizer
        # large-F path: meshes of this many faces or more take precomputed
        # bins (host at epoch build, device mid-run) instead of the traced
        # per-step binning
        "host_bin_faces": 32768,
        "host_bin_cap": None,   # least bin capacity there (None: from the
                                # occupancy)
        "rebin_every": 16,      # most steps between rebins
        "rebin_margin": 4.0,    # bbox expansion (px) that keeps stale bins
                                # valid while no vertex moves margin/2 px
        "rebin_auto": True,     # also rebin once a step's measured screen
                                # displacement since the bins passes margin/2
        "cull_backfaces": False,  # drop back-facing triangles from those bins
                                  # (closed meshes only)
        "max_inflight": 8,      # most steps queued on the device there
        "checkpoint_every": 0,  # steps between checkpoints (0 = off)
        "checkpoint_path": None,
        "resume": None,         # checkpoint to resume from
        "nan_check_every": 25,  # steps between divergence checks (0 = off)
        "trace": False,         # record every step's spans, events and
                                # host waits into prof["trace"]
    }


def _sync(dev, site):
    """Wait for the card to drain (a host wait at ``site``)."""
    with _span("host_wait", site):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    _spans.waited()


def _allocated(dev):
    """Bytes of tensors allocated on the card (None on the CPU)."""
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


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
    bins: EpochBins | None = None  # the large-F path's (None: traced bins)
    occupancy: int = 0          # bin occupancy of v_src at epoch build

    def bin_cap(self, renderer):
        """The cap of the epoch's bins (on traced bins, the renderer's)."""
        return renderer.bin_cap if self.bins is None else self.bins.cap


def _make_mesh(p):
    """The run's ``(dp, sp)`` mesh from ``p["sharding"]`` (an int dp or a
    dict), or None.  Raises without a process group of dp · sp ranks."""
    sh = p["sharding"]
    if not sh:
        return None
    sh = {"dp": sh} if isinstance(sh, int) else dict(sh)
    return make_mesh(int(sh.get("dp", 1)), int(sh.get("sp", 1)))


def _make_solver(M, p, mesh):
    """The epoch's solver: with a mesh and ``"CG"``, the edge-sharded CG
    (JAX's ``optimize_shape.py:264-274``); else ``get_solver``'s, every
    rank solving the same replicated system to the same bits (the sums
    before a solve add in a fixed order on the card, ``ops/segment.py``)."""
    if mesh is not None and p["solver"] == "CG":
        return ShardedCGSolver(M, mesh)
    return get_solver(M, p["solver"])


def _make_optimizer(name_or_fn, params, lr):
    """The optimizer over ``params`` at step size ``lr``: ``"AdamUniform"``,
    ``"Adam"``, or a callable ``(params, lr) → torch.optim.Optimizer``.
    (The JAX driver's callable takes ``lr`` alone and returns an optax
    transformation; a torch optimizer needs its parameters when it is
    built.)"""
    if callable(name_or_fn):
        return name_or_fn(params, lr)
    if name_or_fn == "AdamUniform":
        return AdamUniform(params, lr=lr)
    if name_or_fn == "Adam":
        return Adam(params, lr=lr)
    raise ValueError(f"unknown optimizer {name_or_fn!r}")


def _build_epoch(v_src, f_src, p, renderer, device, setup):
    """The epoch of (v_src, f_src); ``setup`` gains the seconds of its
    topology (``topology_s``, span ``setup.topology``: duplicates,
    adjacency, Laplacian), its host bins (``host_bins_s``, ``setup.bins``)
    and its matrix and solver (``factor_s``: ``setup.matrix``, then the
    solver's ``setup.rcm`` and ``setup.factor``)."""
    with setup_span("setup.topology") as sp:
        v_unique, f_unique, duplicate_idx = remove_duplicates(v_src, f_src)
        st = _Epoch(v_unique=v_unique, f_unique=f_unique,
                    duplicate_idx=duplicate_idx,
                    f_src=np.asarray(f_src, np.int32),
                    topology=Topology(f_src))
        st.L = laplacian_uniform(len(v_unique), f_unique, device=device)
        _sync(device, "setup")
    setup["topology_s"] = sp.seconds
    with setup_span("setup.bins") as sp:
        if takes_bins(renderer, st.topology, p):
            st.bins = EpochBins(renderer, p, v_src, st.topology,
                                duplicate_idx)
            st.occupancy = st.bins.occupancy
        else:
            # size the bins before the first render: an overflowing bin
            # under-draws its tile with no signal (a no-op on the dense
            # backend)
            st.occupancy = renderer.check_overflow(v_src, st.topology)
        _sync(device, "setup")
    setup["host_bins_s"] = sp.seconds
    t0 = time.perf_counter()
    if p["smooth"]:
        with setup_span("setup.matrix"):
            st.M = compute_matrix(v_unique, f_unique, lambda_=p["lambda"],
                                  alpha=p["alpha"], device=device)
            st.u = to_differential(
                st.M, torch.as_tensor(v_unique, dtype=torch.float32,
                                      device=device))
        st.solver = _make_solver(st.M, p, renderer.mesh)  # once an epoch
    _sync(device, "setup")
    setup["factor_s"] = time.perf_counter() - t0
    return st



# why an epoch's steps run eagerly: prof["graph"]["eager"]'s keys
EAGER_REASONS = ("cpu", "sharded", "dense", "host_bins", "iterative_solver",
                 "host_solver", "banded_solver", "before_capture")


def _graph_stats():
    """A call's ``prof["graph"]``: captures, replays, each capture's host
    seconds, and the steps run eagerly by reason."""
    return {"captures": 0, "replays": 0, "capture_s": [],
            "eager": dict.fromkeys(EAGER_REASONS, 0)}


def _graph_reason(st, p, renderer, dev):
    """Why epoch ``st`` runs its steps eagerly, or None where one CUDA graph
    replays them: a mesh of ranks (its collectives); the dense renderer;
    host bins (their rebins read the displacement on the host); a solver
    that reads the host (CG, the V-cycle and AMG-PCG their residual, the
    host Cholesky its right-hand side); the banded tier, whose persistent
    sweep no test has yet run under a capture; else a run off the card.
    Only the dense inverse, or ``smooth`` off, replays."""
    if renderer.mesh is not None:
        return "sharded"
    if renderer.backend != "tiles":
        return "dense"
    if st.bins is not None:
        return "host_bins"
    tier = getattr(st.solver, "tier", None) if p["smooth"] else None
    if tier == "host":
        return "host_solver"
    if tier == "banded":
        return "banded_solver"
    if tier not in (None, "dense_inv"):
        return "iterative_solver"
    if dev.type != "cuda":
        return "cpu"
    return None


def _clear_blas_workspaces():
    """Drop the cuBLAS workspaces PyTorch keeps for each (handle, stream)
    pair a matrix product has run on.  Around a capture, so that the
    capture's products take theirs inside the graph's pool and the eager
    steps' are not held beside them (the step has two: its own thread's
    and autograd's).  A PyTorch without the hook warns, once: the graphed
    call's peak then holds both pairs."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        warnings.warn("torch._C._cuda_clearCublasWorkspaces is missing: the "
                      "step's CUDA graph keeps cuBLAS workspaces beside the "
                      "eager steps'", RuntimeWarning, stacklevel=2)
        return
    clear()


def _launch_counts():
    """The hand-written kernels' launch counters, as (table, name, count)."""
    return [(t, k, n) for t in (_kernels.LAUNCHES, _banded.LAUNCHES)
            for k, n in t.items()]


class _StepGraph:
    """The work of an epoch's step (solve → normals → render → loss →
    backward) as one CUDA graph.  :meth:`capture` records it from the
    step's ``work`` (on PyTorch's capture stream, in the graph's own memory
    pool, no span recorded inside), with the parameters' gradients unset,
    so that the graph makes them and writes them on every replay;
    :meth:`replay` runs it on the current stream (span ``step_graph``),
    first pointing each parameter's ``.grad`` back at the graph's tensor
    as the optimizer's ``zero_grad`` drops it, and adds the hand-written
    kernels' launches of one step to their counters (a capture launches
    nothing, so it leaves them as they were).
    ``out`` holds the graph's outputs: the logged (image loss, bilaplacian
    magnitude) and the solved vertices."""

    def __init__(self, params, stats):
        self.params, self.stats = params, stats
        self.graph = self.out = None
        self.grads = ()
        self.launches = []

    def capture(self, work):
        t0 = time.perf_counter()
        with _span("graph_capture"):
            _clear_blas_workspaces()
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            with _spans.capturing(), torch.cuda.graph(graph):
                logged, v_unique = work()[:2]
                out = (logged, v_unique.detach())
            _clear_blas_workspaces()
        self.launches = [(t, k, t[k] - n) for t, k, n in before if t[k] > n]
        for t, k, n in before:
            t[k] = n
        self.graph, self.out = graph, out
        self.grads = [q.grad for q in self.params]
        self.stats["captures"] += 1
        self.stats["capture_s"].append(time.perf_counter() - t0)

    def replay(self):
        for q, g in zip(self.params, self.grads):
            if g is not None and q.grad is not g:
                q.grad = g
        with _span("step_graph"):
            self.graph.replay()
        for t, k, n in self.launches:
            t[k] += n
        self.stats["replays"] += 1


def _make_step(st: _Epoch, p, renderer, ref_imgs, theta, optimizer, graph):
    """One optimizer step.  Returns device tensors: ((image loss, logged
    bilaplacian magnitude), the solved vertices of this step's forward, on
    the large-F path the largest screen displacement (px) of a rendered
    vertex since the bins were made (0 elsewhere), and an iterative
    solver's (forward, backward) iteration counts (None for a direct one)).
    The solves' warm starts begin at the epoch's source vertices and zero.
    On a mesh the image loss is the rank's share of the mean over every
    rank's pixels, and the one returned its sum over the ranks.  ``graph``
    is the call's ``prof["graph"]``: where :func:`_graph_reason` allows,
    the epoch's second step captures the step's work into a
    :class:`_StepGraph` and every step from it replays the graph."""
    dev = renderer.device
    mesh = renderer.mesh
    # the pixels of every rank's images (each rank holds an equal shard)
    n_pix = ref_imgs.numel() * (1 if mesh is None else mesh.size)
    dup = torch.as_tensor(st.duplicate_idx.astype(np.int64), device=dev)
    f_unique = torch.as_tensor(st.f_unique.astype(np.int64), device=dev)
    corners = corner_segments(f_unique, len(st.v_unique), dev)
    reg = float(p["reg"])
    l1 = p["loss"] == "l1"
    zero = torch.zeros((), device=dev)
    v0 = torch.as_tensor(st.v_unique, dtype=torch.float32, device=dev)
    guess = {"fwd": v0, "bwd": torch.zeros_like(v0)}

    def work():
        """The step up to its gradients: (logged, v_unique, v_render,
        iters)."""
        iters = None
        with _span("solve"):
            if p["smooth"]:
                v_unique = solve(st.solver, theta["u"], guess["fwd"],
                                 guess["bwd"])
                iters = getattr(st.solver, "iters", None)
            else:
                v_unique = theta["u"]
        with _span("normals"):
            fn = compute_face_normals(v_unique, f_unique, corners)
            n_opt = compute_vertex_normals(v_unique, f_unique, fn,
                                           corners)[dup]
        with _span("render"):
            tr = theta["tr"] if p["use_tr"] \
                else torch.zeros_like(theta["tr"])
            v_render = tr + v_unique[dup]
            imgs = renderer.render(v_render, n_opt, st.topology, bins=None
                                   if st.bins is None else st.bins.tensors)
        with _span("loss"):
            diff = imgs - ref_imgs
            err = diff.abs() if l1 else diff.square()
            im_loss = err.mean() if mesh is None else err.sum() / n_pix
            Lv = coo_matvec(st.L, v_unique)
            reg_loss = Lv.square().mean() if p["bilaplacian"] \
                else (v_unique * Lv).mean()
            loss = im_loss + reg * reg_loss
        with _span("backward"):
            loss.backward()
        # always log the bilaplacian magnitude, like reference main.py:200
        logged = (im_loss.detach(), Lv.detach().square().mean())
        return logged, v_unique, v_render, iters

    def update():
        with _span("optimizer"):
            if not p["use_tr"]:
                theta["tr"].grad = torch.zeros_like(theta["tr"])
            optimizer.step()

    def v_out(v_unique):
        # the coordinates themselves are optimized in place: keep this
        # step's copy
        return v_unique.detach() if p["smooth"] \
            else v_unique.detach().clone()

    def eager():
        optimizer.zero_grad(set_to_none=True)
        logged, v_unique, v_render, iters = work()
        if mesh is not None:
            # the image loss summed over the ranks; the logged magnitude,
            # replicated, their mean
            logged = tuple(pdist.all_reduce(torch.stack(
                [logged[0], logged[1] / mesh.size])))
        if iters is not None:
            iters = torch.stack([iters, st.solver.iters])
        if p["smooth"]:
            # the next step's warm starts: this step's solutions
            guess["fwd"] = v_unique.detach()
            guess["bwd"] = theta["u"].grad
        update()
        disp = zero if st.bins is None else st.bins.displacement(v_render)
        return logged, v_out(v_unique), disp, iters

    reason = _graph_reason(st, p, renderer, dev)
    sg = _StepGraph([theta["tr"], theta["u"]], graph)
    warm = False                # the epoch's eager step before the capture

    def step():
        nonlocal warm
        if reason is not None or not warm:
            graph["eager"][reason or "before_capture"] += 1
            warm = True
            return eager()
        optimizer.zero_grad(set_to_none=True)
        if sg.graph is None:
            sg.capture(work)
        sg.replay()
        update()
        logged, v_unique = sg.out
        return logged, v_out(v_unique if p["smooth"] else theta["u"]), \
            zero, None

    return step


def _solved(st, theta, p):
    with torch.no_grad():
        return solve(st.solver, theta["u"]) if p["smooth"] \
            else theta["u"].detach()


def _fresh_theta(st, p, dev, tr=None):
    """The parameters at the start of an epoch: u of the epoch's source
    mesh (its coordinates when not ``smooth``) and the translation ``tr``
    (zero when None), as leaf tensors."""
    u0 = st.u if p["smooth"] else torch.as_tensor(
        st.v_unique, dtype=torch.float32, device=dev)
    if tr is None:
        tr = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    return {"u": u0.detach().clone().requires_grad_(True),
            "tr": tr.detach().clone().requires_grad_(True)}


def _solver_info(st):
    """The epoch's solver tier; for the banded tier its block and blocks,
    for the AMG tiers the hierarchy's rows a level, blocks a level and
    bytes (:func:`core.multigrid.describe`)."""
    if st.solver is None:
        return None
    slv = st.solver
    big = getattr(slv, "_big", None)
    banded = isinstance(big, BandedSolver)
    info = {"tier": st.solver.tier, "block": big.B if banded else None,
            "blocks": big.nb if banded else None}
    if info["tier"] == "amg":
        info.update(describe(slv.h))
    elif info["tier"] == "blockamg":
        info.update(describe(big._mg.h))
    return info


def _pipe(renderer, st):
    """Which render path the epoch takes: ``dense``, ``traced`` (tile
    bins made each step) or, on precomputed bins, ``batched`` or
    ``camera_sequential``."""
    if renderer.backend == "dense":
        return "dense"
    if st.bins is None:
        return "traced"
    return "camera_sequential" if renderer.camera_sequential(
        st.bin_cap(renderer), st.topology.n_faces) else "batched"


def _remesh_schedule(p, resume, start_it):
    """(the step of the next remesh or -1, the steps of the later ones).
    A resumed run takes the checkpoint's pending schedule; a remesh at
    ``start_it`` is replayed, since checkpoints are written before the
    remesh of their step."""
    if resume is not None:
        sched = [int(r) for r in resume["meta"]["remesh_schedule"]
                 if r >= start_it]
    elif isinstance(p["remesh"], (list, tuple)):
        sched = [int(r) for r in p["remesh"]]
    else:
        sched = [int(p["remesh"])] if int(p["remesh"]) >= 0 else []
    return (sched.pop(0) if sched else -1), sched


def _remesh(st, theta, p, it):
    """Remesh the solved vertices of epoch ``st`` on the host to half their
    mean edge length.  Returns (v_src float32, f_src int32, the event's
    record)."""
    v_unique = _solved(st, theta, p).cpu().numpy()
    h = 0.5 * float(average_edge_length(torch.as_tensor(v_unique),
                                        st.f_unique))
    native_remesh._load()       # a first use builds the library: untimed
    with setup_span("remesh") as sp:
        v_new, f_new = native_remesh.remesh_botsch(
            v_unique.astype(np.float64), st.f_unique.astype(np.int32), 5, h,
            True)
    event = {"it": it, "h": h, "remesh_s": sp.seconds,
             "verts_before": int(len(v_unique)),
             "faces_before": int(len(st.f_unique)),
             "verts_after": int(len(v_new)), "faces_after": int(len(f_new)),
             "mean_edge_after": float(average_edge_length(
                 torch.as_tensor(v_new), f_new))}
    return v_new.astype(np.float32), f_new.astype(np.int32), event


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
    setup: dict                 # seconds of the setup's parts
    mesh: Any = None            # the run's (dp, sp) mesh of ranks, or None
    graph: Any = None           # prof["graph"] (:func:`_graph_stats`)


def _prepare(scene, p, dev) -> _Run:
    """Reference images, the first epoch, theta and the optimizer (or their
    state from ``p["resume"]``), and the step function."""
    v_src = np.asarray(scene["mesh-source"]["vertices"], np.float32)
    f_src = np.asarray(scene["mesh-source"]["faces"], np.int32)
    resume = load_checkpoint(p["resume"]) if p["resume"] else None
    if resume is not None:
        v_src = resume["v_src"].astype(np.float32)
        f_src = resume["f_src"].astype(np.int32)
    mesh = _make_mesh(p)

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
                            chunk=p["raster_chunk"], device=dev)
        if mesh is not None:
            shard_renderer(renderer, mesh)
        ref_topo = Topology(f_ref)
        with setup_span("setup.reference") as sp:
            if takes_bins(renderer, ref_topo, p):
                ref_bins = host_bins(renderer, v_ref.cpu().numpy(),
                                     ref_topo, 0.0)[0]
                ref_imgs = renderer.render(v_ref, n_ref, ref_topo,
                                           bins=ref_bins)
                del ref_bins
            else:
                renderer.check_overflow(v_ref, ref_topo)
                ref_imgs = renderer.render(v_ref, n_ref, ref_topo)
            _sync(dev, "setup")
        setup = {"ref_render_s": sp.seconds}

    st = _build_epoch(v_src, f_src, p, renderer, dev, setup)
    step_size = float(p["step_size"])
    if resume is not None:
        step_size = float(resume["meta"]["step_size"])
        theta, load_moments = state_from_numpy(resume["theta"],
                                               resume["opt_state"], dev)
    else:
        theta = _fresh_theta(st, p, dev)
    optimizer = _make_optimizer(p["optimizer"], [theta["tr"], theta["u"]],
                                step_size)
    if resume is not None:
        load_moments(optimizer)
        if st.bins is not None:
            st.bins.resume(_solved(st, theta, p), theta["tr"])
    graph = _graph_stats()
    step = _make_step(st, p, renderer, ref_imgs, theta, optimizer, graph)
    return _Run(st=st, renderer=renderer, ref_imgs=ref_imgs,
                v_ref=v_ref, f_ref=f_ref, v_src=v_src, f_src=f_src,
                theta=theta, optimizer=optimizer, step=step,
                step_size=step_size, resume=resume, setup=setup, mesh=mesh,
                graph=graph)


def optimize_shape(scene, params=None, device=None):
    """Run the shape optimization on ``device`` (CUDA unless the caller
    asks for the CPU).  ``scene`` is a scene-params dict
    (:func:`largesteps_torch.io.synth.make_scene`) or the path of a scene
    XML file (:func:`largesteps_torch.io.xml_scene.load_scene`).  Returns
    the JAX driver's result dict: losses (steps, 2) = (image loss,
    bilaplacian magnitude), v_final, f_final, f (the faces of every
    epoch), tr, iters, wall_time, prof and the reference images and mesh.
    ``prof["remeshes"]`` holds one record a remesh: its step, h, the mesh
    before and after, the remesher's host seconds, the new epoch's setup
    split, solver, bins and cap, and where it fell in the wall time.  With
    ``params["sharding"]`` every rank of the process group calls this with
    the same arguments and gets the same result (``im_ref`` the whole
    reference images); ``prof["sharding"]`` holds the mesh and the rank's
    layout.  ``prof["graph"]`` counts the CUDA graph's captures and
    replays and the steps run eagerly, by reason (:func:`_graph_stats`).
    With ``params["trace"]``, or while a ``torch.profiler`` runs,
    ``prof["trace"]`` holds the call's spans and host waits
    (:meth:`largesteps_torch.spans.Recorder.export`)."""
    dev = resolve_device(device)
    p = default_params()
    if params:
        p.update(params)
    rec = Recorder(dev, always=p["trace"])
    with _spans.recording(rec):
        result = _optimize(scene, p, dev, rec)
    if rec.used:
        result["prof"]["trace"] = rec.export()
    return result


def _optimize(scene, p, dev, rec):
    """The body of :func:`optimize_shape`, with ``rec`` active."""
    t_setup0 = time.perf_counter()
    if isinstance(scene, (str, os.PathLike)):
        scene = load_scene(os.fspath(scene))
    with setup_span("setup"):
        run = _prepare(scene, p, dev)
    st, theta, optimizer, step = run.st, run.theta, run.optimizer, run.step
    renderer, ref_imgs = run.renderer, run.ref_imgs
    v_src, f_src, resume = run.v_src, run.f_src, run.resume
    step_size = run.step_size
    mesh = run.mesh

    steps = int(p["steps"])
    opt_time = float(p["time"]) * 60.0
    if float(p["time"]) > 0:
        steps = -1
    start_it = int(resume["meta"]["step"]) if resume is not None else 0
    remesh_it, remesh_schedule = _remesh_schedule(p, resume, start_it)

    im_ref = ref_imgs.cpu().numpy() if mesh is None \
        else gather_images(ref_imgs, renderer)
    result = {"vert_steps": [], "tr_steps": [], "f": [f_src.copy()],
              "losses": [], "im_ref": im_ref,
              "v_ref": run.v_ref.cpu().numpy(), "f_ref": run.f_ref.copy()}
    prof = {"first_step_s": 0.0, **rebin_record(),
            "setup_s": time.perf_counter() - t_setup0, **run.setup,
            "remeshes": [], "graph": run.graph}
    if mesh is not None:
        prof["sharding"] = {"dp": mesh.dp, "sp": mesh.sp,
                            "rank": mesh.rank, "backend": mesh.backend,
                            "row_shards": renderer.row_shards,
                            "views": [renderer.cam_slice.start,
                                      renderer.cam_slice.stop],
                            "rows": [renderer.row_slice.start,
                                     renderer.row_slice.stop]}
    del run                     # the epoch is held by the names above only

    def checkpoint(it):
        pending = ([remesh_it] if remesh_it > 0 else []) + remesh_schedule
        save = save_checkpoint if mesh is None \
            else pdist.save_checkpoint_multihost
        with _span("host_wait", "checkpoint"):
            save(p["checkpoint_path"], theta=theta, optimizer=optimizer,
                 v_src=v_src, f_src=f_src, step=it, step_size=step_size,
                 remesh_schedule=pending)
        _spans.waited()

    it = start_it
    v_last = None               # solved vertices of the last step
    loss_log = []
    iter_log = []               # an iterative solver's counts a step
    t0 = time.perf_counter()
    t = t0

    def going():
        if steps > 0:
            return it < steps
        # a time budget: on a mesh every rank stops at the first rank's end
        over = (t - t0) >= opt_time
        return not (over if mesh is None else pdist.host_max([over], mesh)[0])

    while going():
        rec.step = it
        if p["checkpoint_every"] and p["checkpoint_path"] and it > start_it \
                and it % p["checkpoint_every"] == 0:
            checkpoint(it)
        if it == remesh_it:
            _sync(dev, "remesh")  # every queued step of the old epoch ran
            t_rm = time.perf_counter()
            with setup_span("setup"):
                v_src, f_src, event = _remesh(st, theta, p, it)
                tr = theta["tr"].detach().clone()
                event["allocated_before"] = _allocated(dev)
                # free the old epoch before building the new one: its bins
                # and their queues, pipes (Topology), solver factor, the
                # step's closure and CUDA graph and the optimizer's moments
                st = theta = optimizer = step = v_last = None
                losses = None       # on the graph path, the graph's outputs
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                event["allocated_after"] = _allocated(dev)
                setup = {}
                st = _build_epoch(v_src, f_src, p, renderer, dev, setup)
                result["f"].append(f_src.copy())
                step_size *= 0.8
                theta = _fresh_theta(st, p, dev, tr)
                optimizer = _make_optimizer(
                    p["optimizer"], [theta["tr"], theta["u"]], step_size)
                step = _make_step(st, p, renderer, ref_imgs, theta,
                                  optimizer, prof["graph"])
            event.update(
                setup=setup, solver=_solver_info(st),
                use_host_bins=st.bins is not None, occupancy=st.occupancy,
                bin_cap=st.bin_cap(renderer), pipe=_pipe(renderer, st),
                step_size=step_size, wall_at=t_rm - t0,
                seconds=time.perf_counter() - t_rm)
            prof["remeshes"].append(event)
            remesh_it = remesh_schedule.pop(0) if remesh_schedule else -1
        if st.bins is not None:
            st.bins.before(it, v_last, theta["tr"], prof)
        t_st = time.perf_counter()
        with _span("step"):
            losses, v_last, disp, iters = step()
        if st.bins is not None:
            st.bins.after(it, disp)
        if it == start_it:
            _sync(dev, "first_step")
            prof["first_step_s"] = time.perf_counter() - t_st
        loss_log.append(torch.stack(losses))
        if iters is not None:
            iter_log.append(iters)
        if p["nan_check_every"] and (it + 1) % int(p["nan_check_every"]) == 0:
            # both scalars: NaN vertices render as background, leaving the
            # image loss finite while the bilaplacian magnitude goes NaN
            with _span("host_wait", "nan_check"):
                finite = bool(torch.isfinite(loss_log[-1]).all())
            _spans.waited()
            if not finite:
                warnings.warn(f"non-finite loss/reg at iteration {it}; "
                              f"aborting optimization (diverged)")
                result["diverged"] = True
                it += 1
                break
        if p["record_verts"]:
            with _span("host_wait", "record_verts"):
                result["vert_steps"].append(
                    v_last.cpu().numpy()[st.duplicate_idx])
                result["tr_steps"].append(theta["tr"].detach().cpu().numpy())
            _spans.waited()
        it += 1
        if steps < 0:
            _sync(dev, "time_budget")  # a budget counts executed seconds
        t = time.perf_counter()
    rec.step = None
    _sync(dev, "end")
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
    prof["max_window_disp_px"] = getattr(st.bins, "max_window_disp", 0.0)
    prof["bin_cap"] = st.bin_cap(renderer)
    prof["backend"] = renderer.backend
    prof["raster_chunk"] = renderer.chunk
    if st.solver is not None:
        prof["solver"] = _solver_info(st)
    if iter_log:
        prof["solve_iters"] = torch.stack(iter_log).cpu().numpy()
    result["prof"] = prof
    return result
