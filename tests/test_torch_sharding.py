"""The port's sharded paths on the CPU: ranks of ``torch.distributed`` over
gloo, against the same work on one rank.

This file imports neither jax nor largesteps_tpu: its rank bodies run in
processes started with ``spawn``, which import this module again, and
``tests/test_torch_sharding_jax.py`` takes them from here.  Every launch
joins its ranks within a time limit (``parallel.distributed.launch``) and
fails with their standard error.  Four ranks at most, one torch thread
each; tiny meshes and the smallest tilings (64 × 128: two tile rows;
128 × 128: four).

* ``ranks``: one launch of 4 ranks runs every check below that needs no
  driver: the halo swaps at sp = 2 and 4 (against ``_shift_up`` and
  ``_shift_down_ch`` of the whole image), the row-sharded pipes (traced,
  prebinned, camera-sequential; shaded and silhouette) forward and
  backward at sp = 2 and 4, the renderer's layouts (row shards, the
  fallback, the dense renderer, cameras that do not divide), a sharded
  render against the unsharded one, the sharded matvec, CG and vertex
  gather, and ``replicate_global``; then the driver at (64, 128) (row
  shards) writing a checkpoint, at (32, 32) (the dense renderer) with a
  remesh, on host bins with device rebins, and with cameras alone on 4
  ranks under ``"Cholesky"`` (solutions broadcast from rank 0).  The
  one-rank references run in this process meanwhile.
* ``resumed``: 2 ranks resume the checkpoint at another world size.

Tolerances: halo rows, ids and the row-sharded images exact or 1e-5
absolute (the same kernels on the same rows); gradients 1e-4 × max|g|
(sums over the ranks in another order); matvec and vertex gather 1e-5 ×
max; CG 1e-5 absolute with the iterations equal to ``cg_solve``'s; driver
losses rtol 1e-4 and final vertices 1e-4 absolute against one rank (the
image loss is summed over the ranks in another order, and AdamUniform's
global scaling carries that into the steps), the final vertices equal on
every rank, the rebins on the same steps.
"""
import numpy as np
import pytest
import torch

from largesteps_torch.driver import optimize_shape
from largesteps_torch.io.synth import make_scene
from largesteps_torch.parallel import distributed as pdist
from largesteps_torch.parallel.distributed import RankFailed, launch

TIMEOUT = 240.0                 # seconds a launch's ranks may take
DRIVER = {"steps": 2, "step_size": 0.05, "lambda": 9.0, "boost": 3,
          "solver": "CG"}
HOST_BINS = {"host_bin_faces": 1, "rebin_every": 0, "rebin_auto": True,
             "rebin_margin": 0.5}
PIPES = [("traced", 2, True), ("traced", 4, True), ("traced", 2, False),
         ("batched", 2, True), ("batched", 4, True), ("big", 2, True),
         ("big", 4, True)]


def make(res, n_views=8, level=2):
    """The scene of ``tests/test_sharding.py:_driver_run`` at ``res``."""
    s = make_scene(source=("icosphere", level), target=("gourd", 2),
                   n_views=n_views, res=32)
    s["res_y"], s["res_x"] = res
    return s


# ---------------------------------------------------------------------------
# rank bodies (top-level: the spawned ranks import them)
# ---------------------------------------------------------------------------

def driver_rank(rank, world, runs):
    """``optimize_shape`` on this rank for each (name, scene, params,
    camera_sequential) of ``runs``: {name: summary}.  camera_sequential
    sends prebinned renders to the camera-sequential pipe."""
    import largesteps_torch.render.renderer as rmod
    out = {}
    for name, scene, params, seq in runs:
        rmod.BATCHED_SHARE = 0.0 if seq else 0.25
        out[name] = summary(optimize_shape(scene, params, device="cpu"))
    return out


def summary(r):
    return {"losses": r["losses"], "v_final": r["v_final"],
            "f": [np.asarray(f) for f in r["f"]], "im_ref": r["im_ref"],
            "rebin_steps": r["prof"].get("rebin_steps", []),
            "sharding": r["prof"].get("sharding"), "iters": r["iters"]}


def pipe_case(kind, sp, shading):
    """Inputs of a pipe check: 2 views of icosphere-3, at 64 × 128 for
    sp = 2 and 128 × 128 for sp = 4; seeded attributes, background and
    output cotangent; whole-image host bins for the prebinned pipes."""
    from largesteps_torch.render.antialias import face_adjacency
    from largesteps_torch.render.camera import project
    from largesteps_torch.render.pipeline import bin_triangles_host
    from largesteps_torch.render.renderer import Renderer
    res = (64, 128) if sp == 2 else (128, 128)
    s = make(res, n_views=2, level=3)
    r = Renderer(s, device="cpu")
    v = torch.as_tensor(s["mesh-source"]["vertices"])
    f = np.asarray(s["mesh-source"]["faces"])
    rng = np.random.default_rng(sp)
    D = 4 if shading else 3
    case = {"res": res, "faces": f, "opp": face_adjacency(f),
            "v_clip": project(v, r.mvps).numpy(),
            "attrs": rng.normal(size=(v.shape[0], 3)).astype(np.float32),
            "bg": rng.uniform(size=(2, *res, 4)).astype(np.float32)
            if shading else None,
            "g": rng.normal(size=(2, *res, D)).astype(np.float32),
            "cap": 256, "bins": ()}
    if kind != "traced":
        bins, counts, _ = bin_triangles_host(case["v_clip"], f, res,
                                             margin=1.0)
        case["bins"] = (bins.astype(np.int64), counts)
        case["cap"] = bins.shape[-1]
    return case


def run_pipe(case, kind, shading, mesh=None, cams=slice(None),
             rows=slice(None)):
    """One forward and backward of the pipe (row shard ``mesh.sp_index``
    of ``mesh.sp`` with a mesh): (images, d v_clip, d attrs) as numpy."""
    from largesteps_torch.render.pipeline import (RenderPipeline,
                                                  RenderPipelineBig)
    if kind == "big":
        pipe = RenderPipelineBig(case["faces"], case["opp"], case["res"],
                                 shading=shading, boost=3.0, cap=case["cap"],
                                 mesh=mesh)
    else:
        pipe = RenderPipeline(case["faces"], case["opp"], case["res"],
                              shading=shading, boost=3.0, cap=case["cap"],
                              prebinned=kind != "traced", mesh=mesh)
    v = torch.tensor(case["v_clip"][cams], requires_grad=True)
    a = torch.tensor(case["attrs"], requires_grad=True)
    bg = None if case["bg"] is None else torch.tensor(case["bg"][cams, rows])
    bins = [torch.as_tensor(b[cams]) for b in case["bins"]]
    out = pipe(v, a, bg, *bins)
    (out * torch.as_tensor(case["g"][cams, rows])).sum().backward()
    return out.detach().numpy(), v.grad.numpy(), a.grad.numpy()


def _halo_check(sp):
    """This rank's rows of ``_shift_up`` and ``_shift_down_ch`` of a seeded
    (2, 128, 128, 4) image, through the halo swaps."""
    from largesteps_torch.render import kernels as K
    mesh = pdist.global_mesh(sp)
    full = torch.as_tensor(np.random.default_rng(7).normal(
        size=(2, 128, 128, 4)).astype(np.float32))
    h = 128 // sp
    rows = slice(mesh.sp_index * h, (mesh.sp_index + 1) * h)
    local = full[:, rows]
    nxt = pdist.from_next_row_shard(local[:, 0].contiguous(), mesh)
    up = K._shift_up(local, None if nxt is None else nxt)
    prev = pdist.to_next_row_shard(local[:, -1].contiguous(), mesh)
    down = torch.cat([prev[:, None], local[:, :-1]], dim=1)
    return {"up": (up - K._shift_up(full)[:, rows]).abs().max().item(),
            "down": (down - K._shift_down_ch(full)[:, rows]).abs().max()
            .item(), "last": nxt is None}


def _pipe_check(kind, sp, shading):
    mesh = pdist.global_mesh(sp)
    case = pipe_case(kind, sp, shading)
    per = 2 // mesh.dp
    cams = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    h = case["res"][0] // sp
    rows = slice(mesh.sp_index * h, (mesh.sp_index + 1) * h)
    return {"cams": cams, "rows": rows,
            "out": run_pipe(case, kind, shading, mesh, cams, rows)}


def _layout_check():
    """Which cameras and rows each layout gives this rank, and that
    cameras that do not divide raise."""
    from largesteps_torch.parallel.sharding import make_mesh, shard_renderer
    from largesteps_torch.render.renderer import Renderer
    mesh = make_mesh(2, 2)
    out = {}
    for name, res, n in (("rows", (64, 128), 8), ("fallback", (32, 128), 8),
                         ("dense", (32, 32), 8), ("indivisible", (32, 128),
                                                  6)):
        r = Renderer(make(res, n_views=n), device="cpu")
        try:
            shard_renderer(r, mesh)
        except ValueError as e:
            out[name] = str(e)
            continue
        out[name] = (r.row_shards, r.cam_slice, r.row_slice,
                     tuple(r.mvps.shape), tuple(r.bgs.shape))
    return out


def _render_check():
    """A renderer at (64, 128) sharded dp = 2 × sp = 2: the whole images
    and the gradients of v and n (summed over the ranks)."""
    from largesteps_torch.parallel.sharding import (gather_images,
                                                    make_mesh,
                                                    shard_renderer)
    from largesteps_torch.render.renderer import Renderer
    s = make((64, 128), n_views=4, level=3)
    r = shard_renderer(Renderer(s, boost=3.0, device="cpu"),
                       make_mesh(2, 2))
    img, gv, gn = render_grads(r, s)
    return {"img": gather_images(img, r), "gv": gv, "gn": gn}


def render_grads(r, s):
    """Images of the source mesh and the gradients of a seeded weighting
    of them with respect to v and n."""
    from largesteps_torch.ops.normals import (compute_face_normals,
                                              compute_vertex_normals)
    from largesteps_torch.render.renderer import Topology
    f = s["mesh-source"]["faces"]
    v = torch.tensor(s["mesh-source"]["vertices"], requires_grad=True)
    with torch.no_grad():
        n0 = compute_vertex_normals(v, f, compute_face_normals(v, f))
    n = n0.clone().requires_grad_(True)
    topo = Topology(f)
    r.check_overflow(v.detach(), topo)
    img = r.render(v, n, topo)
    w = np.random.default_rng(3).normal(size=(4, 64, 128, 4))
    if r.mesh is not None:
        w = w[r.cam_slice, r.row_slice]
    (img * torch.as_tensor(w.astype(np.float32))).sum().backward()
    return img.detach(), v.grad.numpy(), n.grad.numpy()


def tri_system():
    from largesteps_torch.core.geometry import compute_matrix
    from largesteps_torch.core.parameterize import to_differential
    from largesteps_torch.ops.shapes import icosphere
    v, f = icosphere(3)
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    return M, to_differential(M, torch.as_tensor(v)), f


def vertex_table(f, n_verts):
    """A seeded corner-major (2, F·3 + 3, 5) table and the incidence."""
    from largesteps_torch.render.pipeline import build_incidence
    rng = np.random.default_rng(11)
    table = rng.normal(size=(2, 3 * len(f) + 3, 5)).astype(np.float32)
    table[:, -1] = 0.0
    return torch.as_tensor(table), build_incidence(f, n_verts)


def tri_rank(rank, world):
    """The sharded matvec, CG (and its iterations, through the solver) and
    vertex gather of this rank, on icosphere-3 (λ = 19)."""
    from largesteps_torch.parallel.tri_shard import (
        ShardedCGSolver, sharded_cg_solve, sharded_coo_matvec,
        sharded_vertex_gather)
    mesh = pdist.global_mesh(2)
    M, u, f = tri_system()
    slv = ShardedCGSolver(M, mesh, tol=1e-6)
    x = slv.solve(u)
    table, inc = vertex_table(f, u.shape[0])
    return {"matvec": sharded_coo_matvec(M, u, mesh).numpy(),
            "cg": sharded_cg_solve(M, u, mesh, tol=1e-6).numpy(),
            "solver": x.numpy(), "iters": int(slv.iters),
            "gather": sharded_vertex_gather(table, inc, mesh).numpy()}


def suite_rank(rank, world, runs=()):
    """Every check of the ``ranks`` fixture, then the driver runs of
    ``runs`` (as :func:`driver_rank`'s, each under its name); a check that
    raises gives its traceback instead of its result."""
    import traceback
    checks = {f"halo_sp{sp}": (lambda sp=sp: _halo_check(sp))
              for sp in (2, 4)}
    for kind, sp, shading in PIPES:
        checks[f"pipe_{kind}_sp{sp}_{int(shading)}"] = \
            (lambda a=(kind, sp, shading): _pipe_check(*a))
    checks["layout"] = _layout_check
    checks["render"] = _render_check
    checks["tri"] = lambda: tri_rank(rank, world)
    checks["replicate"] = lambda: (
        pdist.process_index(), pdist.process_count(), pdist.is_coordinator(),
        pdist.replicate_global({"t": torch.full((3,), float(rank)),
                                "a": [np.full(2, rank), "kept"]}))
    for run in runs:
        checks[run[0]] = lambda run=run: driver_rank(rank, world,
                                                     [run])[run[0]]
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


def layout_gather_rank(rank, world, n_cams, res, sp):
    """This rank's block of the ``(world / sp, sp)`` mesh under the tile
    layout with row shards (``shard_layout``: JAX's ``camera_sharding``
    with cameras on dp and rows on sp), and whether ``gather_images`` of
    that block of a known (C, H, W, 2) array gives the whole array back
    (JAX's ``host_local_to_global``)."""
    import types
    from largesteps_torch.parallel.sharding import (gather_images,
                                                    make_mesh, shard_layout)
    mesh = make_mesh(sp=sp)
    rs, cams, rows = shard_layout(n_cams, res, "tiles", mesh)
    full = np.arange(n_cams * res[0] * res[1] * 2, dtype=np.float32) \
        .reshape(n_cams, res[0], res[1], 2)
    got = gather_images(torch.as_tensor(full[cams, rows]),
                        types.SimpleNamespace(mesh=mesh, row_shards=rs))
    return {"cams": (cams.start, cams.stop), "rows": (rows.start, rows.stop),
            "row_shards": rs, "whole": bool(np.array_equal(got, full))}


def parity_rank(rank, world, runs):
    """The port's side of ``tests/test_torch_sharding_jax.py`` in one
    launch: the driver runs of ``runs`` and the sharded matvec, CG and
    vertex gather."""
    return {"drivers": driver_rank(rank, world, runs),
            "tri": tri_rank(rank, world)}


def launch_meanwhile(fn, world, args, work):
    """(``launch(fn, world, args=args)``'s results, ``work()``): the ranks
    run while ``work`` runs in this process."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, fn, world, args=args, timeout=TIMEOUT)
        here = work()
        return ranks.result(), here


def fail_rank(rank, world, how):
    """A rank that raises (rank 1) or hangs in a collective (rank 0)."""
    import time
    if how == "raise" and rank == 1:
        raise ValueError("rank 1 gives up")
    if how == "hang" and rank == 0:
        pdist.all_reduce(torch.zeros(1))     # rank 1 never joins
    time.sleep(60)
    return rank


# ---------------------------------------------------------------------------
# fixtures: one launch each
# ---------------------------------------------------------------------------

def _result(ranks, name):
    got = [r[name] for r in ranks]
    for g in got:
        if isinstance(g, str) and "Traceback" in g:
            pytest.fail(g)
    return got


DRIVER_RUNS = {
    "rows": ((64, 128), {"dp": 2, "sp": 2}, {}),
    "dense_remesh": ((32, 32), {"dp": 2, "sp": 2},
                     {"steps": 4, "remesh": [2]}),
    "rebins": ((64, 128), {"dp": 2, "sp": 2}, {"steps": 4, **HOST_BINS}),
    "dp_cholesky": ((64, 128), {"dp": 4}, {"solver": "Cholesky"}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module, as each rank has: the one-rank
    references' reductions then add in the ranks' order (AdamUniform's
    global scaling would carry another order's ulps into the steps), and
    beside the suite's other test processes many small operations do not
    crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shard_ck") / "ck.npz")


@pytest.fixture(scope="module")
def ranks(ckpt):
    """The checks and the driver runs of 4 ranks, and the drivers' one-rank
    references."""
    runs = []
    for name, (res, sh, extra) in DRIVER_RUNS.items():
        p = {**DRIVER, "sharding": sh, **extra}
        if name == "rows":
            p.update(checkpoint_every=2, checkpoint_path=ckpt)
        runs.append((name, make(res), p, False))
    return launch_meanwhile(suite_rank, 4, (runs,), lambda: {
        name: summary(optimize_shape(make(res), {**DRIVER, **extra},
                                     device="cpu"))
        for name, (res, _, extra) in DRIVER_RUNS.items()})


@pytest.fixture(scope="module")
def suite(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def drivers(ranks):
    return ranks


@pytest.fixture(scope="module")
def resumed(drivers, ckpt):
    """The 4-rank (64, 128) run's checkpoint after 2 steps, resumed for 2
    more on 2 ranks (sp = 2) and on one."""
    p = {**DRIVER, "steps": 4, "resume": ckpt}
    two, one = launch_meanwhile(driver_rank, 2, (
        [("resume", make((64, 128)), {**p, "sharding": {"dp": 1, "sp": 2}},
          False)],), lambda: summary(optimize_shape(make((64, 128)), p,
                                                     device="cpu")))
    return [t["resume"] for t in two], one


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
def test_halo_swaps(suite, sp):
    """The next shard's first row (edge-replicated on the last shard) and
    the previous shard's last row (zeros on the first) are the whole
    image's shifts."""
    got = _result(suite, f"halo_sp{sp}")
    mesh_rows = [r % sp for r in range(4)]
    for g, s in zip(got, mesh_rows):
        assert g["up"] == 0.0 and g["down"] == 0.0
        assert g["last"] == (s == sp - 1)


@pytest.mark.parametrize("kind,sp,shading", PIPES)
def test_row_sharded_pipe(suite, kind, sp, shading):
    """Each rank's rows of the images equal the unsharded pipe's; every
    rank of a mesh row holds the whole gradient of v of its cameras (the
    pipe completes the per-face sums over the row), and the gradients of
    the attributes of one rank a mesh row (its cameras' share) sum to the
    unsharded pipe's.  At two shards the gradient of v is the unsharded
    pipe's bits (the halves of each face's sums are added as there)."""
    got = _result(suite, f"pipe_{kind}_sp{sp}_{int(shading)}")
    case = pipe_case(kind, sp, shading)
    out, dv, da = run_pipe(case, kind, shading)
    da_sum = np.zeros_like(da)
    for rank, g in enumerate(got):
        o, v, a = g["out"]
        np.testing.assert_allclose(o, out[g["cams"], g["rows"]], atol=1e-5)
        np.testing.assert_allclose(v, dv[g["cams"]],
                                   atol=1e-4 * np.abs(dv).max())
        if sp == 2:
            np.testing.assert_array_equal(v, dv[g["cams"]])
        if rank % sp == 0:
            da_sum += a
    np.testing.assert_allclose(da_sum, da, atol=1e-4 * np.abs(da).max())


@pytest.mark.parametrize("layout", ["rows", "fallback", "dense",
                                    "indivisible"])
def test_camera_layouts(suite, layout):
    """Row shards put cameras on dp and tile rows on sp; where the tile
    rows cannot split (one at 32 × 128) or the renderer is dense, cameras
    go over all dp · sp ranks; cameras that do not divide raise."""
    got = [g[layout] for g in _result(suite, "layout")]
    if layout == "indivisible":
        assert all("must divide" in g for g in got)
        return
    for rank, (rs, cams, rows, mvps, bgs) in enumerate(got):
        d, s = divmod(rank, 2)
        if layout == "rows":
            assert (rs, cams, rows) == (2, slice(4 * d, 4 * d + 4),
                                        slice(32 * s, 32 * s + 32))
            assert mvps == (4, 4, 4) and bgs == (4, 32, 128, 4)
        else:
            h = 32
            assert (rs, cams, rows) == (1, slice(2 * rank, 2 * rank + 2),
                                        slice(0, h))
            assert mvps[0] == 2 and bgs[:2] == (2, h)


def test_sharded_render_matches_unsharded(suite):
    """A dp = 2 × sp = 2 render, gathered, is the unsharded render; the
    gradients of v and n are the same on every rank and equal the
    unsharded ones."""
    from largesteps_torch.render.renderer import Renderer
    got = _result(suite, "render")
    s = make((64, 128), n_views=4, level=3)
    img, gv, gn = render_grads(Renderer(s, boost=3.0, device="cpu"), s)
    for g in got:
        np.testing.assert_allclose(g["img"], img.numpy(), atol=1e-5)
        np.testing.assert_array_equal(g["gv"], got[0]["gv"])
        np.testing.assert_array_equal(g["gn"], got[0]["gn"])
        np.testing.assert_allclose(g["gv"], gv, atol=1e-4 * np.abs(gv).max())
        np.testing.assert_allclose(g["gn"], gn, atol=1e-4 * np.abs(gn).max())


@pytest.mark.parametrize("op", ["matvec", "cg", "gather"])
def test_tri_shard(suite, op):
    """The edge-sharded matvec and CG and the vertex-sharded gather against
    their replicated versions, the same bits on every rank; CG takes
    ``cg_solve``'s iterations."""
    from largesteps_torch.core.solvers import ConjugateGradientSolver
    from largesteps_torch.core.sparse import coo_matvec
    got = _result(suite, "tri")
    M, u, f = tri_system()
    for g in got:
        np.testing.assert_array_equal(g[op], got[0][op])
    if op == "matvec":
        want = coo_matvec(M, u).numpy()
        np.testing.assert_allclose(got[0][op], want,
                                   atol=1e-5 * np.abs(want).max())
    elif op == "cg":
        ref = ConjugateGradientSolver(M, tol=1e-6)
        want = ref.solve(u).numpy()
        np.testing.assert_allclose(got[0]["cg"], want, atol=1e-5)
        np.testing.assert_allclose(got[0]["solver"], want, atol=1e-5)
        assert got[0]["iters"] == int(ref.iters)
    else:
        table, (idx, mask) = vertex_table(f, u.shape[0])
        want = (table[:, torch.as_tensor(idx).reshape(-1)]
                .reshape(2, *idx.shape, 5)
                * torch.as_tensor(mask, dtype=torch.float32)[None, :, :,
                                                              None]
                ).sum(2).numpy()
        np.testing.assert_allclose(got[0][op], want,
                                   atol=1e-5 * np.abs(want).max())


def test_replicate_global(suite):
    """Rank 0's tensors and arrays reach every rank; each rank knows its
    index, the count and the coordinator."""
    for rank, (idx, count, coord, tree) in enumerate(
            _result(suite, "replicate")):
        assert (idx, count, coord) == (rank, 4, rank == 0)
        np.testing.assert_array_equal(tree["t"].numpy(), np.zeros(3))
        np.testing.assert_array_equal(tree["a"][0], np.zeros(2))
        assert tree["a"][1] == "kept"


@pytest.mark.parametrize("name", list(DRIVER_RUNS))
def test_sharded_driver(drivers, name):
    """Every rank returns the same final vertices, losses and reference
    images, equal to one rank's run; a remesh gives every rank the same
    topology; on host bins every rank rebins on the same steps."""
    sharded, single = drivers
    got = _result(sharded, name)
    want = single[name]
    for g in got:
        np.testing.assert_array_equal(g["v_final"], got[0]["v_final"])
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
        assert g["rebin_steps"] == got[0]["rebin_steps"]
        assert len(g["f"]) == len(want["f"])
        for fa, fb in zip(g["f"], got[0]["f"]):
            np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(got[0]["im_ref"], want["im_ref"], atol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got[0]["v_final"], want["v_final"],
                               atol=1e-4)
    if name == "dense_remesh":
        assert len(got[0]["f"]) == 2
        assert got[0]["f"][1].shape == want["f"][1].shape
    if name == "rebins":
        assert got[0]["rebin_steps"], "no rebin"
        assert got[0]["rebin_steps"] == want["rebin_steps"]


def test_checkpoint_resumes_at_another_world_size(resumed):
    """Rank 0's checkpoint of the 4-rank run resumes on 2 ranks as on one:
    the same state at step 2, the same two more steps."""
    two, one = resumed
    np.testing.assert_array_equal(two[0]["v_final"], two[1]["v_final"])
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["v_final"], one["v_final"],
                               atol=1e-4)
    assert two[0]["iters"] == one["iters"] == 4


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_launch_fails_with_the_ranks_stderr(how):
    """A rank that raises, or ranks that outlive the time limit (one waits
    in a collective the other never joins), end the launch with every
    rank killed and their standard error in the message."""
    with pytest.raises(RankFailed) as e:
        launch(fail_rank, 2, args=(how,),
               timeout=60.0 if how == "raise" else 8.0)
    msg = str(e.value)
    if how == "raise":
        assert "rank 1 gives up" in msg and "a rank failed" in msg
    else:
        assert "ran past" in msg


def test_sharding_needs_a_process_group():
    """Without a process group of dp · sp ranks the driver raises."""
    with pytest.raises(RuntimeError, match="process group"):
        optimize_shape(make((64, 128)), {**DRIVER, "steps": 1,
                                         "sharding": {"dp": 2, "sp": 2}},
                       device="cpu")
