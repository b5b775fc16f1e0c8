"""Parity of the port's iterative solvers, sparse helpers and cotangent
Laplacian with the JAX package, and the driver under ``solver: "CG"`` and
``"AMG"``.

The same numpy-seeded inputs go through ``largesteps_tpu`` and
``largesteps_torch`` on the CPU.  Tolerances: CG's ``x`` within 1e-5 of
JAX's and its iteration count within 2 (the two sum the dot products in
another order, so a column may cross ``tol`` an iteration apart); solves of
the direct tiers 1e-5 relative; the cotangent Laplacian's values and its
gradient in the vertices 1e-5 relative to their largest entry; exact
structures; the driver's losses 1e-4 relative and its vertices 1e-4 ×
max|v|, as ``test_optimize_shape_matches_jax`` holds the Cholesky run.
"""
import gc
import importlib
import os
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.core import (compute_matrix as j_compute_matrix,
                                 cg_solve as j_cg_solve,
                                 from_differential as j_from_diff,
                                 laplacian_cot as j_laplacian_cot,
                                 to_differential as j_to_diff)
from largesteps_tpu.core.banded import BandedSolver as JBanded
from largesteps_tpu.core.blocksp import BlockedOperator as JBlocked
from largesteps_tpu.core.solvers import CholeskySolver as JCholesky
from largesteps_tpu.core.sparse import (coo_matvec as j_matvec,
                                        from_coo as j_from_coo)
from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.ops import icosphere

from largesteps_torch.core import parameterize
from largesteps_torch.core.banded import BandedSolver
from largesteps_torch.core.blocksp import (BlockedOperator, permuted_coo,
                                           rcm_permutation)
from largesteps_torch.core.geometry import compute_matrix, laplacian_cot
from largesteps_torch.core.parameterize import (from_differential,
                                                get_solver, to_differential)
from largesteps_torch.core.solvers import (BlockAmgSolver, CholeskySolver,
                                           ConjugateGradientSolver, cg_solve,
                                           solve)
from largesteps_torch.core.sparse import coo_matvec, from_coo
from largesteps_torch.driver import optimize_shape

drv_mod = importlib.import_module("largesteps_torch.driver.optimize_shape")
T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
STEP = {"step_size": 0.03, "lambda": 19.0, "boost": 3, "loss": "l2",
        "optimizer": "AdamUniform"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The solves are many small tensor operations: beside other test
    processes on the host's cores, torch's intra-op threads only wait on
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module", params=[2, 3], ids=["ico2", "ico3"])
def system(request):
    """icosphere-2 / -3, λ = 19, in both packages; u = M v and a seeded
    warm start near v."""
    v, f = icosphere(request.param)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    u = np.asarray(j_to_diff(Mj, jnp.asarray(v)))
    x0 = (v + 1e-2 * np.random.default_rng(0).normal(size=v.shape)).astype(
        np.float32)
    return v, f, Mj, Mt, u, x0


def _jax_iters_within(Mj, u, x0, n, slack=2):
    """Whether JAX's CG takes n ± slack iterations: its loop stops when every
    column is frozen, so cut at ``max_iter`` = m it returns the full run's x
    bit for bit exactly when it needs at most m iterations."""
    full = np.asarray(j_cg_solve(Mj, u, x0=x0))
    cut = lambda m: np.asarray(j_cg_solve(Mj, u, x0=x0, max_iter=m))
    done_by_high = np.array_equal(cut(n + slack), full)
    busy_at_low = n - slack - 1 < 0 or not np.array_equal(
        cut(n - slack - 1), full)
    return done_by_high and busy_at_low


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_cg_matches_jax(system, start):
    v, f, Mj, Mt, u, x0 = system
    x0 = None if start == "cold" else x0
    xj = np.asarray(j_cg_solve(Mj, jnp.asarray(u),
                               x0=None if x0 is None else jnp.asarray(x0)))
    slv = ConjugateGradientSolver(Mt)
    xt = N(slv.solve(T(u), None if x0 is None else T(x0)))
    assert np.abs(xt - xj).max() < 1e-5
    assert np.abs(xt - v).max() < 5e-4
    np.testing.assert_array_equal(N(cg_solve(Mt, T(u), None if x0 is None
                                             else T(x0))), xt)
    n = int(slv.iters)
    assert n > 0
    assert _jax_iters_within(Mj, jnp.asarray(u),
                             None if x0 is None else jnp.asarray(x0), n)


def test_cg_one_column_and_converged_start(system):
    v, f, Mj, Mt, u, _ = system
    slv = ConjugateGradientSolver(Mt)
    x1 = N(slv.solve(T(u[:, 0])))
    np.testing.assert_allclose(x1, np.asarray(j_cg_solve(Mj, jnp.asarray(
        u[:, 0]))), atol=1e-5)
    # started at the solution, no iteration runs and x stays
    x = N(slv.solve(T(u), T(v)))
    assert int(slv.iters) == 0
    np.testing.assert_array_equal(x, v)


def test_cg_solve_gradient_is_inverse(system):
    """∂(wᵀ M⁻¹ u)/∂u = M⁻¹ w under CG, the JAX gradient, and no gradient
    reaches the guesses."""
    v, f, Mj, Mt, u, x0 = system
    w = np.random.default_rng(1).normal(size=u.shape).astype(np.float32)
    gj = jax.grad(lambda uu: jnp.vdot(jnp.asarray(w), j_from_diff(
        Mj, uu, "CG")))(jnp.asarray(u))
    ut = T(u).requires_grad_(True)
    gf, gb = T(x0).requires_grad_(True), T(x0).requires_grad_(True)
    (T(w) * from_differential(Mt, ut, "CG", gf, gb)).sum().backward()
    np.testing.assert_allclose(N(ut.grad), np.asarray(gj), atol=1e-5)
    np.testing.assert_allclose(N(ut.grad), N(CholeskySolver(Mt).solve(T(w))),
                               atol=5e-4)
    assert gf.grad is None and gb.grad is None


def test_guesses_reach_the_solves(system):
    """The forward solve starts from ``guess_fwd``, the backward from
    ``guess_bwd``: started at the exact solution the forward does not
    iterate, started at a cold solve's answer the backward (whose fresh
    residual may sit just above ``tol``) takes at most 2 iterations."""
    v, f, Mj, Mt, u, _ = system
    slv = get_solver(Mt, "CG")
    w = np.random.default_rng(2).normal(size=u.shape).astype(np.float32)
    gw = slv.solve(T(w))
    cold = int(slv.iters)
    ut = T(u).requires_grad_(True)
    x = solve(slv, ut, T(v), gw)
    assert int(slv.iters) == 0
    (T(w) * x).sum().backward()
    assert int(slv.iters) <= 2 < cold
    np.testing.assert_allclose(N(ut.grad), N(gw), atol=1e-5)


def test_sparse_diagonal_scale_transpose():
    rng = np.random.default_rng(4)
    n, nnz = 30, 200
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    Aj = j_from_coo(rows, cols, jnp.asarray(vals), (n, n))
    At = from_coo(rows, cols, T(vals), (n, n))
    np.testing.assert_array_equal(N(At.diagonal()), np.asarray(Aj.diagonal()))
    np.testing.assert_allclose(N(At.scale(2.5).vals),
                               np.asarray(Aj.scale(2.5).vals), rtol=1e-7)
    Tt, Tj = At.transpose(), Aj.transpose()
    np.testing.assert_array_equal(Tt.structure.rows, Tj.structure.rows)
    np.testing.assert_array_equal(Tt.structure.cols, Tj.structure.cols)
    np.testing.assert_array_equal(N(Tt.vals), np.asarray(Tj.vals))
    x = rng.normal(size=(n, 2)).astype(np.float32)
    np.testing.assert_allclose(N(coo_matvec(Tt, T(x))),
                               np.asarray(j_matvec(Tj, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bumpy():
    """icosphere-3 with seeded radial bumps: cotangent weights of both
    signs and of many sizes."""
    v, f = icosphere(3)
    r = 1.0 + 0.1 * np.random.default_rng(5).uniform(size=(len(v), 1))
    return (v * r).astype(np.float32), f


def test_laplacian_cot_matches_jax(bumpy):
    v, f = bumpy
    Lj = j_laplacian_cot(jnp.asarray(v), f)
    Lt = laplacian_cot(T(v), f)
    np.testing.assert_array_equal(Lt.structure.rows, Lj.structure.rows)
    np.testing.assert_array_equal(Lt.structure.cols, Lj.structure.cols)
    assert _rel(N(Lt.vals), np.asarray(Lj.vals)) < 1e-5


def test_laplacian_cot_gradient_matches_jax(bumpy):
    """The gradient of Σ w ⊙ (L_cot(v) v) in v: through the weights and the
    product."""
    v, f = bumpy
    w = np.random.default_rng(6).normal(size=v.shape).astype(np.float32)

    def energy_j(vv):
        return jnp.vdot(jnp.asarray(w), j_matvec(j_laplacian_cot(vv, f), vv))

    gj = np.asarray(jax.grad(energy_j)(jnp.asarray(v)))
    vt = T(v).requires_grad_(True)
    (T(w) * coo_matvec(laplacian_cot(vt, f), vt)).sum().backward()
    assert np.isfinite(N(vt.grad)).all()
    assert _rel(N(vt.grad), gj) < 1e-5


@pytest.mark.parametrize("form", [{"lambda_": 19.0}, {"alpha": 0.95}])
def test_compute_matrix_cotan(bumpy, form):
    v, f = bumpy
    Mj = j_compute_matrix(v, f, cotan=True, **form)
    Mt = compute_matrix(v, f, cotan=True, device="cpu", **form)
    np.testing.assert_array_equal(Mt.structure.rows, Mj.structure.rows)
    np.testing.assert_array_equal(Mt.structure.cols, Mj.structure.cols)
    assert _rel(N(Mt.vals), np.asarray(Mj.vals)) < 1e-5
    # a tensor that requires grad keeps its graph through the matrix
    vt = T(v).requires_grad_(True)
    compute_matrix(vt, f, cotan=True, **form).vals.sum().backward()
    assert vt.grad is not None and np.isfinite(N(vt.grad)).all()


@pytest.mark.parametrize("tier", ["dense_inv", "banded"])
def test_refine_matches_jax(tier):
    """One refinement pass on each direct tier against JAX's (the banded
    tier alone: JAX's CholeskySolver refines its dense tier only)."""
    v, f = icosphere(3)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    b = np.random.default_rng(7).normal(size=v.shape).astype(np.float32)
    if tier == "dense_inv":
        js, ts = JCholesky(Mj, refine=1), CholeskySolver(Mt, refine=1)
        assert ts.tier == "dense_inv" and ts.refine == 1
    else:
        js, ts = JBanded(Mj, refine=1), BandedSolver(Mt, refine=1)
        assert ts.refine == 1
    xj = np.asarray(js.solve(jnp.asarray(b)))
    xt = N(ts.solve(T(b)))
    assert _rel(xt, xj) < 1e-5
    A = N(Mt.todense()).astype(np.float64)
    x64 = np.linalg.solve(A, b.astype(np.float64))
    assert _rel(xt, x64) < 2e-6
    np.testing.assert_allclose(N(ts.solve(T(b[:, 0]))), xt[:, 0], atol=1e-6)


def test_blocked_operator_and_permuted_coo():
    """BlockedOperator in the identity order (unpadded input) and on the
    RCM-permuted, padded matrix against coo_matvec and JAX's operator."""
    v, f = icosphere(3)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    n = Mt.shape[0]
    x = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    y = N(coo_matvec(Mt, T(x)))
    op = BlockedOperator(Mt, np.arange(n, dtype=np.int64), 128)
    opj = JBlocked(Mj, np.arange(n, dtype=np.int64), 128)
    assert (op.n_blocks, op.hbm_bytes) == (opj.n_blocks, opj.hbm_bytes)
    np.testing.assert_allclose(N(op.matvec(T(x))), y, rtol=0, atol=2e-4)
    # the same products summed in another order
    np.testing.assert_allclose(N(op.matvec(T(x))),
                               np.asarray(opj.matvec(jnp.asarray(x))),
                               rtol=0, atol=1e-6 * np.abs(y).max())
    np.testing.assert_allclose(N(op.matvec(T(x[:, 0]))), y[:, 0], atol=2e-4)
    st = Mt.structure
    perm, inv = rcm_permutation(st.rows, st.cols, n)
    n_pad = ((n + 127) // 128) * 128
    Mp = permuted_coo(Mt, inv, n_pad)
    assert Mp.shape == (n_pad, n_pad)
    np.testing.assert_array_equal(N(Mp.diagonal())[n:], 1.0)
    opp = BlockedOperator(Mp, np.arange(n_pad, dtype=np.int64), 128)
    xp = np.zeros((n_pad, 3), np.float32)
    xp[:n] = x[perm]
    yp = N(opp.matvec(T(xp)))
    np.testing.assert_allclose(yp[inv], y, rtol=0, atol=2e-4)
    np.testing.assert_allclose(N(coo_matvec(Mp, T(xp)))[inv], y,
                               atol=1e-6 * np.abs(y).max())


def test_cholesky_falls_back_to_blockamg():
    """Past ``dense_limit`` with a ``max_block`` below the banded tier's
    block, CholeskySolver is block-AMG: it solves to 5e-4 (JAX's bar),
    differentiably, and takes the warm start."""
    v, f = icosphere(4)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    slv = CholeskySolver(Mt, dense_limit=100, max_block=64)
    assert slv.tier == "blockamg"
    assert isinstance(slv._big, BlockAmgSolver)
    u = to_differential(Mt, T(v))
    x = slv.solve(u)
    assert np.abs(N(x) - v).max() < 5e-4
    cold = int(slv.iters)
    slv.solve(u, x)
    assert int(slv.iters) < cold
    ut = u.clone().requires_grad_(True)
    w = T(np.random.default_rng(8).normal(size=v.shape).astype(np.float32))
    (w * solve(slv, ut)).sum().backward()
    np.testing.assert_allclose(N(ut.grad), N(slv.solve(w)), atol=1e-6)


@pytest.mark.parametrize("kind", ["CG", "AMG", "dense_refine",
                                  "banded_refine", "blockamg"])
def test_solver_does_not_hold_its_structure(kind):
    """A solver keeps no ``CooStructure``: when the matrix goes, its
    structure goes, and the cache (keyed on it through a weakref) drops
    the solver."""
    v, f = icosphere(3)
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    make = {"dense_refine": lambda M: CholeskySolver(M, refine=1),
            "banded_refine": lambda M: BandedSolver(M, refine=1),
            "blockamg": lambda M: CholeskySolver(M, dense_limit=100,
                                                 max_block=64)}
    if kind in make:
        slv = make[kind](M)
    else:
        slv = get_solver(M, kind)
        assert get_solver(M, kind) is slv
        key = (id(M.structure), kind)
        assert key in parameterize._cache
    wr_st, wr_slv = weakref.ref(M.structure), weakref.ref(slv)
    u = to_differential(M, T(v))
    x = slv.solve(u)
    del M, u
    gc.collect()
    assert wr_st() is None
    if kind not in make:
        assert key not in parameterize._cache
        del slv
        gc.collect()
        assert wr_slv() is None
    assert np.abs(N(x) - v).max() < 5e-4


@pytest.fixture(scope="module")
def scene():
    return make_scene(source=("icosphere", 2), target=("gourd", 2),
                      n_views=2, res=128)


def test_optimize_shape_cg_matches_jax(scene):
    """3 steps under ``solver: "CG"`` in both packages: the warm starts
    threaded alike give JAX's losses and vertices."""
    p = {**STEP, "solver": "CG", "steps": 3}
    full_j = j_optimize_shape(scene, dict(p))
    full_t = optimize_shape(scene, dict(p), device="cpu")
    np.testing.assert_allclose(full_t["losses"], full_j["losses"], rtol=1e-4)
    assert full_t["losses"][-1, 0] < full_t["losses"][0, 0]
    scale = np.abs(full_j["v_final"]).max()
    np.testing.assert_allclose(full_t["v_final"], full_j["v_final"],
                               atol=1e-4 * scale)
    np.testing.assert_allclose(full_t["tr"], full_j["tr"], atol=1e-5)
    assert full_t["prof"]["solver"]["tier"] == "cg"
    it = full_t["prof"]["solve_iters"]
    assert it.shape == (3, 2)
    # step 0's forward starts at the source vertices, its solution
    assert it[0, 0] == 0 and (it[:, 1] > 0).all()


def test_optimize_shape_amg(scene):
    """2 steps under ``solver: "AMG"``, the port alone: finite, falling
    losses; the AMG tier; the forward of step 0 warm-started at the source
    vertices, the backward of step 1 at step 0's gradient."""
    res = optimize_shape(scene, {**STEP, "solver": "AMG", "steps": 2},
                         device="cpu")
    losses = res["losses"][:, 0]
    assert np.isfinite(res["losses"]).all() and losses[-1] < losses[0]
    assert res["prof"]["solver"]["tier"] == "amg"
    assert res["prof"]["solver"]["level_rows"] == [162]
    it = res["prof"]["solve_iters"]
    assert it.shape == (2, 2) and it[0, 0] == 0 and (it[:, 1] > 0).all()
    cg = optimize_shape(scene, {**STEP, "solver": "CG", "steps": 2},
                        device="cpu")
    np.testing.assert_allclose(res["losses"], cg["losses"], rtol=1e-4)


def test_cg_resume_from_checkpoint(scene, tmp_path):
    """Under CG, 1 step and a checkpoint, then a resumed run to 2 steps,
    against 2 steps straight: the resumed step starts its guesses afresh
    (the JAX driver's rule), so its solves start elsewhere and the losses
    agree to CG's tolerance, not bit for bit."""
    ck = os.path.join(tmp_path, "cg.npz")
    base = {**STEP, "solver": "CG", "nan_check_every": 1}
    first = optimize_shape(scene, {**base, "steps": 1, "checkpoint_every": 1,
                                   "checkpoint_path": ck}, device="cpu")
    second = optimize_shape(scene, {**base, "steps": 2, "resume": ck},
                            device="cpu")
    both = optimize_shape(scene, {**base, "steps": 2}, device="cpu")
    np.testing.assert_allclose(
        np.concatenate([first["losses"], second["losses"]]), both["losses"],
        rtol=1e-4)
    scale = np.abs(both["v_final"]).max()
    np.testing.assert_allclose(second["v_final"], both["v_final"],
                               atol=1e-4 * scale)
    assert second["prof"]["solve_iters"][0, 0] > 0


@pytest.mark.parametrize("solver", ["CG", "AMG"])
def test_remesh_frees_the_iterative_solver(monkeypatch, solver):
    """A remesh under an iterative solver frees the old epoch's solver and
    matrix structure before the new epoch is built."""
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=2, res=32)
    build = drv_mod._build_epoch
    refs = []

    def tracked(*args, **kw):
        alive = [name for name, r in refs if r() is not None]
        assert not alive, alive
        st = build(*args, **kw)
        refs.extend([("solver", weakref.ref(st.solver)),
                     ("structure", weakref.ref(st.M.structure))])
        return st

    monkeypatch.setattr(drv_mod, "_build_epoch", tracked)
    res = optimize_shape(scene, {"steps": 3, "remesh": [1], "solver": solver,
                                 "step_size": 0.05, "lambda": 9.0},
                         device="cpu")
    assert len(res["f"]) == 2 and res["prof"]["solver"]["tier"] == \
        solver.lower()
