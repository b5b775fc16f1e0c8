"""Parity of the port's AMG tier (``core/multigrid.py``) and the block-AMG
solver (``core/solvers.py:BlockAmgSolver``) with the JAX package's.

The same matrices go through both packages on the CPU.  Tolerances: the
aggregation and the hierarchy's shapes exactly (the numpy setup is the
JAX package's own); the coarse operators' values 1e-6 relative (the
Galerkin sums are float64 on the host in both); one V-cycle 1e-5 relative
to its largest entry; AMG-PCG and block-AMG solves within 5e-4 of the
solution, JAX's own bar (``tests/test_solvers.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.core import (compute_matrix as j_compute_matrix,
                                 to_differential as j_to_diff)
from largesteps_tpu.core import multigrid as jmg
from largesteps_tpu.core.solvers import BlockAmgSolver as JBlockAmg
from largesteps_tpu.ops import icosphere

from largesteps_torch.core import multigrid as mg
from largesteps_torch.core.blocksp import BlockedOperator
from largesteps_torch.core.geometry import compute_matrix
from largesteps_torch.core.parameterize import get_solver
from largesteps_torch.core.solvers import BlockAmgSolver
from largesteps_torch.core.sparse import CooMatvec

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor operations: beside other test processes on the
    host's cores, torch's intra-op threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def ico4():
    """icosphere-4 (2,562 verts), λ = 19, both packages, u = M v."""
    v, f = icosphere(4)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    return v, f, Mj, Mt, np.asarray(j_to_diff(Mj, jnp.asarray(v)))


@pytest.fixture(scope="module")
def hierarchies(ico4):
    """Both packages' hierarchies of icosphere-4 with ``coarse_limit`` 100:
    three coarsenings before the dense coarsest level."""
    _, _, Mj, Mt, _ = ico4
    return (jmg.build_hierarchy(Mj, coarse_limit=100),
            mg.build_hierarchy(Mt, coarse_limit=100))


@pytest.mark.parametrize("subdiv", [3, 5])
def test_greedy_aggregate_matches_jax(subdiv):
    v, f = icosphere(subdiv)
    st = compute_matrix(v, f, lambda_=19.0, device="cpu").structure
    n = st.shape[0]
    agg = mg.greedy_aggregate(st.rows, st.cols, n)
    np.testing.assert_array_equal(agg, jmg.greedy_aggregate(st.rows, st.cols,
                                                             n))
    # every vertex in an aggregate, ids dense from 0
    assert agg.min() == 0 and len(np.unique(agg)) == agg.max() + 1


def test_build_hierarchy_matches_jax(hierarchies):
    hj, ht = hierarchies
    assert len(ht.levels) == len(hj.levels) >= 3
    assert ht.omega == hj.omega
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.n_coarse == lj.n_coarse
        if lj.agg is None:
            assert lt.agg is None
        else:
            np.testing.assert_array_equal(N(lt.agg), np.asarray(lj.agg))
        assert isinstance(lt.op, CooMatvec)
        np.testing.assert_array_equal(N(lt.op.rows),
                                      lj.op.structure.rows)
        np.testing.assert_array_equal(N(lt.op.cols),
                                      lj.op.structure.cols)
        assert _rel(N(lt.op.vals), np.asarray(lj.op.vals)) < 1e-6
        assert _rel(N(lt.inv_diag), np.asarray(lj.inv_diag)) < 1e-6
    assert _rel(N(ht.coarse_inv), np.asarray(hj.coarse_inv)) < 1e-5
    info = mg.describe(ht)
    assert info["level_rows"] == [int(lv.inv_diag.shape[0])
                                  for lv in hj.levels]
    assert info["level_blocks"] == [None] * len(hj.levels)


@pytest.mark.parametrize("ncols", [1, 3])
def test_vcycle_matches_jax(ico4, hierarchies, ncols):
    hj, ht = hierarchies
    n = ico4[3].shape[0]
    b = np.random.default_rng(ncols).normal(size=(n, ncols)).astype(
        np.float32)
    if ncols == 1:
        b = b[:, 0]
    zj = np.asarray(jmg.vcycle(hj, jnp.asarray(b)))
    zt = N(mg.vcycle(ht, T(b)))
    assert zt.shape == zj.shape
    assert _rel(zt, zj) < 1e-5


def test_amg_pcg_matches_jax(ico4, hierarchies):
    v, _, _, _, u = ico4
    hj, ht = hierarchies
    xj = np.asarray(jmg.amg_pcg_solve(hj, jnp.asarray(u), tol=1e-6))
    xt = N(mg.amg_pcg_solve(ht, T(u), tol=1e-6))
    assert np.abs(xt - v).max() < 5e-4
    assert np.abs(xt - xj).max() < 5e-4
    # warm-started at its own answer, it takes fewer iterations
    x, cold = mg._amg_pcg(ht, T(u), None, 1e-6, 100)
    _, warm = mg._amg_pcg(ht, T(u), x, 1e-6, 100)
    assert int(warm) < int(cold)


def test_multigrid_solver_behind_get_solver(ico4):
    v, _, _, Mt, u = ico4
    slv = get_solver(Mt, "AMG")
    assert isinstance(slv, mg.MultigridSolver) and slv.tier == "amg"
    x = N(slv.solve(T(u)))
    assert np.abs(x - v).max() < 5e-4 and int(slv.iters) > 0
    np.testing.assert_allclose(N(slv.solve(T(u[:, 1]))), x[:, 1], atol=5e-4)


def test_block_amg_solver_matches_jax(ico4):
    """BlockAmgSolver at icosphere-4 (below BLOCK_LIMIT: COO levels) in both
    packages, cold and warm-started."""
    v, _, Mj, Mt, u = ico4
    js, ts = JBlockAmg(Mj, tol=1e-6), BlockAmgSolver(Mt, tol=1e-6)
    np.testing.assert_array_equal(N(ts.perm), np.asarray(js.perm))
    xj = np.asarray(js.solve(jnp.asarray(u)))
    xt = N(ts.solve(T(u)))
    assert np.abs(xt - v).max() < 5e-4 and np.abs(xt - xj).max() < 5e-4
    x2 = N(ts.solve(T(u), T(xt)))
    assert np.abs(x2 - v).max() < 5e-4
    x1 = N(ts.solve(T(u[:, 0])))
    assert np.abs(x1 - v[:, 0]).max() < 5e-4


def test_block_amg_engages_blocked_tier():
    """At icosphere-5 (10,242 verts, past BLOCK_LIMIT) the fine level runs
    the dense-block matvec, with JAX's blocks, and solves to 5e-4."""
    v, f = icosphere(5)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    js, ts = JBlockAmg(Mj, tol=1e-6), BlockAmgSolver(Mt, tol=1e-6)
    op, opj = ts._mg.h.levels[0].op, js._mg.h.levels[0].op
    assert isinstance(op, BlockedOperator)
    assert (op.n_blocks, op.hbm_bytes) == (opj.n_blocks, opj.hbm_bytes)
    info = mg.describe(ts._mg.h)
    assert info["level_blocks"][0] == op.n_blocks
    assert info["block_bytes"] == op.hbm_bytes
    u = np.asarray(j_to_diff(Mj, jnp.asarray(v)))
    xt = N(ts.solve(T(u)))
    assert np.abs(xt - v).max() < 5e-4
    assert np.abs(xt - np.asarray(js.solve(jnp.asarray(u)))).max() < 5e-4
