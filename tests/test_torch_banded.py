"""Parity of the port's banded tier (``core/blocksp.py``, ``core/banded.py``
and ``CholeskySolver`` above ``dense_limit``) with the JAX package's.

Tolerances: the RCM permutation is identical; the solution within 1e-5 of
the JAX tier's relative to its largest entry, and its residual against the
matrix in float64 within 1e-5 relative, as the JAX tier is held
(``tests/test_solvers.py``); the gradient through ``solve`` within 1e-5 of
the JAX one, likewise.

The sweep kernel's plain mirror (``banded_sweep_plain``: the z-first
backward sweep, each dot in the kernel's fixed order) within 1e-5 of the
plain loop and of JAX's sweeps; on the CPU the solve takes the plain loop
(no launch counted), and the wrapper refuses what the kernel does not take
on every device.  The card's half is in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from largesteps_tpu.core.banded import (BandedSolver as JBanded,
                                        BandedUnsuitable as JUnsuitable,
                                        _solve_blocks as j_solve_blocks)
from largesteps_tpu.core.blocksp import rcm_permutation as j_rcm
from largesteps_tpu.core.geometry import compute_matrix as j_compute_matrix
from largesteps_tpu.core.solvers import (CholeskySolver as JCholesky,
                                         solve as j_solve)
from largesteps_tpu.ops import icosphere

from largesteps_torch.core.banded import (LAUNCHES, BandedSolver,
                                          BandedUnsuitable, _solve_blocks,
                                          banded_sweep, banded_sweep_plain)
from largesteps_torch.core.blocksp import rcm_permutation
from largesteps_torch.core.geometry import compute_matrix
from largesteps_torch.core import solvers
from largesteps_torch.core.solvers import (BlockAmgSolver, CholeskySolver,
                                           solve)
from test_torch_gpu import _sweep_bad_args, _sweep_loop, _sweep_system

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module")
def system():
    """icosphere-4 (2,562 verts), λ = 19, in both packages; a seeded
    right-hand side."""
    v, f = icosphere(4)
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    b = np.random.default_rng(0).normal(size=(v.shape[0], 3)).astype(
        np.float32)
    return Mj, Mt, b


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_rcm_permutation_matches_jax(system):
    _, Mt, _ = system
    st = Mt.structure
    for got, want in zip(rcm_permutation(st.rows, st.cols, st.shape[0]),
                         j_rcm(st.rows, st.cols, st.shape[0])):
        np.testing.assert_array_equal(got, want)


def test_banded_tier_matches_jax(system):
    Mj, Mt, b = system
    js = JCholesky(Mj, dense_limit=100)
    ts = CholeskySolver(Mt, dense_limit=100)
    assert js.tier == ts.tier == "banded"
    assert (ts._big.B, ts._big.nb) == (js._big.B, js._big.nb)
    x = N(ts.solve(T(b)))
    assert _rel(x, np.asarray(js.solve(jnp.asarray(b)))) < 1e-5
    st = Mt.structure
    A = sp.coo_matrix((N(Mt.vals).astype(np.float64), (st.rows, st.cols)),
                      shape=st.shape).tocsc()
    assert _rel(A @ x.astype(np.float64), b.astype(np.float64)) < 1e-5
    x64 = spl.spsolve(A, b.astype(np.float64))
    assert _rel(x, x64) < 1e-5
    # one right-hand side
    x1 = N(BandedSolver(Mt).solve(T(b[:, 0])))
    assert _rel(x1, x64[:, 0]) < 1e-5


def test_banded_solve_gradient_matches_jax(system):
    Mj, Mt, b = system
    js = JCholesky(Mj, dense_limit=100)
    ts = CholeskySolver(Mt, dense_limit=100)
    w = np.random.default_rng(1).normal(size=b.shape).astype(np.float32)
    gj = jax.grad(lambda u: jnp.vdot(jnp.asarray(w), j_solve(js, u)))(
        jnp.asarray(b))
    u = T(b).requires_grad_(True)
    (T(w) * solve(ts, u)).sum().backward()
    assert _rel(N(u.grad), np.asarray(gj)) < 1e-5


def test_banded_rejects_pathological_bandwidth(monkeypatch):
    """A random triangulation has Ω(n) bandwidth in every ordering: both
    packages' banded tiers refuse it, and the port's CholeskySolver takes
    the block-AMG tier instead, as JAX's does (recorded here, not built:
    its blocked fine level would hold 5.4 GB of blocks)."""
    rng = np.random.default_rng(0)
    n = 40_962
    f = rng.integers(0, n, size=(2 * n, 3), dtype=np.int32)
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    v = rng.standard_normal((n, 3)).astype(np.float32)
    with pytest.raises(JUnsuitable):
        JBanded(j_compute_matrix(v, f, lambda_=19.0))
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    with pytest.raises(BandedUnsuitable):
        BandedSolver(Mt)
    built = []

    class Recorded(BlockAmgSolver):
        def __init__(self, M, tol):
            built.append((M, tol))

    monkeypatch.setattr(solvers, "BlockAmgSolver", Recorded)
    slv = CholeskySolver(Mt)
    assert slv.tier == "blockamg"
    assert len(built) == 1 and built[0][0] is Mt and built[0][1] == 1e-6


@pytest.mark.parametrize("B,nb,k", [(128, 1, 1), (128, 5, 3), (256, 3, 4),
                                    (768, 2, 3)])
def test_banded_sweep_plain_matches_loop_and_jax(B, nb, k):
    """The kernel's mirror on a random SPD block-tridiagonal factor: within
    1e-5 × max|x| of the plain loop and of the JAX package's sweeps."""
    invDp, L, perm, b = _sweep_system(B, nb, k, nb * B, B + nb + k, "cpu")
    want, bp = _sweep_loop(invDp, L, b, perm)
    got = banded_sweep_plain(invDp, L, bp)
    loop = _solve_blocks(invDp, L, bp)
    jax_x = np.asarray(j_solve_blocks(N(invDp), N(L), N(bp)))
    assert _rel(N(got), N(loop)) < 1e-5
    assert _rel(N(got), jax_x) < 1e-5


def test_banded_sweep_cpu_takes_the_plain_loop(system):
    """A CPU tensor goes through ``_solve_blocks`` (the same bits as the
    loop through the permutation) and launches nothing."""
    _, Mt, b = system
    slv = BandedSolver(Mt)
    before = LAUNCHES["banded_sweep"]
    x = slv.solve(T(b))
    want, _ = _sweep_loop(slv.invDp, slv.L, T(b), slv.perm)
    assert torch.equal(x, want)
    assert LAUNCHES["banded_sweep"] == before


@pytest.mark.parametrize("bad", ["block_64", "block_2176", "block_200",
                                 "k_5", "rows", "float64", "strided",
                                 "perm_int32", "unaligned"])
def test_banded_sweep_rejects(bad):
    """What the kernel does not take raises on the CPU too."""
    with pytest.raises(ValueError):
        banded_sweep(*_sweep_bad_args(bad, "cpu"))
