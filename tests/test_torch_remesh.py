"""Parity of the port's remeshing pieces with the JAX package: the
Botsch-Kobbelt remesher, the mesh ops the driver and the metrics use, and
the host Cholesky solver.

Tolerances: ``remesh_botsch`` bit-equal (both packages compile the same
``remesh.cpp`` with the same g++ flags and get the same float64 input);
``average_edge_length`` and ``massmatrix_voronoi`` 1e-6 relative (float32,
the per-vertex sums added in another order); the Voronoi cells sum to the
surface area within 1e-5 relative; ``CholeskyHostSolver`` 1e-5 against
JAX's and against the port's dense-inverse ``CholeskySolver`` (its solve
and gradient, float32 out of a float64 factor).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.core import compute_matrix as j_compute_matrix
from largesteps_tpu.core.solvers import (CholeskyHostSolver as JHostSolver,
                                         solve as j_solve)
from largesteps_tpu.native.remesh import remesh_botsch as j_remesh_botsch
from largesteps_tpu.ops import mesh as j_mesh, shapes as j_shapes

from largesteps_torch.core import parameterize
from largesteps_torch.core.geometry import compute_matrix
from largesteps_torch.core.solvers import (CholeskyHostSolver, CholeskySolver,
                                           solve)
from largesteps_torch.native import cholesky as native_cholesky
from largesteps_torch.native.remesh import remesh_botsch
from largesteps_torch.ops import mesh, shapes

REL = 1e-6


def _mesh(name):
    """A seeded perturbed icosphere-2, or gourd-2, as float32 numpy."""
    if name == "icosphere2":
        v, f = shapes.icosphere(2)
        rng = np.random.default_rng(0)
        v = v + 0.02 * rng.normal(size=v.shape)
    else:
        v, f = shapes.gourd(2)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


MESHES = ["icosphere2", "gourd2"]


@pytest.mark.parametrize("name", MESHES)
def test_remesh_botsch_bit_equal_to_jax(name):
    v, f = _mesh(name)
    h = 0.5 * float(mesh.average_edge_length(torch.as_tensor(v), f))
    v64 = v.astype(np.float64)
    v_t, f_t = remesh_botsch(v64, f, 5, h, True)
    v_j, f_j = j_remesh_botsch(v64, f, 5, h, True)
    assert f_t.dtype == np.int32 and v_t.dtype == np.float64
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(v_t, v_j)
    # the remesher refined the mesh towards h
    assert len(f_t) > len(f)
    e = float(mesh.average_edge_length(torch.as_tensor(v_t), f_t))
    assert 0.8 * h <= e <= 4 / 3 * h, (e, h)


def test_remesh_botsch_rejects_bad_input():
    v, f = _mesh("icosphere2")
    with pytest.raises(ValueError):
        remesh_botsch(v[:, :2], f, 5, 0.1)
    bad = f.copy()
    bad[0, 0] = len(v)
    with pytest.raises(ValueError, match="out of range"):
        remesh_botsch(v, bad, 5, 0.1)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_ops_match_jax(name):
    v, f = _mesh(name)
    e_t = float(mesh.average_edge_length(torch.as_tensor(v), f))
    e_j = float(j_mesh.average_edge_length(v, f))
    assert abs(e_t - e_j) <= REL * abs(e_j)
    cells_t = mesh.massmatrix_voronoi(torch.as_tensor(v), f).numpy()
    cells_j = np.asarray(j_mesh.massmatrix_voronoi(jnp.asarray(v), f))
    np.testing.assert_allclose(cells_t, cells_j, rtol=REL,
                               atol=REL * np.abs(cells_j).max())
    # the cells tile the surface
    fv = v.astype(np.float64)[f]
    area = 0.5 * np.linalg.norm(np.cross(fv[:, 1] - fv[:, 0],
                                         fv[:, 2] - fv[:, 0]), axis=1).sum()
    np.testing.assert_allclose(cells_t.astype(np.float64).sum(), area,
                               rtol=1e-5)
    assert (cells_t > 0).all()


def test_massmatrix_voronoi_obtuse_corners():
    """One obtuse triangle: the obtuse corner takes half its area, the two
    others a quarter each (the reference's correction)."""
    v = np.array([[0, 0, 0], [2, 0, 0], [1, 0.2, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    cells = mesh.massmatrix_voronoi(torch.as_tensor(v), f).numpy()
    area = 0.2
    np.testing.assert_allclose(cells, [area / 4, area / 4, area / 2],
                               rtol=1e-6)
    np.testing.assert_allclose(
        cells, np.asarray(j_mesh.massmatrix_voronoi(jnp.asarray(v), f)),
        rtol=REL)


@pytest.fixture(scope="module")
def system():
    v, f = shapes.icosphere(2)
    v = np.asarray(v, np.float32)
    rng = np.random.default_rng(1)
    b = rng.normal(size=v.shape).astype(np.float32)
    w = rng.normal(size=v.shape).astype(np.float32)
    return v, f, b, w


def _jax_host(system):
    v, f, b, w = system
    slv = JHostSolver(j_compute_matrix(v, f, lambda_=19.0))
    x = j_solve(slv, jnp.asarray(b))
    g = jax.grad(lambda bb: jnp.vdot(jnp.asarray(w), j_solve(slv, bb)))(
        jnp.asarray(b))
    return np.asarray(x), np.asarray(g)


def _torch_solve(slv, b, w):
    bt = torch.as_tensor(b).requires_grad_(True)
    x = solve(slv, bt)
    (x * torch.as_tensor(w)).sum().backward()
    return x.detach().numpy(), bt.grad.numpy()


def test_cholesky_host_solver_matches_jax_and_dense(system):
    v, f, b, w = system
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    host = CholeskyHostSolver(M)
    assert host.tier == "host" and host.n == len(v)
    x, g = _torch_solve(host, b, w)
    assert x.dtype == np.float32 and x.shape == b.shape
    x_j, g_j = _jax_host(system)
    x_d, g_d = _torch_solve(CholeskySolver(M), b, w)
    for got, want in ((x, x_j), (g, g_j), (x, x_d), (g, g_d)):
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # the gradient of wᵀ M⁻¹ b is M⁻¹ w (M = Mᵀ)
    np.testing.assert_allclose(g, host.solve(torch.as_tensor(w)).numpy(),
                               rtol=0, atol=0)


def test_get_solver_cholesky_host_cached_and_cleared(system):
    v, f, _, _ = system
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    slv = parameterize.get_solver(M, "CholeskyHost")
    assert isinstance(slv, CholeskyHostSolver)
    assert parameterize.get_solver(M, "CholeskyHost") is slv
    parameterize.clear_cache()
    assert parameterize.get_solver(M, "CholeskyHost") is not slv


def test_native_cholesky_raises_without_fallback():
    """A matrix that is not SPD raises: no other factorization runs."""
    rows = np.array([0, 1], np.int32)
    with pytest.raises(RuntimeError, match="factorization failed"):
        native_cholesky.factorize(2, rows, rows, np.array([1.0, -1.0]))
