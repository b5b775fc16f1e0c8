"""The port's fixed-order segment sums against the JAX package.

On the card the port adds every segment sum of a step in a fixed order
(``largesteps_torch/ops/segment.py``: the vertex normals, the mass matrix,
the COO matvec and its gradient, the slot → face sums of the backward glue,
the dense rasterizer's backward), where ``index_add_`` would add with
float atomics.  Here, on the CPU, each is held against the JAX function on
the same seeded numpy inputs at 1e-6 relative to the largest entry (the
same float32 sums, added in another order), and the sums themselves
against ``index_add_``, whose sequential CPU sums they must equal to the
bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.core.geometry import laplacian_uniform as j_laplacian
from largesteps_tpu.core.sparse import coo_matvec as j_matvec
from largesteps_tpu.ops import shapes as j_shapes
from largesteps_tpu.ops.mesh import massmatrix_voronoi as j_mass
from largesteps_tpu.ops.normals import (compute_face_normals as j_fn,
                                        compute_vertex_normals as j_vn)
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.raster import rasterize as j_rasterize

from largesteps_torch.core.geometry import laplacian_uniform
from largesteps_torch.core.sparse import coo_matvec
from largesteps_torch.ops.mesh import massmatrix_voronoi
from largesteps_torch.ops.normals import (compute_face_normals,
                                          compute_vertex_normals,
                                          corner_segments)
from largesteps_torch.ops.segment import Segments, segment_sum
from largesteps_torch.render import kernels
from largesteps_torch.render.pipeline import (build_incidence, chain_planes,
                                              face_sums, first_half,
                                              scatter_via_faces,
                                              slot_face_rows)
from largesteps_torch.render.raster import rasterize

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def close(got, want, tol=1e-6):
    got, want = N(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def mesh():
    """icosphere-2, its vertices moved by a seeded 5 % noise."""
    v, f = j_shapes.icosphere(2)
    rng = np.random.default_rng(0)
    v = (np.asarray(v) * (1 + 0.05 * rng.standard_normal((len(v), 1))))
    return v.astype(np.float32), np.asarray(f, np.int64)


def test_segments_equal_index_add(mesh):
    """Segments and segment_sum add each row's entries in input order:
    on the CPU the bits of index_add_'s sequential sums, and the gather's
    gradient is the segment sum."""
    v, f = mesh
    rng = np.random.default_rng(1)
    vals = T(rng.standard_normal((f.size, 5)).astype(np.float32))
    ids = T(f.T.reshape(-1))
    want = torch.zeros((len(v), 5)).index_add_(0, ids, vals)
    seg = Segments(f.T, len(v))
    assert torch.equal(seg.sum(vals), want)
    assert torch.equal(Segments(ids, len(v)).sum(vals), want)
    assert torch.equal(segment_sum(vals, ids, len(v)), want)
    x = T(v).requires_grad_(True)
    g = T(rng.standard_normal((f.size, 3)).astype(np.float32))
    seg.gather(x).backward(g)
    assert torch.equal(x.grad, torch.zeros_like(x).index_add_(0, ids, g))


def test_normals_match_jax(mesh):
    """Face and vertex normals, with and without the corner segments, and
    their gradient in the vertices."""
    v, f = mesh
    want = j_vn(jnp.asarray(v), f, j_fn(jnp.asarray(v), f))
    w = np.random.default_rng(2).standard_normal(v.shape).astype(np.float32)
    j_grad = jax.grad(lambda x: jnp.sum(j_vn(x, f, j_fn(x, f)) * w))(
        jnp.asarray(v))
    x = T(v).requires_grad_(True)
    corners = corner_segments(f, len(v), "cpu")
    got = compute_vertex_normals(x, f, compute_face_normals(x, f, corners),
                                 corners)
    close(got, want)
    close(compute_vertex_normals(x, f, compute_face_normals(x, f)), want)
    (got * T(w)).sum().backward()
    close(x.grad, j_grad)


def test_mass_matrix_matches_jax(mesh):
    v, f = mesh
    close(massmatrix_voronoi(T(v), f), j_mass(jnp.asarray(v), f))


def test_coo_matvec_and_gradient_match_jax(mesh):
    """L x by row segments, and its gradient in x (Lᵀ g by column
    segments) and in L's values."""
    v, f = mesh
    n = len(v)
    Lj, Lt = j_laplacian(n, f), laplacian_uniform(n, f, device="cpu")
    x = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    close(coo_matvec(Lt, T(x)), j_matvec(Lj, jnp.asarray(x)))
    close(coo_matvec(Lt, T(x[:, 0])), j_matvec(Lj, jnp.asarray(x[:, 0])))
    j_gx = jax.grad(lambda y: jnp.sum(j_matvec(Lj, y) * w))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    vals = Lt.vals.clone().requires_grad_(True)
    Lt.vals = vals
    (coo_matvec(Lt, xt) * T(w)).sum().backward()
    close(xt.grad, j_gx)
    rows, cols = Lj.rows, Lj.cols
    close(vals.grad, np.sum(w[rows] * x[cols], axis=1))


def test_face_sums_match_jax(mesh):
    """The slot → face → vertex sums of the backward glue
    (``scatter_via_faces``, and ``scatter_via_slots`` through the face →
    slot inverse) against JAX's ``_scatter_via_faces`` on random per-slot
    rows of 2 cameras of 2 × 2 tiles, bins holding each face at most once a
    tile and empty slots.  The per-face table is each half of the tile
    rows summed in slot order, then the halves added, bit for bit, by
    either route."""
    v, f = mesh
    F, V = len(f), len(v)
    C, TY, TX, cap = 2, 2, 2, 96
    rng = np.random.default_rng(5)
    bins = np.full((C, TY, TX, cap), -1, np.int64)
    for c in range(C):
        for r in range(TY):
            for t in range(TX):
                k = rng.integers(cap // 2, cap)
                bins[c, r, t, :k] = rng.choice(F, k, replace=False)
    table = rng.standard_normal((C, TY, TX, cap, 18)).astype(np.float32)
    inc_j = pc.build_incidence(f, V)
    want = pc._scatter_via_faces(jnp.asarray(table), jnp.asarray(bins),
                                 inc_j, F, V)
    idx, mask = build_incidence(f, V)
    got = scatter_via_faces(T(table), T(bins), (T(idx), T(mask)), F, V)
    for g, w in zip(got, want):
        close(g, w)
    # the per-face table: each half of the tile rows summed in slot order
    # (index_add_'s sequential sums on the CPU), then the halves
    ids = torch.where(T(bins) >= 0, T(bins), F) \
        + (torch.arange(C) * (F + 1))[:, None, None, None]
    halves = [torch.zeros((C * (F + 1), 18)).index_add_(
        0, ids[:, r].reshape(-1), T(table)[:, r].reshape(-1, 18))
        for r in range(TY)]
    dface = face_sums(T(table), T(bins), F)
    assert torch.equal(dface, halves[0] + halves[1])
    # through the face -> slot inverse (tile order, sentinel T*cap)
    K = TY * TX
    fslots = np.full((C, F + 1, K), TY * TX * cap, np.int64)
    for c in range(C):
        for t in range(K):
            for s in np.flatnonzero(bins[c].reshape(K, cap)[t] >= 0):
                fslots[c, bins[c].reshape(K, cap)[t, s], t] = t * cap + s
    via = slot_face_rows(T(table), T(fslots))
    # (the sentinel rows differ: face_sums puts the empty slots there)
    assert torch.equal(via[:, :F], dface.reshape(C, F + 1, 18)[:, :F])


def test_chain_face_rows_on_the_cpu_is_the_composition():
    """``kernels.chain_face_rows`` on CPU tensors is
    ``slot_face_rows(chain_planes(...))`` bit for bit, and launches
    nothing: 1 camera of 128² (4 tile rows, the upper 2 the first half),
    cap 256, 300 faces of K = 4 slots in tile order with sentinels among
    them, and a slot with an inf and a NaN column."""
    rng = np.random.default_rng(7)
    C, TY, TX, cap, F, K = 1, 4, 1, 256, 300, 4
    S = TY * TX * cap
    rand = lambda *shape: T(rng.standard_normal(shape).astype(np.float32))
    dslot, dslot_aa = rand(C, TY, TX, cap, 32), rand(C, TY, TX, cap, 8)
    rbb = rand(C, TY, TX, cap, 32)
    dslot[0, 1, 0, 5, 3], dslot[0, 1, 0, 5, 7] = float("inf"), float("nan")
    fslots = np.full((C, F + 1, K), S, np.int64)
    fslots[0, :F] = np.sort(np.stack([rng.choice(S, K, replace=False)
                                      for _ in range(F)]), axis=1)
    fslots[0, :F][rng.random((F, K)) < 0.3] = S
    fslots[0, 0] = [5 + cap, S, 2 * cap + 1, S]     # the inf slot, both halves
    before = dict(kernels.LAUNCHES)
    got = kernels.chain_face_rows(dslot, dslot_aa, 3.0, rbb, T(fslots),
                                  TY // 2)
    want = slot_face_rows(chain_planes(dslot, dslot_aa, 3.0, rbb),
                          T(fslots), first_half(TY))
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and got[0, 0].abs().max() > 0
    assert kernels.LAUNCHES == before


def test_dense_raster_backward_matches_jax(mesh):
    """The dense rasterizer's vertex gradient, its pixels summed into
    (camera, vertex) rows by a segment sum, against JAX's."""
    v, f = mesh
    rng = np.random.default_rng(6)
    C, H, W = 2, 24, 20
    clip = np.concatenate([0.8 * v, np.ones((len(v), 1), np.float32)], 1)
    clip = np.stack([clip, clip * np.float32([1, -1, 1, 1])])
    clip[..., 2] = 0.5 + 0.1 * clip[..., 2]
    g = rng.standard_normal((C, H, W, 4)).astype(np.float32)
    g[..., 2:] = 0.0
    j_grad = jax.grad(lambda x: jnp.sum(j_rasterize(x, f, (H, W)) * g))(
        jnp.asarray(clip))
    x = T(clip).requires_grad_(True)
    (rasterize(x, f, (H, W)) * T(g)).sum().backward()
    close(x.grad, j_grad)
