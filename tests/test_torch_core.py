"""Parity of the PyTorch port's core and host modules with the JAX package.

The same inputs, made from a numpy seed, go through the JAX function and its
port (``largesteps_torch``, on the CPU) and must agree.  Tolerances: solves
1e-5 (the dense-inverse solver's accuracy in float32), everything that is
the same float32 arithmetic in another order 1e-6 relative, host code
exactly.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.core import (compute_matrix as j_compute_matrix,
                                 to_differential as j_to_diff,
                                 from_differential as j_from_diff,
                                 adam_uniform)
from largesteps_tpu.core.optimize import adam
from largesteps_tpu.core.sparse import from_coo as j_from_coo, coo_matvec as j_matvec
from largesteps_tpu.ops import shapes as j_shapes
from largesteps_tpu.ops.mesh import remove_duplicates as j_remove_duplicates
from largesteps_tpu.ops.normals import (compute_face_normals as j_fn,
                                        compute_vertex_normals as j_vn)
from largesteps_tpu.io.synth import make_scene as j_make_scene
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.sh import sh_matrices as j_sh_matrices, sh_eval as j_sh_eval
from largesteps_tpu.render.texture import texture_bilinear as j_texture
from largesteps_tpu.render.antialias import face_adjacency as j_face_adjacency
from largesteps_tpu.render.renderer import render_backgrounds as j_backgrounds

from largesteps_torch.core.geometry import compute_matrix
from largesteps_torch.core.optimize import Adam, AdamUniform
from largesteps_torch.core.parameterize import (to_differential,
                                                from_differential, get_solver)
from largesteps_torch.core.solvers import CholeskySolver
from largesteps_torch.core.sparse import from_coo, coo_matvec
from largesteps_torch.ops import shapes
from largesteps_torch.ops.mesh import remove_duplicates
from largesteps_torch.ops.normals import (compute_face_normals,
                                          compute_vertex_normals)
from largesteps_torch.io.synth import make_scene
from largesteps_torch.render.camera import project
from largesteps_torch.render.sh import sh_matrices, sh_eval
from largesteps_torch.render.texture import texture_bilinear
from largesteps_torch.render.antialias import face_adjacency
from largesteps_torch.render.renderer import render_backgrounds
from largesteps_torch.driver.checkpoint import (save_checkpoint,
                                                load_checkpoint,
                                                state_from_numpy)

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module")
def mesh():
    v, f = j_shapes.icosphere(2)
    return v, f


def test_coo_matvec():
    rng = np.random.default_rng(1)
    n, nnz = 40, 300
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    yj = j_matvec(j_from_coo(rows, cols, jnp.asarray(vals), (n, n)),
                  jnp.asarray(x))
    yt = coo_matvec(from_coo(rows, cols, T(vals), (n, n)), T(x))
    np.testing.assert_allclose(N(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", [{"lambda_": 19.0}, {"alpha": 0.95},
                                  {"alpha": 0.0}])
def test_compute_matrix(mesh, form):
    v, f = mesh
    Mj = j_compute_matrix(v, f, **form)
    Mt = compute_matrix(v, f, device="cpu", **form)
    np.testing.assert_array_equal(Mt.structure.rows, Mj.structure.rows)
    np.testing.assert_array_equal(Mt.structure.cols, Mj.structure.cols)
    np.testing.assert_allclose(N(Mt.vals), np.asarray(Mj.vals), rtol=1e-6)


@pytest.mark.parametrize("alpha", [1.0, -0.1])
def test_compute_matrix_alpha_range(mesh, alpha):
    v, f = mesh
    with pytest.raises(ValueError):
        j_compute_matrix(v, f, alpha=alpha)
    with pytest.raises(ValueError, match="alpha"):
        compute_matrix(v, f, alpha=alpha, device="cpu")


def test_differential_round_trip_and_gradient(mesh):
    v, f = mesh
    Mj = j_compute_matrix(v, f, lambda_=19.0)
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    uj = j_to_diff(Mj, jnp.asarray(v))
    ut = to_differential(Mt, T(v))
    np.testing.assert_allclose(N(ut), np.asarray(uj), rtol=1e-6, atol=1e-6)

    vj = j_from_diff(Mj, uj)
    ut = ut.clone().requires_grad_(True)
    vt = from_differential(Mt, ut)
    np.testing.assert_allclose(N(vt), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(N(vt), v, atol=1e-5)

    w = np.random.default_rng(2).normal(size=v.shape).astype(np.float32)
    gj = jax.grad(lambda u: jnp.vdot(jnp.asarray(w), j_from_diff(Mj, u)))(uj)
    (T(w) * vt).sum().backward()
    np.testing.assert_allclose(N(ut.grad), np.asarray(gj), atol=1e-5)
    # M = Mᵀ: the gradient is one more solve of the same system
    np.testing.assert_allclose(N(ut.grad), N(from_differential(Mt, T(w))),
                               atol=1e-6)


def test_solver_cached_per_structure(mesh):
    v, f = mesh
    Mt = compute_matrix(v, f, lambda_=19.0, device="cpu")
    assert get_solver(Mt) is get_solver(Mt)
    assert get_solver(Mt).tier == "dense_inv"


@pytest.mark.parametrize("method", ["CG", "AMG"])
def test_unported_solvers_raise(mesh, method):
    """The iterative solvers, once unported, build behind ``get_solver``
    and solve the round trip to JAX's bar (5e-4)."""
    v, f = mesh
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    slv = get_solver(M, method)
    assert slv.tier == method.lower()
    x = from_differential(M, to_differential(M, T(v)), method)
    assert np.abs(N(x) - v).max() < 5e-4


def test_dense_limit_raises(mesh):
    """Past ``dense_limit`` the banded tier runs; a bandwidth it refuses
    (here: past a lowered ``max_block``) takes the block-AMG tier, as in
    the JAX package."""
    v, f = mesh
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    assert CholeskySolver(M, dense_limit=4).tier == "banded"
    assert CholeskySolver(M, dense_limit=4, max_block=64).tier == "blockamg"


# each port optimizer beside its JAX transformation, and the leaves of the
# transformation's state that hold (count, g1, g2)
OPTIMIZERS = {
    "AdamUniform": (adam_uniform, AdamUniform,
                    lambda st: (st.count, st.g1, st.g2)),
    "Adam": (adam, Adam, lambda st: (st[0].count, st[0].mu, st[0].nu)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_adam_uniform_three_steps(name):
    """Each optimizer against its JAX transformation (AdamUniform, and
    ``optax.adam`` for Adam) over 3 steps, rtol 1e-6."""
    j_tx, t_opt, moments = OPTIMIZERS[name]
    rng = np.random.default_rng(3)
    u0 = rng.normal(size=(9, 3)).astype(np.float32)
    tr0 = rng.normal(size=(1, 3)).astype(np.float32)
    grads = [(rng.normal(size=(9, 3)).astype(np.float32),
              rng.normal(size=(1, 3)).astype(np.float32)) for _ in range(3)]
    tx = j_tx(0.03)
    theta_j = {"u": jnp.asarray(u0), "tr": jnp.asarray(tr0)}
    state = tx.init(theta_j)
    u = T(u0).clone().requires_grad_(True)
    tr = T(tr0).clone().requires_grad_(True)
    opt = t_opt([tr, u], lr=0.03)
    for gu, gt in grads:
        upd, state = tx.update({"u": jnp.asarray(gu), "tr": jnp.asarray(gt)},
                               state)
        theta_j = jax.tree.map(lambda a, b: a + b, theta_j, upd)
        u.grad, tr.grad = T(gu), T(gt)
        opt.step()
        np.testing.assert_allclose(N(u), np.asarray(theta_j["u"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(N(tr), np.asarray(theta_j["tr"]),
                                   rtol=1e-6, atol=1e-7)
    count, _, g2 = moments(state)
    assert opt.state[u]["count"] == int(count) == 3
    np.testing.assert_allclose(N(opt.state[u]["g2"]), np.asarray(g2["u"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_checkpoint_leaf_order_matches_jax(tmp_path, name):
    """A JAX checkpoint's leaves land in the port's theta and moments, and
    the port's file reads back in the JAX package, for either optimizer
    (optax's ``(ScaleByAdamState, EmptyState)`` flattens to count, mu.tr,
    mu.u, nu.tr, nu.u: AdamUniform's order)."""
    from largesteps_tpu.driver.checkpoint import save_checkpoint as j_save
    j_tx, t_opt, moments = OPTIMIZERS[name]
    rng = np.random.default_rng(4)
    theta = {"u": jnp.asarray(rng.normal(size=(6, 3)), jnp.float32),
             "tr": jnp.asarray(rng.normal(size=(1, 3)), jnp.float32)}
    tx = j_tx(0.01)
    state = tx.init(theta)
    for _ in range(2):
        _, state = tx.update(jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
            theta), state)
    path = os.path.join(tmp_path, "j.npz")
    j_save(path, theta=theta, opt_state=state, v_src=np.zeros((6, 3)),
           f_src=np.zeros((2, 3), np.int32), step=2, step_size=0.01)
    ck = load_checkpoint(path)
    th, load_into = state_from_numpy(ck["theta"], ck["opt_state"], "cpu")
    np.testing.assert_array_equal(N(th["u"]), np.asarray(theta["u"]))
    np.testing.assert_array_equal(N(th["tr"]), np.asarray(theta["tr"]))
    opt = t_opt([th["tr"], th["u"]], lr=0.01)
    load_into(opt)
    _, g1, g2 = moments(state)
    assert opt.state[th["u"]]["count"] == 2
    np.testing.assert_array_equal(N(opt.state[th["u"]]["g1"]),
                                  np.asarray(g1["u"]))
    np.testing.assert_array_equal(N(opt.state[th["tr"]]["g2"]),
                                  np.asarray(g2["tr"]))
    # and back: the port's file reads as the JAX package's
    from largesteps_tpu.driver.checkpoint import load_checkpoint as j_load
    path2 = os.path.join(tmp_path, "t.npz")
    save_checkpoint(path2, theta=th, optimizer=opt, v_src=np.zeros((6, 3)),
                    f_src=np.zeros((2, 3), np.int32), step=2, step_size=0.01)
    back = j_load(path2, theta_like=theta, opt_state_like=state)
    count_b, g1_b, g2_b = moments(back["opt_state"])
    np.testing.assert_array_equal(np.asarray(g1_b["tr"]),
                                  np.asarray(g1["tr"]))
    np.testing.assert_array_equal(np.asarray(g2_b["u"]), np.asarray(g2["u"]))
    assert int(count_b) == 2


@pytest.mark.parametrize("name,arg", [("icosphere", 2), ("gourd", 2),
                                      ("torus", 12), ("supershape", 1)])
def test_shapes_copied(name, arg):
    vj, fj = getattr(j_shapes, name)(arg)
    vt, ft = getattr(shapes, name)(arg)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


def test_remove_duplicates_and_adjacency():
    v, f = j_shapes.icosphere(1)
    v2 = np.concatenate([v, v[:5]])             # duplicated seam vertices
    f2 = f.copy()
    f2[:3, 0] = len(v) + np.arange(3)
    for a, b in zip(remove_duplicates(v2, f2), j_remove_duplicates(v2, f2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(face_adjacency(f), j_face_adjacency(f))


def test_normals(mesh):
    v, _ = j_shapes.gourd(2)
    _, f = mesh
    fj = j_fn(jnp.asarray(v), f)
    nj = j_vn(jnp.asarray(v), f, fj)
    vt = T(v).requires_grad_(True)
    ft = compute_face_normals(vt, f)
    nt = compute_vertex_normals(vt, f, ft)
    np.testing.assert_allclose(N(ft), np.asarray(fj), atol=1e-6)
    np.testing.assert_allclose(N(nt), np.asarray(nj), atol=1e-6)
    w = np.random.default_rng(5).normal(size=v.shape).astype(np.float32)
    gj = jax.grad(lambda x: jnp.vdot(jnp.asarray(w),
                                     j_vn(x, f, j_fn(x, f))))(jnp.asarray(v))
    (T(w) * nt).sum().backward()
    np.testing.assert_allclose(N(vt.grad), np.asarray(gj), atol=1e-4)


def test_normals_degenerate_face_finite_gradient():
    v = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [1, 0, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3]], np.int32)
    vt = T(v).requires_grad_(True)
    n = compute_vertex_normals(vt, f, compute_face_normals(vt, f))
    n.sum().backward()
    assert torch.isfinite(vt.grad).all()


def test_scene_and_camera():
    sj = j_make_scene(source=("icosphere", 1), target=("gourd", 1),
                      n_views=3, res=32)
    st = make_scene(source=("icosphere", 1), target=("gourd", 1),
                    n_views=3, res=32)
    for k in ("res_x", "res_y", "fov", "near_clip", "far_clip"):
        assert st[k] == sj[k]
    np.testing.assert_array_equal(st["envmap"], sj["envmap"])
    np.testing.assert_array_equal(np.stack(st["view_mats"]),
                                  np.stack(sj["view_mats"]))
    for m in ("mesh-source", "mesh-target"):
        np.testing.assert_array_equal(st[m]["vertices"], sj[m]["vertices"])
    from largesteps_tpu.render.camera import persp_proj, build_mvps
    mvps = build_mvps(persp_proj(45.0), np.stack(sj["view_mats"]))
    v = sj["mesh-target"]["vertices"]
    np.testing.assert_allclose(N(project(T(v), T(mvps))),
                               np.asarray(j_project(jnp.asarray(v), mvps)),
                               rtol=1e-6, atol=1e-6)


def test_sh_texture_backgrounds():
    sj = j_make_scene(source=("icosphere", 1), target=("gourd", 1),
                      n_views=2, res=32)
    env = sj["envmap"]
    Mj = j_sh_matrices(env)
    Mt = sh_matrices(env)
    np.testing.assert_allclose(N(Mt), np.asarray(Mj), rtol=1e-5, atol=1e-5)
    n = np.random.default_rng(6).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(N(sh_eval(Mt, T(n))),
                               np.asarray(j_sh_eval(Mj, jnp.asarray(n))),
                               rtol=1e-5, atol=1e-5)
    uv = np.random.default_rng(7).uniform(-0.1, 1.1, (20, 2)).astype(
        np.float32)
    np.testing.assert_allclose(N(texture_bilinear(T(env), T(uv))),
                               np.asarray(j_texture(jnp.asarray(env),
                                                    jnp.asarray(uv))),
                               rtol=1e-6, atol=1e-6)
    bj = j_backgrounds(env, np.stack(sj["view_mats"]), 45.0, (32, 32))
    bt = render_backgrounds(env, np.stack(sj["view_mats"]), 45.0, (32, 32))
    # arccos/arctan2 differ in the last ulp between the two libraries; the
    # bright sun lobe turns that into ~1e-5 on values up to ~8
    np.testing.assert_allclose(N(bt), np.asarray(bj), rtol=1e-5, atol=1e-5)
