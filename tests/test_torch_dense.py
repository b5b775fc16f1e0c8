"""Parity of the port's dense renderer (``Renderer(backend="dense")``) and
its driver on it with the JAX package's ``backend="xla"``, on the CPU at
``tests/test_render.py``'s scene: icosphere-2 in 3 views of 40², a size
that does not tile, so ``"auto"`` takes the dense path in both packages.

Tolerances: images 1e-5 absolute; gradients 1e-4 × max|g|; losses 1e-4
relative.  Both packages draw the same clip coordinates: the JAX renderer
is given the port's projection (the same four products summed in the same
order, ``largesteps_torch/render/camera.py:project``).  The JAX package's
matrix product rounds 10 % of the clip coordinates differently in the last
ulp, and at this size that flips the coverage of a silhouette pixel or
moves an antialias crossing.  The JAX renderer runs op by op (not under
``jax.jit``, which may contract a product and a sum into one rounding).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.ops.normals import (compute_face_normals as j_fn,
                                        compute_vertex_normals as j_vn)
from largesteps_tpu.render import renderer as jrenderer

from largesteps_torch.driver import optimize_shape
from largesteps_torch.ops.normals import (compute_face_normals,
                                          compute_vertex_normals)
from largesteps_torch.render.renderer import Renderer, Topology

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
STEP = {"step_size": 0.03, "lambda": 19.0, "boost": 3, "loss": "l2",
        "optimizer": "AdamUniform"}


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _port_order_project(verts, mvps):
    """JAX's ``project`` in the port's order of operations."""
    m = jnp.asarray(mvps)[:, None, :, :]
    x, y, z = (verts[None, :, None, k] for k in range(3))
    return ((m[..., 0] * x + m[..., 1] * y) + m[..., 2] * z) + m[..., 3]


@pytest.fixture(scope="module")
def scene40():
    """``tests/test_render.py``'s scene: 3 views at 40²."""
    return make_scene(source=("icosphere", 2), target=("gourd", 2),
                      n_views=3, res=40)


@pytest.mark.parametrize("shading", [True, False])
def test_dense_renderer_matches_jax(scene40, shading):
    v = scene40["mesh-source"]["vertices"]
    f = scene40["mesh-source"]["faces"]
    jr = jrenderer.Renderer(scene40, shading=shading, boost=3)
    tr = Renderer(scene40, shading=shading, boost=3, device="cpu")
    assert jr.backend == "xla" and tr.backend == "dense"
    jt = jrenderer.Topology(f)
    vj = jnp.asarray(v)
    nj = j_vn(vj, f, j_fn(vj, f))
    w = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "project", _port_order_project)
        ij = np.asarray(jr.render(vj, nj, jt))
        w = np.random.default_rng(3).normal(size=ij.shape).astype(np.float32)
        gv, gn = jax.grad(lambda a, b: (jnp.asarray(w) * jr.render(
            a, b, jt)).sum(), argnums=(0, 1))(vj, nj)
    vt = T(v).requires_grad_(True)
    nt = compute_vertex_normals(vt, f, compute_face_normals(vt, f)).detach()
    nt.requires_grad_(True)
    it = tr.render(vt, nt, Topology(f))
    assert np.max(np.abs(N(it) - ij)) < 1e-5
    (T(w) * it).sum().backward()
    assert _max_rel(N(vt.grad), np.asarray(gv)) < 1e-4
    if shading:
        assert _max_rel(N(nt.grad), np.asarray(gn)) < 1e-4


def test_backend_choice(scene40):
    """``"auto"``: tiles where the resolution tiles into 32×128, dense
    elsewhere (40², 250²); ``"tiles"`` refuses a size that does not tile;
    the dense backend has no bins."""
    assert Renderer(scene40, device="cpu").backend == "dense"
    for res, want in ((250, "dense"), (256, "tiles")):
        assert Renderer({**scene40, "res_x": res, "res_y": res},
                        device="cpu").backend == want
    with pytest.raises(ValueError, match="tile"):
        Renderer(scene40, backend="tiles", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        Renderer(scene40, backend="xla", device="cpu")
    r = Renderer(scene40, device="cpu")
    f = scene40["mesh-source"]["faces"]
    assert r.check_overflow(scene40["mesh-source"]["vertices"],
                            Topology(f)) == 0


def test_driver_dense_matches_jax(scene40):
    """3 steps at 40² in both packages, both on the dense renderer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "project", _port_order_project)
        want = j_optimize_shape(scene40, {**STEP, "steps": 3})
    got = optimize_shape(scene40, {**STEP, "steps": 3}, device="cpu")
    assert got["prof"]["backend"] == "dense"
    assert got["prof"]["raster_chunk"] == 128
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["losses"][-1, 0] < got["losses"][0, 0]
