"""Parity of the port's dense rasterizer and antialias and its modular tile
rasterizer with the JAX package (its ``backend="xla"`` modules, and
``pallas_raster`` in interpret mode), on the CPU at small sizes:
icosphere-1 and -2 in one or two views of 64×48 and 40², ``chunk`` 32 with
F a multiple of it and not.  The dense renderer and driver:
``tests/test_torch_dense.py``.

Tolerances: face ids exact; u, v and z/w 1e-5 absolute (the two compute
them by the same expressions); images 1e-5 absolute; interpolated
attributes (unit normal values) 1e-5 × their largest; gradients 1e-4 ×
max|g| (autodiff in both, summed in another order).  The JAX side runs
under ``jax.jit``, which may contract a product and a sum into one
rounding.  The tile rasterizer
against the JAX Pallas one: u and v 1e-4, the JAX kernel's one-hot bf16
gather (``tests/test_torch_kernels.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.render import raster as jraster
from largesteps_tpu.render import renderer as jrenderer
from largesteps_tpu.render.antialias import (antialias as j_antialias,
                                             antialias_dense as j_aa_dense,
                                             face_adjacency)
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.pallas_raster import (rasterize_pallas_fwd,
                                                 rasterize_pallas)

from largesteps_torch.render.antialias import (antialias, antialias_dense,
                                               _auto_cap)
from largesteps_torch.render.raster import interpolate, rasterize
from largesteps_torch.render.tile_raster import (rasterize_tiles,
                                                 rasterize_tiles_fwd)

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _clip(subdiv, n_views, hw):
    """Clip coordinates (C, V, 4) numpy and faces of icosphere-``subdiv``."""
    h, w = hw
    scene = make_scene(source=("icosphere", subdiv), target=("gourd", 2),
                       n_views=n_views, res=h)
    scene["res_x"] = w
    v = scene["mesh-source"]["vertices"]
    f = np.asarray(scene["mesh-source"]["faces"], np.int32)
    mvps = jrenderer.Renderer(scene, backend="xla").mvps
    return np.asarray(j_project(jnp.asarray(v), mvps)), f


CASES = {  # (subdiv, views, (H, W), chunk); F = 80 and 320
    "ico1_2x48x64_chunk32": (1, 2, (48, 64), 32),
    "ico2_1x40x40_chunk32": (2, 1, (40, 40), 32),
    "ico2_2x48x64_chunk48": (2, 2, (48, 64), 48),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def raster_case(request):
    subdiv, n_views, hw, chunk = CASES[request.param]
    vc, f = _clip(subdiv, n_views, hw)
    return vc, f, hw, chunk


def test_rasterize_matches_jax(raster_case):
    vc, f, hw, chunk = raster_case
    want = np.asarray(jax.jit(lambda x: jraster.rasterize(
        x, jnp.asarray(f), hw, chunk))(jnp.asarray(vc)))
    got = N(rasterize(T(vc), f, hw, chunk))
    assert (want[..., 3] > 0).mean() > 0.2           # a real image
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert np.max(np.abs(got[..., :3] - want[..., :3])) < 1e-5


def test_rasterize_gradient_matches_jax(raster_case):
    vc, f, hw, chunk = raster_case
    w = np.random.default_rng(0).normal(size=(vc.shape[0], *hw, 4)) \
        .astype(np.float32)
    gj = jax.jit(jax.grad(lambda x: (jnp.asarray(w) * jraster.rasterize(
        x, jnp.asarray(f), hw, chunk)).sum()))(jnp.asarray(vc))
    x = T(vc).requires_grad_(True)
    (T(w) * rasterize(x, f, hw, chunk)).sum().backward()
    assert np.abs(np.asarray(gj)).max() > 0
    assert _max_rel(N(x.grad), np.asarray(gj)) < 1e-4
    assert np.all(N(x.grad)[..., 2] == 0)            # only u and v enter


@pytest.mark.parametrize("per_camera", [False, True])
def test_interpolate_matches_jax(raster_case, per_camera):
    vc, f, hw, chunk = raster_case
    C, V = vc.shape[:2]
    rng = np.random.default_rng(1)
    attr = rng.normal(size=(C, V, 3) if per_camera else (V, 3)) \
        .astype(np.float32)
    w = rng.normal(size=(C, *hw, 3)).astype(np.float32)
    fj = jnp.asarray(f)

    def loss_j(x, a):
        return (jnp.asarray(w) * jraster.interpolate(
            a, jraster.rasterize(x, fj, hw, chunk), fj)).sum()

    out_j = jax.jit(lambda x, a: jraster.interpolate(
        a, jraster.rasterize(x, fj, hw, chunk), fj))(jnp.asarray(vc),
                                                     jnp.asarray(attr))
    gx, ga = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(vc),
                                                       jnp.asarray(attr))
    x = T(vc).requires_grad_(True)
    a = T(attr).requires_grad_(True)
    out = interpolate(a, rasterize(x, f, hw, chunk), f)
    (T(w) * out).sum().backward()
    assert _max_rel(N(out), np.asarray(out_j)) < 1e-5
    assert _max_rel(N(x.grad), np.asarray(gx)) < 1e-4
    assert _max_rel(N(a.grad), np.asarray(ga)) < 1e-4


@pytest.fixture(scope="module")
def aa_case():
    """Two views of icosphere-2 at 48×64: rast, a random colour and
    cotangent."""
    vc, f = _clip(2, 2, (48, 64))
    rast = np.asarray(jraster.rasterize(jnp.asarray(vc), jnp.asarray(f),
                                        (48, 64), 32))
    rng = np.random.default_rng(2)
    col = rng.uniform(size=(2, 48, 64, 4)).astype(np.float32)
    w = rng.normal(size=col.shape).astype(np.float32)
    return vc, f, face_adjacency(f), rast, col, w


@pytest.mark.parametrize("kind,cap", [("dense", None), ("sparse", None),
                                      ("sparse", 96)],
                         ids=["dense", "compacted", "compacted_overflow"])
def test_antialias_matches_jax(aa_case, kind, cap):
    vc, f, opp, rast, col, w = aa_case
    if cap is not None:
        # the cap overflows: JAX and the port drop the same pairs
        ids = rast[..., 3]
        n_diff = [(ids[c, :, :-1] != ids[c, :, 1:]).sum()
                  + (ids[c, :-1] != ids[c, 1:]).sum() for c in range(2)]
        assert min(n_diff) > cap
    else:
        assert _auto_cap(48 * 63 + 47 * 64) == 2048
    kw = {} if kind == "dense" else {"cap": cap}
    jf, tf = (j_aa_dense, antialias_dense) if kind == "dense" \
        else (j_antialias, antialias)
    args_j = (jnp.asarray(rast),)
    fj, oj = jnp.asarray(f), jnp.asarray(opp)

    def loss_j(c, x):
        return (jnp.asarray(w) * jf(c, *args_j, x, fj, oj, 3.0, **kw)).sum()

    out_j = np.asarray(jax.jit(lambda c, x: jf(c, *args_j, x, fj, oj, 3.0,
                                               **kw))(jnp.asarray(col),
                                                      jnp.asarray(vc)))
    gc, gx = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(col),
                                                       jnp.asarray(vc))
    c = T(col).requires_grad_(True)
    x = T(vc).requires_grad_(True)
    out = tf(c, T(rast), x, f, opp, 3.0, **kw)
    (T(w) * out).sum().backward()
    assert np.max(np.abs(out_j - col)) > 1e-2        # pairs blend
    assert np.max(np.abs(N(out) - out_j)) < 1e-5
    assert _max_rel(N(c.grad), np.asarray(gc)) < 1e-4
    assert np.abs(np.asarray(gx)).max() > 0
    assert _max_rel(N(x.grad), np.asarray(gx)) < 1e-4


@pytest.fixture(scope="module")
def tile_case():
    vc, f = _clip(2, 1, (128, 128))
    return vc, f


def test_tiles_fwd_matches_pallas(tile_case):
    vc, f = tile_case
    want = np.asarray(rasterize_pallas_fwd(jnp.asarray(vc), jnp.asarray(f),
                                           (128, 128), cap=256))
    got = N(rasterize_tiles_fwd(T(vc), f, (128, 128), cap=256))
    assert (want[..., 3] > 0).sum() > 1000
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert np.max(np.abs(got[..., 2] - want[..., 2])) < 1e-6
    assert np.max(np.abs(got[..., :2] - want[..., :2])) < 1e-4
    # and the dense rasterizer's ids
    dense = N(rasterize(T(vc), f, (128, 128)))
    np.testing.assert_array_equal(got[..., 3], dense[..., 3])


def test_tiles_matches_pallas_and_dense_gradient(tile_case):
    """The forward against ``rasterize_pallas``; the gradient against the
    JAX package's dense one, the capacity-free reference.
    ``rasterize_pallas``'s own backward reads the chained gradient table
    with a stride of 7 columns a corner (``pallas_raster.py:79``) where
    ``_chain_planes`` now writes 6 (``pallas_core.py:1201-1235``), so it is
    not the gradient of its forward: it is held here only to that fault."""
    vc, f = tile_case
    fj = jnp.asarray(f)
    w = np.random.default_rng(4).normal(size=(1, 128, 128, 4)) \
        .astype(np.float32)
    out_j = np.asarray(rasterize_pallas(jnp.asarray(vc), f, (128, 128),
                                        cap=256))
    g_dense = np.asarray(jax.jit(jax.grad(lambda x: (
        jnp.asarray(w) * jraster.rasterize(x, fj, (128, 128))).sum()))(
            jnp.asarray(vc)))
    g_pallas = np.asarray(jax.grad(lambda x: (jnp.asarray(w) * rasterize_pallas(
        x, f, (128, 128), cap=256)).sum())(jnp.asarray(vc)))
    x = T(vc).requires_grad_(True)
    out = rasterize_tiles(x, f, (128, 128), cap=256)
    (T(w) * out).sum().backward()
    np.testing.assert_array_equal(N(out)[..., 3], out_j[..., 3])
    assert np.max(np.abs(N(out)[..., :2] - out_j[..., :2])) < 1e-4
    assert _max_rel(N(x.grad), g_dense) < 1e-4
    assert np.all(N(x.grad)[..., 2] == 0)
    # the reference's fault: its "z" column holds the w gradient
    assert _max_rel(g_pallas, g_dense) > 0.1
