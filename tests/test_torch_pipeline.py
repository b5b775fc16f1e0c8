"""Parity of the port's render pipeline, renderer and driver with the JAX
package (pallas backend, interpret mode on the CPU), at 2 views of 128².

Tolerances: images 1e-5 absolute and gradients 1e-4 × max|g|, as the JAX
kernels meet against their dense oracle.  Where the two packages' inputs
differ in the last ulp (the JAX package projects with a matrix product, the
port with a fixed-order elementwise sum), the test states how many pixels
may move and why.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.ops.normals import (compute_face_normals as j_fn,
                                        compute_vertex_normals as j_vn)
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.antialias import face_adjacency
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.renderer import (Renderer as JRenderer,
                                            Topology as JTopology)

from largesteps_torch.driver import optimize_shape
from largesteps_torch.ops.normals import (compute_face_normals,
                                          compute_vertex_normals)
from largesteps_torch.render.pipeline import RenderPipeline
from largesteps_torch.render.renderer import Renderer, Topology

H = W = 128
CAP = 256
T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
STEP = {"step_size": 0.03, "lambda": 19.0, "boost": 3, "loss": "l2",
        "optimizer": "AdamUniform"}


@pytest.fixture(scope="module")
def scene():
    return make_scene(source=("icosphere", 2), target=("gourd", 2),
                      n_views=2, res=H)


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


@pytest.mark.parametrize("shading", [True, False])
def test_pipeline_matches_pallas_pipeline(scene, shading):
    """The same clip-space vertices through both fused pipelines."""
    v = scene["mesh-source"]["vertices"]
    f = scene["mesh-source"]["faces"]
    opp = face_adjacency(f)
    jr = JRenderer(scene, backend="xla")
    v_ndc = np.asarray(j_project(jnp.asarray(v), jr.mvps))
    rng = np.random.default_rng(0)
    attrs = rng.uniform(size=v.shape).astype(np.float32)
    bg = np.asarray(jr.bgs) if shading else None
    jpipe = pc.make_render_pipeline(f, opp, (H, W), shading=shading,
                                    boost=3.0, cap=CAP)
    tpipe = RenderPipeline(f, opp, (H, W), shading=shading, boost=3.0,
                           cap=CAP)
    out_j = jpipe(jnp.asarray(v_ndc), jnp.asarray(attrs),
                  None if bg is None else jnp.asarray(bg))
    vt = T(v_ndc).requires_grad_(True)
    at = T(attrs).requires_grad_(True)
    bt = None if bg is None else T(bg).requires_grad_(True)
    out_t = tpipe(vt, at, bt)
    assert np.max(np.abs(N(out_t) - np.asarray(out_j))) < 1e-5

    w = rng.normal(size=out_j.shape).astype(np.float32)
    argn = (0, 1, 2) if shading else (0, 1)
    gj = jax.grad(lambda a, b, c: (jnp.asarray(w) * jpipe(a, b, c)).sum(),
                  argnums=argn)(jnp.asarray(v_ndc), jnp.asarray(attrs),
                                None if bg is None else jnp.asarray(bg))
    (T(w) * out_t).sum().backward()
    assert _max_rel(N(vt.grad), np.asarray(gj[0])) < 1e-4
    assert _max_rel(N(at.grad), np.asarray(gj[1])) < 1e-4
    if shading:
        assert np.max(np.abs(N(bt.grad) - np.asarray(gj[2]))) < 1e-5


def test_renderer_images_and_gradients(scene):
    v = scene["mesh-source"]["vertices"]
    f = scene["mesh-source"]["faces"]
    jr = JRenderer(scene, shading=True, boost=3, backend="pallas",
                   bin_cap=CAP)
    jt = JTopology(f)
    tr = Renderer(scene, shading=True, boost=3, bin_cap=CAP, device="cpu")
    tt = Topology(f)
    vj = jnp.asarray(v)
    nj = j_vn(vj, f, j_fn(vj, f))
    ij = np.asarray(jr.render(vj, nj, jt))
    vt = T(v).requires_grad_(True)
    nt = compute_vertex_normals(vt, f, compute_face_normals(vt, f)).detach()
    nt.requires_grad_(True)
    it = tr.render(vt, nt, tt)
    d = np.abs(N(it) - ij)
    # the projections round differently in the last ulp; on an edge nearly
    # parallel to a pixel pair that moves the antialias crossing t, so at
    # most 16 of the 131k values may differ by more than 1e-5 (4 did when
    # this was written), and none by more than 1e-3
    assert (d > 1e-5).sum() <= 16 and d.max() < 1e-3, ((d > 1e-5).sum(),
                                                         d.max())
    w = np.random.default_rng(1).normal(size=ij.shape).astype(np.float32)
    gv, gn = jax.grad(lambda a, b: (jnp.asarray(w) * jr.render(a, b, jt)
                                    ).sum(), argnums=(0, 1))(vj, nj)
    (T(w) * it).sum().backward()
    assert _max_rel(N(vt.grad), np.asarray(gv)) < 1e-4
    assert _max_rel(N(nt.grad), np.asarray(gn)) < 1e-4


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """3-step runs in both packages, and a JAX 2-step run that checkpoints."""
    ck = str(tmp_path_factory.mktemp("ck") / "jax.npz")
    full_j = j_optimize_shape(scene, {**STEP, "steps": 3})
    first_j = j_optimize_shape(scene, {**STEP, "steps": 2,
                                       "checkpoint_every": 2,
                                       "checkpoint_path": ck})
    full_t = optimize_shape(scene, {**STEP, "steps": 3}, device="cpu")
    return full_j, first_j, full_t, ck


def test_optimize_shape_matches_jax(runs):
    full_j, _, full_t, _ = runs
    np.testing.assert_allclose(full_t["losses"], full_j["losses"], rtol=1e-4)
    assert full_t["losses"][-1, 0] < full_t["losses"][0, 0]
    scale = np.abs(full_j["v_final"]).max()
    np.testing.assert_allclose(full_t["v_final"], full_j["v_final"],
                               atol=1e-4 * scale)
    np.testing.assert_allclose(full_t["tr"], full_j["tr"], atol=1e-5)
    assert full_t["iters"] == 3
    np.testing.assert_array_equal(full_t["f_final"], full_j["f_final"])


def test_resume_from_jax_checkpoint(scene, runs):
    """JAX runs 2 steps and checkpoints; the port resumes and runs the 3rd;
    the result matches the 3-step JAX run."""
    full_j, first_j, _, ck = runs
    np.testing.assert_allclose(first_j["losses"], full_j["losses"][:2],
                               rtol=1e-6)
    second = optimize_shape(scene, {**STEP, "steps": 3, "resume": ck},
                            device="cpu")
    assert second["losses"].shape == (1, 2)
    np.testing.assert_allclose(second["losses"], full_j["losses"][2:],
                               rtol=1e-4)
    scale = np.abs(full_j["v_final"]).max()
    np.testing.assert_allclose(second["v_final"], full_j["v_final"],
                               atol=1e-4 * scale)


def test_port_checkpoint_resumes_in_port(scene, tmp_path):
    ck = os.path.join(tmp_path, "t.npz")
    base = {**STEP, "nan_check_every": 1}
    first = optimize_shape(scene, {**base, "steps": 1, "checkpoint_every": 1,
                                   "checkpoint_path": ck}, device="cpu")
    second = optimize_shape(scene, {**base, "steps": 2, "resume": ck},
                            device="cpu")
    both = optimize_shape(scene, {**base, "steps": 2}, device="cpu")
    np.testing.assert_allclose(
        np.concatenate([first["losses"], second["losses"]]), both["losses"],
        rtol=1e-5)
    np.testing.assert_allclose(second["v_final"], both["v_final"], atol=1e-6)


@pytest.mark.parametrize("params", [{"sharding": {"dp": 2}},
                                    {"host_bin_faces": 100,   # row-sharded
                                     "sharding": {"dp": 1, "sp": 2}}])
def test_unported_driver_options_raise(scene, params):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimize_shape(scene, {"steps": 1, **params}, device="cpu")


def test_no_card_no_fallback(scene):
    """Without ``device`` the port runs on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_shape(scene, {"steps": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene)
