"""Parity of the port's fit-quality path with the JAX package: the driver
with plain Adam on the coordinates (the comparison figure's baselines), a
callable optimizer, a scene given as an XML path, the figures' harness,
and the render pipe with a backward stage ablated.

Tolerances: the driver's losses rtol 1e-5 over 3 steps (the port's and the
JAX package's, at icosphere-2 in 2 views of 128²); the ablated pipes'
images 1e-5 absolute and gradients 1e-4 × max|g| (the JAX kernels' bar
against their dense oracle), at 1 view of 128² and cap 256; runs of the
port against the port exactly.
"""
import csv
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene as j_make_scene
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.antialias import face_adjacency
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.renderer import Renderer as JRenderer

from largesteps_torch.core.optimize import Adam
from largesteps_torch.driver import optimize_shape
from largesteps_torch.figures import common, comparison
from largesteps_torch.io import load_scene, make_scene, save_scene
from largesteps_torch.render.pipeline import RenderPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 128
CAP = 256
T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
# the comparison figure's baseline legs (figures/comparison/
# generate_data.py:40-47) at 3 steps
BASELINE = {"optimizer": "Adam", "smooth": False, "reg": 2.8, "loss": "l1",
            "alpha": 0.95, "boost": 3, "step_size": 1e-2, "steps": 3}


@pytest.fixture(scope="module")
def scene():
    return j_make_scene(source=("icosphere", 2), target=("gourd", 2),
                        n_views=2, res=H)


@pytest.fixture(scope="module", params=[True, False],
                ids=["bilaplacian", "laplacian"])
def baseline_runs(request, scene):
    """One JAX and one port run of the baseline leg a regularizer."""
    params = {**BASELINE, "bilaplacian": request.param}
    return (params, j_optimize_shape(scene, params),
            optimize_shape(scene, params, device="cpu"))


def test_adam_baseline_driver_matches_jax(baseline_runs):
    params, full_j, full_t = baseline_runs
    np.testing.assert_allclose(full_t["losses"], full_j["losses"], rtol=1e-5)
    assert full_t["losses"][-1, 0] < full_t["losses"][0, 0]
    # Adam divides each coordinate's gradient by its own magnitude, so a
    # coordinate whose gradient is near eps (1e-8) moves by an amount its
    # last-ulp differences decide: most coordinates agree to 1e-5 of the
    # mesh's size, and none moves apart by more than the steps' total lr
    scale = np.abs(full_j["v_final"]).max()
    d = np.abs(full_t["v_final"] - full_j["v_final"])
    assert (d <= 1e-5 * scale).mean() >= 0.95, (d > 1e-5 * scale).mean()
    assert d.max() <= params["steps"] * params["step_size"]
    np.testing.assert_allclose(full_t["tr"], full_j["tr"], atol=1e-6)


def test_callable_optimizer_equals_adam(scene, baseline_runs):
    """The driver builds a callable's optimizer over [tr, u] at the step
    size: the callable that builds Adam gives the "Adam" run's losses."""
    params, _, full_t = baseline_runs
    seen = []

    def make(p, lr):
        seen.append(lr)
        return Adam(p, lr=lr)

    run = optimize_shape(scene, {**params, "optimizer": make}, device="cpu")
    assert seen == [params["step_size"]]
    np.testing.assert_array_equal(run["losses"], full_t["losses"])
    np.testing.assert_array_equal(run["v_final"], full_t["v_final"])


def test_unknown_optimizer_raises(scene):
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimize_shape(scene, {"steps": 1, "optimizer": "SGD"}, device="cpu")


def _small_scene():
    """A scene the dense renderer draws in a moment (40², 2 views)."""
    return make_scene(source=("icosphere", 1), target=("gourd", 1),
                      n_views=2, res=40)


def test_optimize_shape_takes_an_xml_path(tmp_path):
    path = save_scene(_small_scene(), str(tmp_path), "scene")
    params = {"steps": 2, "step_size": 0.05, "lambda": 9.0}
    from_path = optimize_shape(path, params, device="cpu")
    from_dict = optimize_shape(load_scene(path), params, device="cpu")
    np.testing.assert_array_equal(from_path["losses"], from_dict["losses"])
    np.testing.assert_array_equal(from_path["v_final"], from_dict["v_final"])
    np.testing.assert_array_equal(from_path["im_ref"], from_dict["im_ref"])


def test_run_writes_jax_columns_and_figure_draws_them(tmp_path, monkeypatch):
    """The comparison's three legs through the port's harness (at a small
    scene, 2 steps each) write the JAX harness's files and columns, and the
    JAX package's comparison figure draws them."""
    monkeypatch.setitem(common.SCENES, "suzanne", dict(
        source=("icosphere", 1), target=("gourd", 1), n_views=2, res=40))
    monkeypatch.setattr(common, "OUTPUT_DIR", str(tmp_path))
    for name, params in comparison.legs("suzanne"):
        _, d = common.run(name, "suzanne", {**params, "steps": 2},
                          "comparison", device="cpu")
        assert np.isfinite(d) and d > 0
        base = os.path.join(tmp_path, "comparison", name)
        with open(base + "_loss.csv") as fh:
            rows = list(csv.reader(fh))
        assert rows[0] == ["iteration", "im_loss", "reg_loss"]
        assert len(rows) == 3
        with open(base + "_metrics.csv") as fh:
            head, row = list(csv.reader(fh))
        assert head == ["hausdorff", "iters", "wall_time_s", "iters_per_s",
                        "rebin_s", "rebin_n", "setup_s", "first_step_s"]
        assert float(row[0]) == d and int(row[1]) == 2
        assert os.path.getsize(base + "_final.ply") > 0
    env = dict(os.environ, LS_OUTPUT_DIR=str(tmp_path), LS_FORCE_CPU="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "figures", "comparison",
                                      "figure.py")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    png = os.path.join(tmp_path, "comparison", "figure.png")
    assert os.path.exists(png) and os.path.getsize(png) > 1000


@pytest.fixture(scope="module")
def pipe_inputs():
    scene = j_make_scene(source=("icosphere", 2), target=("gourd", 2),
                         n_views=1, res=H)
    v = scene["mesh-source"]["vertices"]
    f = scene["mesh-source"]["faces"]
    jr = JRenderer(scene, backend="xla")
    v_ndc = np.asarray(j_project(jnp.asarray(v), jr.mvps))
    rng = np.random.default_rng(0)
    attrs = rng.uniform(size=v.shape).astype(np.float32)
    bg = np.asarray(jr.bgs)
    w = rng.normal(size=(1, H, W, 4)).astype(np.float32)
    return f, face_adjacency(f), v_ndc, attrs, bg, w


def _port_grads(pipe, v_ndc, attrs, bg, w):
    args = [T(a).requires_grad_(True) for a in (v_ndc, attrs, bg)]
    out = pipe(*args)
    (T(w) * out).sum().backward()
    return N(out), [N(a.grad) for a in args]


@pytest.mark.parametrize("ablate", ["aabwd", "rbwd", "scatter"])
def test_ablated_pipeline_matches_jax(pipe_inputs, ablate):
    f, opp, v_ndc, attrs, bg, w = pipe_inputs
    jpipe = pc.make_render_pipeline(f, opp, (H, W), shading=True, boost=3.0,
                                    cap=CAP, ablate=ablate)
    out_j, vjp = jax.vjp(jpipe, jnp.asarray(v_ndc), jnp.asarray(attrs),
                         jnp.asarray(bg))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(w))]
    tpipe = RenderPipeline(f, opp, (H, W), shading=True, boost=3.0, cap=CAP,
                           ablate=ablate)
    out_t, grads_t = _port_grads(tpipe, v_ndc, attrs, bg, w)
    assert np.max(np.abs(out_t - np.asarray(out_j))) < 1e-5
    for gt, gj in zip(grads_t, grads_j):
        assert np.max(np.abs(gt - gj)) <= 1e-4 * np.max(np.abs(gj))
    if ablate == "scatter":
        assert not grads_t[0].any() and not grads_t[1].any()
    else:
        assert np.abs(grads_t[0]).max() > 0


def test_ablate_empty_is_the_default_pipe(pipe_inputs):
    f, opp, v_ndc, attrs, bg, w = pipe_inputs
    default = _port_grads(RenderPipeline(f, opp, (H, W), shading=True,
                                         boost=3.0, cap=CAP),
                          v_ndc, attrs, bg, w)
    empty = _port_grads(RenderPipeline(f, opp, (H, W), shading=True,
                                       boost=3.0, cap=CAP, ablate=""),
                        v_ndc, attrs, bg, w)
    np.testing.assert_array_equal(empty[0], default[0])
    for a, b in zip(empty[1], default[1]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ablate"):
        RenderPipeline(f, opp, (H, W), ablate="raster")
