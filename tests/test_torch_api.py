"""The port's API ends against the JAX package's.

* ``render_core`` (the unfused rasterize + interpolate with its own
  backward) against ``pallas_core.render_core`` at ``tests/test_pallas.py``'s
  geometry (icosphere-2 in 2 views of 128², cap 256) and bars: ids exact,
  u and v 1e-4, colour 5e-4 (JAX's kernel gathers its colour planes in
  bf16), gradients 1e-4 × max|g|.
* ``SphericalHarmonics`` against JAX's (1e-6 × max|l|).
* ``profiling``: ``roofline``'s fields against its formula at a fixed time,
  ``CHIP_SPECS`` holding the H100 alone and ``chip_smoke.py``'s peaks read
  from it, ``time_fn`` and ``trace``.
* The API ends mapped to port functions that do their work (ROADMAP Queue
  1): JAX's ``camera_sharding`` is ``parallel.sharding.shard_layout`` (each
  rank's camera and row block on a 2 × 2 mesh of gloo ranks, against the
  index map of JAX's sharding on 4 virtual devices) and
  ``host_local_to_global`` is ``gather_images`` (every rank's block back to
  the whole array); ``save_pytree`` / ``load_pytree`` are
  ``driver.checkpoint.state_to_numpy`` / ``state_from_numpy`` (the same
  leaves in the same order).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from largesteps_tpu.core.optimize import adam_uniform
from largesteps_tpu.driver.checkpoint import load_pytree, save_pytree
from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.parallel.sharding import (camera_sharding,
                                              make_mesh as j_make_mesh)
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.antialias import face_adjacency
from largesteps_tpu.render.camera import project
from largesteps_tpu.render.renderer import Renderer as JRenderer
from largesteps_tpu.render.sh import SphericalHarmonics as JSH

from largesteps_torch import profiling
from largesteps_torch.core.optimize import AdamUniform
from largesteps_torch.driver.checkpoint import (state_from_numpy,
                                                state_to_numpy)
from largesteps_torch.io.synth import make_envmap
from largesteps_torch.parallel.distributed import launch
from largesteps_torch.render.sh import SphericalHarmonics
from largesteps_torch.render.tile_raster import make_render_core, render_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 128
CAP = 256
T = lambda a: torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: beside the suite's other test
    processes, runs of many small tensor operations crawl on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geo():
    scene = make_scene(source=("icosphere", 2), target=("gourd", 2),
                       n_views=2, res=H)
    v = jnp.asarray(scene["mesh-source"]["vertices"])
    f = np.asarray(scene["mesh-source"]["faces"], np.int32)
    opp = face_adjacency(f)
    renderer = JRenderer(scene, shading=True, boost=3, backend="xla")
    v_ndc = project(v, renderer.mvps)
    attrs = jax.random.normal(jax.random.PRNGKey(0), (v.shape[0], 3))
    wc = jax.random.normal(jax.random.PRNGKey(1), (2, H, W, 3))
    wu = jax.random.normal(jax.random.PRNGKey(2), (2, H, W, 2))
    # JAX's core once, forward and backward: (rast, slot, color), and the
    # gradients of sum(wc · color) + sum(wu · (u, v))
    (rast, slot, col), vjp = jax.vjp(
        pc.make_render_core(f, opp, (H, W), CAP), v_ndc, attrs)
    grads = vjp((wu_pad(wu), jnp.zeros_like(slot), wc))
    return {"f": f, "opp": opp, "v_ndc": v_ndc, "attrs": attrs, "wc": wc,
            "wu": wu, "out": [np.asarray(x) for x in (rast, slot, col)],
            "grads": [np.asarray(g) for g in grads]}


def wu_pad(wu):
    """The rast cotangent of sum(wu · rast[..., :2])."""
    return jnp.concatenate([wu, jnp.zeros_like(wu)], axis=-1)


def test_render_core_forward_matches_jax(geo):
    f, opp, v_ndc, attrs = (geo[k] for k in ("f", "opp", "v_ndc", "attrs"))
    rast_j, slot_j, col_j = geo["out"]
    rast, slot, col = (x.numpy() for x in render_core(
        T(v_ndc), T(attrs), f, opp, (H, W), CAP))
    m = rast_j[..., 3] > 0
    assert m.any() and np.array_equal(rast[..., 3], rast_j[..., 3])
    assert np.array_equal(slot >= 0, m)
    assert np.abs(np.where(m[..., None], rast[..., :2] - rast_j[..., :2],
                           0)).max() < 1e-4
    assert np.abs(np.where(m[..., None], col - col_j, 0)).max() < 5e-4


def test_render_core_backward_matches_jax(geo):
    f, opp, v_ndc, attrs, wc, wu = (geo[k] for k in (
        "f", "opp", "v_ndc", "attrs", "wc", "wu"))
    gv_j, ga_j = geo["grads"]
    core = make_render_core(f, opp, (H, W), CAP)
    vc = T(v_ndc).requires_grad_(True)
    at = T(attrs).requires_grad_(True)
    rast, _, col = core(vc, at)
    ((T(wc) * col).sum() + (T(wu) * rast[..., :2]).sum()).backward()
    for g, g_j in ((vc.grad.numpy(), gv_j), (at.grad.numpy(), ga_j)):
        assert np.abs(g - g_j).max() < 1e-4 * np.abs(g_j).max()
    # the incidence is built once per op and vertex count
    assert len(core._incidence) == 1
    core(vc, at)[2].sum().backward()
    assert len(core._incidence) == 1


def test_spherical_harmonics_matches_jax():
    env = make_envmap(8, 16)
    n = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    got = SphericalHarmonics(env).eval(T(n)).numpy()
    want = np.asarray(JSH(env).eval(jnp.asarray(n)))
    assert got.shape == (50, 3)
    # M sums the envmap in another order than JAX's: a few ulp apart
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_roofline_fields_follow_the_formula(monkeypatch):
    monkeypatch.setattr(profiling, "time_fn", lambda fn, *a, iters: 2e-3)
    flops, nbytes = 3e9, 5e9
    r = profiling.roofline(lambda: None, flops=flops, bytes_moved=nbytes)
    spec = profiling.CHIP_SPECS["h100"]
    assert r.seconds == 2e-3 and r.flops == flops and r.bytes == nbytes
    assert r.achieved_tflops == pytest.approx(flops / 2e-3 / 1e12)
    assert r.achieved_gbps == pytest.approx(nbytes / 2e-3 / 1e9)
    assert r.flops_fraction == pytest.approx(
        r.achieved_tflops / spec["fp32_tflops"])
    assert r.bandwidth_fraction == pytest.approx(
        r.achieved_gbps / spec["hbm_gbps"])
    # 0.6 flop a byte is below the ridge (67e12 / 3.35e12 = 20)
    assert r.bound == "memory"
    r = profiling.roofline(lambda: None, flops=1e12, bytes_moved=1e9)
    assert r.bound == "compute" and "compute-bound" in str(r)


def test_chip_specs_are_the_h100s_and_chip_smokes():
    assert set(profiling.CHIP_SPECS) == {"h100"}
    assert profiling.CHIP_SPECS["h100"] == {
        "fp32_tflops": 67.0, "bf16_tflops": 989.4, "hbm_gbps": 3350.0}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAK_BYTES == 3.35e12
    assert smoke.PEAK_F32 == 67e12


def test_time_fn_and_trace(tmp_path):
    calls = []
    dt = profiling.time_fn(lambda x: calls.append(x) or torch.ones(3), 1,
                           iters=4, warmup=2)
    assert len(calls) == 6 and dt > 0
    with profiling.trace(str(tmp_path), "t") as path:
        torch.ones(64).sum()
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]


def test_camera_sharding_and_host_local_to_global_are_mapped():
    from test_torch_sharding import layout_gather_rank
    n_cams, res = 4, (64, 128)
    mesh = j_make_mesh(4, sp=2)
    index = camera_sharding(mesh, 4, row_axis=1).devices_indices_map(
        (n_cams, *res, 2))
    ranks = launch(layout_gather_rank, 4, args=(n_cams, res, 2))
    for d in range(2):
        for s in range(2):
            cams, rows = index[mesh.devices[d, s]][:2]
            got = ranks[2 * d + s]
            assert got["row_shards"] == 2 and got["whole"]
            assert got["cams"] == (cams.start, cams.stop)
            assert got["rows"] == (rows.start, rows.stop)


def test_pytree_leaves_are_mapped():
    rng = np.random.default_rng(4)
    theta = {"u": jnp.asarray(rng.normal(size=(6, 3)), jnp.float32),
             "tr": jnp.asarray(rng.normal(size=(1, 3)), jnp.float32)}
    grads = [{k: jnp.asarray(rng.normal(size=a.shape), jnp.float32)
              for k, a in theta.items()} for _ in range(2)]
    tx = adam_uniform(0.01)
    state = tx.init(theta)
    for g in grads:
        _, state = tx.update(g, state)
    j_th, j_opt = save_pytree(theta), save_pytree(state)
    # the port's run of the same two updates' moments (at step size 0,
    # so that theta stays JAX's, whose update is not applied)
    th = {k: T(a).clone().requires_grad_(True) for k, a in theta.items()}
    opt = AdamUniform([th["tr"], th["u"]], lr=0.0)
    for g in grads:
        for k in th:
            th[k].grad = T(g[k]).clone()
        opt.step()
    th_leaves, opt_leaves = state_to_numpy(th, opt)
    assert len(th_leaves) == len(j_th) and len(opt_leaves) == len(j_opt)
    for i, leaf in enumerate(th_leaves):
        np.testing.assert_array_equal(leaf, j_th[f"leaf_{i}"])
    for i, leaf in enumerate(opt_leaves):
        np.testing.assert_allclose(leaf, j_opt[f"leaf_{i}"], rtol=1e-6)
    # and back: the port's leaves rebuild JAX's trees, JAX's the port's
    back = load_pytree({f"leaf_{i}": a for i, a in enumerate(opt_leaves)},
                       state)
    np.testing.assert_allclose(np.asarray(back.g2["u"]),
                               np.asarray(state.g2["u"]), rtol=1e-6)
    th2, load_into = state_from_numpy([j_th["leaf_0"], j_th["leaf_1"]],
                                      [j_opt[f"leaf_{i}"] for i in range(5)],
                                      "cpu")
    opt2 = AdamUniform([th2["tr"], th2["u"]], lr=0.01)
    load_into(opt2)
    np.testing.assert_array_equal(th2["u"].detach().numpy(),
                                  np.asarray(theta["u"]))
    np.testing.assert_array_equal(opt2.state[th2["tr"]]["g1"].numpy(),
                                  j_opt["leaf_1"])
    assert opt2.state[th2["u"]]["count"] == 2
