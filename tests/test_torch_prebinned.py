"""Parity of the port's large-F render path with the JAX package's: host and
device bins, ``setup_from_bins``, the prebinned and camera-sequential pipes
(the driver's host-bin epoch and rebin policy:
``tests/test_torch_prebinned_driver.py``).

Sizes as ``tests/test_prebinned.py``: icosphere-3 in 2 views of 64×128,
caps 640 and 1280 (the JAX kernels in interpret mode).

Tolerances: bins, counts, face slots, spans and records exact (integers and
the same float operations); images 1e-5 absolute and gradients 1e-4 × max|g|,
as the JAX kernels meet against their dense oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from largesteps_tpu.io.synth import make_scene
from largesteps_tpu.ops.normals import (compute_face_normals as j_fn,
                                        compute_vertex_normals as j_vn)
from largesteps_tpu.render import pallas_core as pc
from largesteps_tpu.render.camera import project as j_project
from largesteps_tpu.render.renderer import (Renderer as JRenderer,
                                            Topology as JTopology)
from largesteps_tpu.render.sh import sh_eval as j_sh_eval

from largesteps_torch.render import pipeline as tp
from largesteps_torch.render.renderer import (Renderer, Topology,
                                              batched_bytes)

T = lambda a: torch.as_tensor(np.array(a))
N = lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
RES = (64, 128)
CAPS = (640, 1280)


@pytest.fixture(scope="module")
def scene():
    """The JAX package's projected vertices and SH attributes of the
    source mesh, as numpy, and its faces and adjacency."""
    s = make_scene(source=("icosphere", 3), target=("gourd", 3),
                   n_views=2, res=128)
    s["res_y"], s["res_x"] = RES
    r = JRenderer(s, shading=True, boost=3)
    v = jnp.asarray(s["mesh-source"]["vertices"])
    f = s["mesh-source"]["faces"]
    topo = JTopology(f)
    attrs = j_sh_eval(r.sh_M, j_vn(v, f, j_fn(v, f))) / np.pi
    return {"v_ndc": np.asarray(j_project(v, r.mvps)),
            "attrs": np.asarray(attrs), "bg": np.asarray(r.bgs),
            "faces": f, "opp": topo.opp}


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


@pytest.mark.parametrize("margin", [0.0, 4.0])
def test_host_bins_match_jax(scene, margin):
    want = pc.bin_triangles_host(scene["v_ndc"], scene["faces"], RES,
                                 cap=CAPS[0], margin=margin,
                                 return_slots=True, return_spans=True)
    got = tp.bin_triangles_host(scene["v_ndc"], scene["faces"], RES,
                                cap=CAPS[0], margin=margin,
                                return_slots=True, return_spans=True)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]
    assert want[3] > 100                      # bins of real occupancy


@pytest.mark.parametrize("cull", [False, True])
def test_device_bins_match_jax(scene, cull):
    want = pc.bin_triangles_device(jnp.asarray(scene["v_ndc"]),
                                   scene["faces"], RES, CAPS[1], margin=2.0,
                                   cull=cull)
    got = tp.bin_triangles_device(T(scene["v_ndc"]),
                                  T(scene["faces"].astype(np.int64)), RES,
                                  CAPS[1], margin=2.0, cull=cull)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert int(got[3]) == int(want[3])


def test_setup_from_bins_matches_jax(scene):
    bins, _, _ = tp.bin_triangles_host(scene["v_ndc"], scene["faces"], RES,
                                       cap=CAPS[0], margin=2.0)
    f32 = scene["faces"].astype(np.int64)
    opp = scene["opp"].astype(np.int64)
    rfb, rbb = tp.setup_from_bins(T(scene["v_ndc"]), T(f32),
                                  T(scene["attrs"]), T(opp),
                                  T(bins.astype(np.int64)), *RES)
    for c in range(bins.shape[0]):
        jf, jb = pc.setup_from_bins(jnp.asarray(scene["v_ndc"][c]),
                                    scene["faces"], jnp.asarray(
                                        scene["attrs"]), scene["opp"],
                                    jnp.asarray(bins[c]), *RES)
        np.testing.assert_array_equal(N(rfb[c]), np.asarray(jf))
        np.testing.assert_array_equal(N(rbb[c]), np.asarray(jb))
    _, rbb_only = tp.setup_from_bins(T(scene["v_ndc"]), T(f32),
                                     T(scene["attrs"]), T(opp),
                                     T(bins.astype(np.int64)), *RES,
                                     need_fwd=False)
    assert torch.equal(rbb_only, rbb)


def _device_bins(scene, cap):
    out = tp.bin_triangles_device(T(scene["v_ndc"]),
                                  T(scene["faces"].astype(np.int64)), RES,
                                  cap, margin=2.0)
    return out[:3]


def _run_port(pipe, scene, binned):
    v = T(scene["v_ndc"]).requires_grad_(True)
    a = T(scene["attrs"]).requires_grad_(True)
    out = pipe(v, a, T(scene["bg"]), *binned)
    w = np.random.default_rng(0).normal(size=out.shape).astype(np.float32)
    (T(w) * out).sum().backward()
    return N(out), N(v.grad), N(a.grad), w


def _run_jax(pipe, scene, binned, w):
    args = [jnp.asarray(b.numpy()) for b in binned]
    bg = jnp.asarray(scene["bg"])
    f = lambda v, a: (jnp.asarray(w) * pipe(v, a, bg, *args)).sum()
    v, a = jnp.asarray(scene["v_ndc"]), jnp.asarray(scene["attrs"])
    gv, ga = jax.grad(f, argnums=(0, 1))(v, a)
    return np.asarray(pipe(v, a, bg, *args)), np.asarray(gv), np.asarray(ga)


def _assert_close(got, want):
    assert np.max(np.abs(got[0] - want[0])) < 1e-5
    assert _max_rel(got[1], want[1]) < 1e-4
    assert _max_rel(got[2], want[2]) < 1e-4


@pytest.mark.parametrize("big", [False, True], ids=["batched", "big"])
@pytest.mark.parametrize("slots", [False, True], ids=["faces", "slots"])
def test_prebinned_pipes_match_jax(scene, big, slots):
    """The batched prebinned pipe at cap 640, the camera-sequential one at
    cap 1280 (past the JAX kernels' unrolled range), each with the face
    scatter and with the slot gather, against their JAX counterparts."""
    cap = CAPS[big]
    binned = _device_bins(scene, cap)
    if not slots:
        binned = binned[:2]
    K = int(binned[2].shape[-1]) if slots else None
    args = (scene["faces"], scene["opp"], RES)
    kw = {"shading": True, "boost": 3.0, "cap": cap, "slots_k": K}
    if big:
        tpipe = tp.RenderPipelineBig(*args, **kw)
        jpipe = pc.make_render_pipeline_big(*args, **kw)
    else:
        tpipe = tp.RenderPipeline(*args, prebinned=True, **kw)
        jpipe = pc.make_render_pipeline(*args, prebinned=True, **kw)
    got = _run_port(tpipe, scene, binned)
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[1]).max() > 0.0
    _assert_close(got, _run_jax(jpipe, scene, binned, got[3]))


def test_batched_matches_camera_sequential(scene):
    """The two prebinned pipes of the port on the same host bins, and the
    batched one against the traced-binning pipe."""
    cap = CAPS[1]
    bins, counts, fslots, _ = tp.bin_triangles_host(
        scene["v_ndc"], scene["faces"], RES, cap=cap, margin=2.0,
        return_slots=True)
    binned = (T(bins.astype(np.int64)), T(counts), T(fslots.astype(np.int64)))
    args = (scene["faces"], scene["opp"], RES)
    K = fslots.shape[-1]
    batched = _run_port(tp.RenderPipeline(*args, boost=3.0, cap=cap,
                                          prebinned=True, slots_k=K),
                        scene, binned)
    big = _run_port(tp.RenderPipelineBig(*args, boost=3.0, cap=cap,
                                         slots_k=K), scene, binned)
    traced = _run_port(tp.RenderPipeline(*args, boost=3.0, cap=CAPS[0]),
                       scene, ())
    _assert_close(big[:3], batched[:3])
    _assert_close(batched[:3], traced[:3])


def test_renderer_picks_pipe_by_bytes(scene, monkeypatch):
    """``render(bins=)`` takes the batched pipe while its working set fits
    ``BATCHED_SHARE`` of the device's memory, the camera-sequential one past
    it; both render the same image."""
    from largesteps_torch.render import renderer as rmod
    s = make_scene(source=("icosphere", 3), target=("gourd", 3), n_views=2,
                   res=128)
    s["res_y"], s["res_x"] = RES
    r = Renderer(s, shading=True, boost=3, device="cpu")
    topo = Topology(s["mesh-source"]["faces"])
    v = T(s["mesh-source"]["vertices"])
    n = T(np.random.default_rng(0).normal(size=v.shape).astype(np.float32))
    binned = _device_bins(scene, CAPS[0])
    # 2 views × 2 tiles × 640 slots × 122 floats + 2 × 2 × 1,280 faces × 32
    assert batched_bytes(2, 2, CAPS[0], topo.n_faces) == 4 * (
        2 * 2 * 640 * 122 + 2 * 2 * 1280 * 32)
    assert not r.camera_sequential(CAPS[0], topo.n_faces)
    img = r.render(v, n, topo, bins=binned)
    monkeypatch.setattr(rmod, "BATCHED_SHARE", 0.0)
    assert r.camera_sequential(CAPS[0], topo.n_faces)
    img_big = r.render(v, n, topo, bins=binned)
    assert sorted(type(p).__name__ for p in topo._pipe_cache.values()) == [
        "RenderPipeline", "RenderPipelineBig"]
    assert float((img_big - img).abs().max()) < 1e-5
