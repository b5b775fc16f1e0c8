"""Parity of the port's file I/O and metrics with the JAX package.

PLY and HDR files written by one package are read by the other (ascii and
binary, normals and colours): PLY exactly (float32 written and parsed
back), HDR exactly (both write the same RGBE bytes) and within the RGBE
bound of the image (its pixel's largest channel / 256).  ``save_scene`` →
``load_scene`` across the packages at the tolerances of
``tests/test_end_to_end.py:79-99``.  The Hausdorff distance of the port's
native library against the JAX package's and against the plain numpy
version, 1e-9 relative on three seeded mesh pairs; ``inf`` on non-finite
vertices; a library that does not build raises.
"""
import functools
import os
import shutil

import numpy as np
import pytest

from largesteps_tpu import metrics as j_metrics
from largesteps_tpu.io.hdr import read_hdr as j_read_hdr, write_hdr as j_write_hdr
from largesteps_tpu.io.ply import read_ply as j_read_ply, write_ply as j_write_ply
from largesteps_tpu.io.synth import save_scene as j_save_scene
from largesteps_tpu.io.xml_scene import load_scene as j_load_scene
from largesteps_tpu.ops import shapes as j_shapes

from largesteps_torch import io, metrics
from largesteps_torch.io.synth import make_scene
from largesteps_torch.native import build

REL = 1e-9          # the Hausdorff distances: double precision throughout

PLY_WRITERS = {"jax": j_write_ply, "torch": io.write_ply}
PLY_READERS = {"jax": j_read_ply, "torch": io.read_ply}
HDR_WRITERS = {"jax": j_write_hdr, "torch": io.write_hdr}
HDR_READERS = {"jax": j_read_hdr, "torch": io.read_hdr}


@pytest.mark.parametrize("ascii_", [False, True])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_ply_across_packages(tmp_path, writer, reader, ascii_):
    v, f = j_shapes.icosphere(2)
    rng = np.random.default_rng(0)
    n = rng.normal(size=v.shape).astype(np.float32)
    c = rng.integers(0, 256, v.shape).astype(np.uint8)
    path = str(tmp_path / "mesh.ply")
    PLY_WRITERS[writer](path, v, f, normals=n, colors=c, ascii_=ascii_)
    out = PLY_READERS[reader](path)
    same = PLY_READERS[writer](path)
    np.testing.assert_array_equal(out["vertices"], v.astype(np.float32))
    np.testing.assert_array_equal(out["faces"], f)
    np.testing.assert_array_equal(out["normals"], n)
    np.testing.assert_array_equal(out["colors"], c)
    for k in out:
        np.testing.assert_array_equal(out[k], same[k])
        assert out[k].dtype == same[k].dtype


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_hdr_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(2)
    img = (rng.random((17, 33, 3)) * 10).astype(np.float32)
    path = str(tmp_path / "env.hdr")
    HDR_WRITERS[writer](path, img)
    out = HDR_READERS[reader](path)
    np.testing.assert_array_equal(out, HDR_READERS[writer](path))
    bound = img.max(axis=-1, keepdims=True) / 256 + 1e-6
    assert out.shape == img.shape and (np.abs(out - img) <= bound).all()
    other = str(tmp_path / "other.hdr")
    HDR_WRITERS[reader](other, img)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,loader", [(io.save_scene, j_load_scene),
                                           (j_save_scene, io.load_scene)])
def test_save_scene_load_scene_across_packages(tmp_path, writer, loader):
    scene = make_scene(source=("icosphere", 1), target=("gourd", 1),
                       n_views=3, res=32)
    loaded = loader(writer(scene, str(tmp_path), "roundtrip"))
    assert loaded["res_x"] == scene["res_x"]
    assert len(loaded["view_mats"]) == 3
    for m in ("mesh-source", "mesh-target"):
        np.testing.assert_allclose(loaded[m]["vertices"],
                                   scene[m]["vertices"], atol=1e-6)
        np.testing.assert_array_equal(loaded[m]["faces"], scene[m]["faces"])
    for got, want in zip(loaded["view_mats"], scene["view_mats"]):
        np.testing.assert_allclose(got, want, atol=2e-5)
    env0 = scene["envmap"][..., :3]
    env1 = loaded["envmap"][..., :3]
    bound = env0.max(axis=-1, keepdims=True) / 256 + 1e-6
    assert (np.abs(env1 - env0) <= bound).all()


def _pair(seed):
    """A seeded mesh pair: a jittered icosphere-2 and a target shape."""
    rng = np.random.default_rng(seed)
    va, fa = j_shapes.icosphere(2)
    va = va + rng.normal(scale=0.05, size=va.shape)
    target = [("gourd", 2), ("torus", 10), ("supershape", 1)][seed]
    vb, fb = getattr(j_shapes, target[0])(target[1])
    vb = vb * rng.uniform(0.7, 1.3)
    return (np.asarray(va, np.float64), np.asarray(fa, np.int32),
            np.asarray(vb, np.float64), np.asarray(fb, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hausdorff_native_against_jax_and_numpy(seed):
    va, fa, vb, fb = _pair(seed)
    j_metrics._load()           # the JAX package's native library, not its
                                # numpy fallback
    for a, fa_, b, fb_ in ((va, fa, vb, fb), (vb, fb, va, fa)):
        got = metrics.hausdorff(a, fa_, b, fb_)
        assert got > 0
        np.testing.assert_allclose(got, j_metrics.hausdorff(a, fa_, b, fb_),
                                   rtol=REL)
        np.testing.assert_allclose(got, metrics._hausdorff_numpy(a, b, fb_),
                                   rtol=REL)
    np.testing.assert_allclose(metrics.symmetric_hausdorff(va, fa, vb, fb),
                               j_metrics.symmetric_hausdorff(va, fa, vb, fb),
                               rtol=REL)


def test_jax_numpy_hausdorff_misses_points_past_an_edge():
    """The JAX package's numpy fallback clips the two barycentrics of a
    point's projection apart, so a projection past a triangle's third edge
    counts as on the triangle: it gives a distance below the true one
    (ROADMAP.md Queue 3).  The port's plain version keeps such a projection
    out and agrees with both native libraries."""
    va, fa = j_shapes.icosphere(2)
    vb, fb = j_shapes.gourd(2)
    va, vb = np.asarray(va, np.float64), np.asarray(vb, np.float64)
    exact = metrics.hausdorff(vb, fb, va, fa)
    np.testing.assert_allclose(metrics._hausdorff_numpy(vb, va, fa), exact,
                               rtol=REL)
    assert j_metrics._hausdorff_numpy(vb, va, fa) < (1 - 1e-3) * exact


def test_symmetric_hausdorff_inf_on_nan():
    va, fa, vb, fb = _pair(0)
    bad = va.copy()
    bad[3, 1] = np.nan
    assert metrics.symmetric_hausdorff(bad, fa, vb, fb) == float("inf")
    assert metrics.symmetric_hausdorff(va, fa, bad, fa) == float("inf")
    bad[3, 1] = np.inf
    assert metrics.symmetric_hausdorff(bad, fa, vb, fb) == float("inf")


def test_hausdorff_refuses_what_the_library_would_misread():
    va, fa, vb, fb = _pair(0)
    for bad in (fb + len(vb), fb - len(vb), fb[:0], fb[:, :2]):
        with pytest.raises(ValueError):
            metrics.hausdorff(va, fa, vb, bad)
    with pytest.raises(ValueError):
        metrics.hausdorff(va[:, :2], fa, vb, fb)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A library that does not compile raises; hausdorff does not fall
    back to the numpy version."""
    src = tmp_path / "src"
    src.mkdir()
    for name in build.SOURCES + build.HEADERS:
        shutil.copy(os.path.join(os.path.dirname(build.__file__), name), src)
    with open(src / "hausdorff.cpp", "a") as fh:
        fh.write("\nthis is not C++;\n")
    broken = functools.partial(build.lib_path, src_dir=str(src),
                               build_dir=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="failed"):
        broken()
    monkeypatch.setattr(build, "lib_path", broken)
    monkeypatch.setattr(metrics, "_lib", None)
    va, fa, vb, fb = _pair(0)
    with pytest.raises(RuntimeError, match="failed"):
        metrics.hausdorff(va, fa, vb, fb)
    assert not os.listdir(tmp_path / "out")     # no half-written library
