"""The port's mesh pictures and figure drawing against the JAX package's.

``largesteps_torch.vis.render_mesh_image`` against ``largesteps_tpu.vis``'s
on an icosphere-2 in one view, with the wireframe and a highlight: at 128²
both take their tile path (JAX's Pallas kernels in interpret mode), where
JAX's ``raster_fwd_pallas`` gathers its colour planes through a bf16
one-hot product (up to 4.3e-5 off the float32 values: ROADMAP Queue 3, on
the JAX side), so the bar is 1e-4; at 64² both take the dense path, 1e-5.
The wireframe and highlight masks (read off each package's images against
its plain render) are exact.  ``self_intersections``' face lists equal
JAX's.  The seven figures are drawn in-process on the CPU from fabricated
experiment files, as ``tests/test_figures.py`` fabricates them for the JAX
scripts, and each PNG is held against the one JAX's
``figures/<exp>/figure.py`` draws from the same files.
"""
import csv
import os
import runpy
import sys

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from largesteps_tpu import vis as jvis
from largesteps_torch import vis
from largesteps_torch.figures import draw
from largesteps_torch.io.ply import write_ply
from largesteps_torch.ops.shapes import icosphere

RED = np.array([1.0, 0.1, 0.1])
FIGURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "figures")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: beside the suite's other test
    processes, runs of many small tensor operations crawl on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    v, f = icosphere(2)
    return (v * np.array([1.0, 0.8, 0.9], np.float32)).astype(np.float32), f


@pytest.mark.parametrize("res,tol", [(128, 1e-4), (64, 1e-5)])
def test_render_mesh_image_matches_jax(mesh, res, tol):
    v, f = mesh
    hl = np.arange(0, len(f), 7)
    kw = dict(res=res, wireframe=True, highlight_faces=hl)
    got = {"jax": (jvis.render_mesh_image(v, f, res=res),
                   jvis.render_mesh_image(v, f, **kw)),
           "torch": (vis.render_mesh_image(v, f, res=res, device="cpu"),
                     vis.render_mesh_image(v, f, device="cpu", **kw))}
    for (a, b) in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape == (res, res, 3)
        assert np.abs(a - b).max() < tol
    masks = {k: (np.all(w == RED, axis=-1),
                 np.any(w != p, axis=-1) & ~np.all(w == RED, axis=-1))
             for k, (p, w) in got.items()}
    for a, b in zip(masks["torch"], masks["jax"]):
        assert a.any() and np.array_equal(a, b)
    # render_panel's own masks are the pixels it drew
    img, edge, hmask, r = vis.render_panel(v, f, device="cpu", **kw)
    assert np.array_equal(hmask, masks["torch"][0])
    assert np.array_equal(edge & ~hmask, masks["torch"][1])
    assert r.backend == ("tiles" if res % 128 == 0 else "dense")


def test_self_intersections_match_jax():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.2, 0.2, -0.5],
                  [0.2, 0.2, 0.5], [0.8, 0.1, 0], [5, 5, 5], [6, 5, 5],
                  [5, 6, 5]], np.float64)
    f = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    assert vis.self_intersections(v, f) == jvis.self_intersections(v, f) \
        == [0, 1]
    sv, sf = icosphere(2)
    assert vis.self_intersections(sv, sf) == jvis.self_intersections(sv, sf) \
        == []


def _write_loss(path, n=80):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["iteration", "im_loss", "reg_loss"])
        for i in range(n):
            w.writerow([i, 1.0 / (i + 1), 0.01 / (i + 1)])


def _write_metrics(path, h=0.05):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["hausdorff", "iters", "wall_time_s", "iters_per_s"])
        w.writerow([h, 80, 10.0, 8.0])


# the experiments' files (tests/test_figures.py's cases), with the first
# leg's final mesh where the figure draws mesh panels; and the figure's
# outputs
CASES = {
    "comparison": (["suzanne_ours", "suzanne_lapreg", "suzanne_bilapreg"],
                   ["figure.png", "meshes.png"]),
    "viewpoints": (["views_1_ours", "views_4_ours", "views_4_reg"],
                   ["figure.png"]),
    "influence": (["alpha_0", "alpha_0.5", "alpha_0.99"], ["figure.png"]),
    "reg_fail": (["ours", "reg_1", "reg_400"], ["figure.png", "meshes.png"]),
    "multiscale": (["multiscale"], ["figure.png", "final_mesh.png"]),
    "remeshing": (["reg", "base", "remesh_middle"], ["figure.png"]),
    "teaser": (["ours", "ours_remesh", "reg", "naive"],
               ["figure.png", "meshes.png"]),
}


def _fabricate(d, names, with_mesh):
    d.mkdir(parents=True)
    for i, name in enumerate(names):
        _write_loss(d / f"{name}_loss.csv")
        _write_metrics(d / f"{name}_metrics.csv", 0.05 + 0.01 * i)
    if with_mesh:            # one final mesh: a panel costs a render
        write_ply(str(d / f"{names[0]}_final.ply"), *icosphere(1))


@pytest.mark.parametrize("exp", sorted(CASES))
def test_draw_figure(exp, tmp_path, monkeypatch):
    """The port's drawing against JAX's ``figures/<exp>/figure.py``, run
    in-process as ``LS_OUTPUT_DIR=<dir> python figures/<exp>/figure.py``
    on a copy of the same files.  Both draw with matplotlib's Agg and the
    same rcParams, so ``figure.png`` (inputs, series, labels, the influence
    figure's halving, the remesh markers) is equal pixel for pixel.  The
    mesh panels come from the two ``vis``, whose images differ by up to
    1e-4 (JAX's bf16 colour gather on its tile path, sums in another
    order): that moves a few pixels of the 8-bit PNG by one level (6 of
    491,400 in ``meshes.png``, 35 of 518,400 in ``final_mesh.png``), so
    those are held to one level in at most 1 pixel in 10³, and to the
    same size (the layout)."""
    names, outputs = CASES[exp]
    for side in ("torch", "jax"):
        _fabricate(tmp_path / side / exp, names, len(outputs) > 1)
    written = draw.draw(exp, out_dir=str(tmp_path / "torch"), device="cpu")
    assert sorted(os.path.basename(p) for p in written) == sorted(outputs)
    monkeypatch.setenv("LS_OUTPUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.delitem(sys.modules, "plotting", raising=False)
    runpy.run_path(os.path.join(FIGURES, exp, "figure.py"),
                   run_name="__main__")
    for name in outputs:
        got = mpimg.imread(str(tmp_path / "torch" / exp / name))
        want = mpimg.imread(str(tmp_path / "jax" / exp / name))
        assert got.shape == want.shape
        if name == "figure.png":
            assert np.array_equal(got, want)
        else:
            levels = np.abs(np.round((got - want) * 255)).max(axis=-1)
            assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3
