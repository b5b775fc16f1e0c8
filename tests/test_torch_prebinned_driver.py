"""Parity of the port's large-F driver with the JAX package's: the host-bin
epoch, the rebin policy and a host-bin checkpoint resumed across the
packages (the render path's bins and pipes: ``tests/test_torch_prebinned.py``;
the two files run on separate workers).

The driver at icosphere-2 in 2 views of 64×128 with step size 0.01, as
``tests/test_prebinned.py``.  The step size is small because the two
packages' gradients agree to about 1e-5, and at step sizes of 0.03 or more
AdamUniform's global scaling amplifies that, and the antialias pixels it
flips, to loss differences of 1e-3 within a few steps on the traced path
alone.

Tolerances: driver losses rtol 1e-4 and final vertices rtol 1e-3, as
``tests/test_prebinned.py`` holds the JAX driver's host-bin run to its
traced one.
"""
import importlib

import numpy as np
import pytest
import torch

from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene

from largesteps_torch.driver import optimize_shape

RES = (64, 128)


DRIVER = {"steps": 4, "step_size": 0.01, "lambda": 19.0, "boost": 3,
          "solver": "Cholesky"}
HOST = {"host_bin_faces": 1, "rebin_every": 2, "rebin_margin": 4.0}
AUTO = {"host_bin_faces": 1, "rebin_every": 3, "rebin_auto": True,
        "rebin_margin": 4.0}


@pytest.fixture(scope="module")
def driver_scene():
    s = make_scene(source=("icosphere", 2), target=("gourd", 2), n_views=2,
                   res=128)
    s["res_y"], s["res_x"] = RES
    return s


@pytest.fixture(scope="module")
def traced_run(driver_scene):
    """The port's run on traced bins."""
    return optimize_shape(driver_scene, DRIVER, device="cpu")


@pytest.fixture(scope="module")
def jax_runs(driver_scene, tmp_path_factory):
    """The JAX driver's host-bin runs, and a 2-step one that checkpoints."""
    ck = str(tmp_path_factory.mktemp("ck") / "jax_host.npz")
    return {"host": j_optimize_shape(driver_scene, {**DRIVER, **HOST}),
            "auto": j_optimize_shape(driver_scene, {**DRIVER, **AUTO}),
            "ck": (j_optimize_shape(driver_scene, {
                **DRIVER, **HOST, "steps": 2, "checkpoint_every": 2,
                "checkpoint_path": ck}), ck)}


@pytest.mark.parametrize("kind", ["host", "auto"])
def test_driver_rebins_match_jax(driver_scene, jax_runs, traced_run, kind):
    """host: every 2 steps; auto: every 3 steps or on displacement.  The
    port's run against the JAX package's, and against its own traced-bin
    run.  The rebin counts of the auto run may differ: the JAX driver reads
    a step's displacement once the step has run, which on the CPU depends
    on its asynchronous dispatch; the port's steps on the CPU have all run
    when the host reads them."""
    extra = HOST if kind == "host" else AUTO
    got = optimize_shape(driver_scene, {**DRIVER, **extra}, device="cpu")
    want = jax_runs[kind]
    assert got["prof"]["rebin_n"] >= 1 and want["prof"]["rebin_n"] >= 1
    if kind == "host":
        assert got["prof"]["rebin_n"] == want["prof"]["rebin_n"] == 1
    np.testing.assert_allclose(got["losses"][:, 0], want["losses"][:, 0],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["v_final"], want["v_final"], rtol=1e-3,
                               atol=1e-5)
    traced = traced_run
    assert traced["prof"]["rebin_n"] == 0
    np.testing.assert_allclose(got["losses"][:, 0], traced["losses"][:, 0],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["v_final"], traced["v_final"], rtol=1e-3,
                               atol=1e-5)
    assert 0.0 < got["prof"]["max_window_disp_px"] < 2.0


def test_host_bin_checkpoint_resumes_across_packages(driver_scene, jax_runs):
    """A JAX host-bin run checkpoints after 2 steps; the port resumes it,
    re-binning from the restored vertices, and its first loss matches the
    JAX run's third."""
    first, ck = jax_runs["ck"]
    np.testing.assert_allclose(first["losses"],
                               jax_runs["host"]["losses"][:2], rtol=1e-6)
    got = optimize_shape(driver_scene, {**DRIVER, **HOST, "steps": 3,
                                        "resume": ck}, device="cpu")
    assert got["losses"].shape == (1, 2)
    np.testing.assert_allclose(got["losses"][0, 0],
                               jax_runs["host"]["losses"][2, 0], rtol=1e-4)


@pytest.mark.parametrize("disps,due", [([1.0, 1.0, 5.0], False),
                                        ([1.0, 5.0, 1.0], True)])
def test_rebin_due_lags_one_step(driver_scene, disps, due):
    """The auto rule reads the displacement of every queued step but the
    last (margin 4 px: due past 2 px), whether or not that step has run,
    so that the rebin steps do not depend on the host's timing; the last
    step's waits in the queue for the next decision."""
    drv = importlib.import_module("largesteps_torch.driver.optimize_shape")
    p = {**drv.default_params(), **DRIVER, "host_bin_faces": 1,
         "rebin_every": 0, "rebin_auto": True, "rebin_margin": 4.0}
    bins = drv._prepare(driver_scene, p, torch.device("cpu")).st.bins
    bins.disp_q.extend((torch.tensor(d), None) for d in disps)
    assert bins.due(len(disps)) == due
    assert [float(d) for d, _ in bins.disp_q] == disps[-1:]
    assert bins.max_window_disp == max(disps[:-1])


def test_rebin_grows_cap_on_overflow(driver_scene):
    """A device rebin whose occupancy passed the cap sends the next rebin
    to the host, which grows the cap and keeps the face-slot width."""
    drv = importlib.import_module("largesteps_torch.driver.optimize_shape")
    p = {**drv.default_params(), **DRIVER, **HOST}
    run = drv._prepare(driver_scene, p, torch.device("cpu"))
    st, bins = run.st, run.st.bins
    assert bins is not None and bins.device_ok
    assert not bins.overflowed()                   # nothing pending
    bins.pending_occ = (torch.tensor(bins.cap), None)
    assert not bins.overflowed() and bins.pending_occ is None
    bins.pending_occ = (torch.tensor(bins.cap + 1), None)
    with pytest.warns(UserWarning, match="growing"):
        assert bins.overflowed()
    fit, K = bins.cap, bins.tensors[2].shape[-1]
    bins.cap = 32
    bins.rebin_host(st.v_unique[st.duplicate_idx])
    assert bins.cap == fit and bins.tensors[0].shape[-1] == fit
    assert bins.tensors[2].shape[-1] == K
    assert int(bins.tensors[1].max()) <= fit


def test_host_bins_retry_once_at_the_cap_that_fits(driver_scene):
    """Host bins asked at a cap they overflow come at the cap that fits,
    the bins made with no cap; a wider face→slot width is kept only where
    the bins keep the cap asked for, and the inverse is padded with its
    sentinel T·cap."""
    from largesteps_torch.driver.bins import K, host_bins
    drv = importlib.import_module("largesteps_torch.driver.optimize_shape")
    run = drv._prepare(driver_scene, {**drv.default_params(), **DRIVER,
                                      **HOST}, torch.device("cpu"))
    st, r = run.st, run.renderer
    v = st.v_unique[st.duplicate_idx]
    fit, occ, cap, sxy, spans = host_bins(r, v, st.topology, 4.0)
    assert occ > 8 and fit[2].shape[-1] == K
    small = host_bins(r, v, st.topology, 4.0, cap=8, k=K + 2)
    assert small[1:3] == (occ, cap) and small[4] == spans
    np.testing.assert_array_equal(small[3], sxy)
    assert all(torch.equal(a, b) for a, b in zip(small[0], fit))
    kept = host_bins(r, v, st.topology, 4.0, cap=cap, k=K + 2)[0]
    assert kept[2].shape[-1] == K + 2
    assert torch.equal(kept[2][..., :K], fit[2])
    assert bool((kept[2][..., K:] == fit[0].shape[1] * cap).all())
