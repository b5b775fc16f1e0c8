"""Parity of the port's remeshing driver with the JAX package's, and its
own invariants: schedules, checkpoints through a remesh, the old epoch
freed before the new one is built, the figures' remeshing harness.

Scenes are icosphere-2 fitted to gourd-2 in 2 views of 32² (the dense
renderer).  Against JAX (two JAX runs): a remesh at step 0 with ``smooth``
off remeshes the source mesh itself in both packages, so its topology is
equal and its losses agree to rtol 1e-5; a smooth remesh at step 4 runs
on solved vertices that differ in their last bits, and the remesher is
discontinuous in its input, so only its first 4 losses are held to JAX's
(rtol 1e-5) and the rest structurally.  The port against itself (resume,
int against list schedule): exactly, or rtol 1e-5 where a checkpoint's
float32 round trip lies between.
"""
import importlib
import os
import weakref

import numpy as np
import pytest
import torch

from largesteps_tpu.driver import optimize_shape as j_optimize_shape
from largesteps_tpu.io.synth import make_scene as j_make_scene

from largesteps_torch.driver import optimize_shape
from largesteps_torch.driver.checkpoint import load_checkpoint
from largesteps_torch.figures import common, multiscale, remeshing

drv_mod = importlib.import_module("largesteps_torch.driver.optimize_shape")
SMOOTH = {"steps": 10, "remesh": [4], "step_size": 0.05, "lambda": 9.0}
# the remeshing figure's reg leg (Adam on the coordinates) remeshed at 0
COORDS = {"smooth": False, "optimizer": "Adam", "reg": 0.16, "loss": "l1",
          "alpha": 0.95, "boost": 3, "step_size": 1e-2, "steps": 3,
          "remesh": 0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These runs are many small tensor operations: beside other test
    processes on the host's cores, torch's intra-op threads only wait on
    each other (a two-remesh run took 128 s instead of 9 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return j_make_scene(source=("icosphere", 2), target=("gourd", 2),
                        n_views=2, res=32)


@pytest.fixture(scope="module")
def smooth_runs(scene):
    return (j_optimize_shape(scene, dict(SMOOTH)),
            optimize_shape(scene, dict(SMOOTH), device="cpu"))


def test_remesh_at_start_matches_jax(scene):
    full_j = j_optimize_shape(scene, dict(COORDS))
    full_t = optimize_shape(scene, dict(COORDS), device="cpu")
    assert len(full_t["f"]) == len(full_j["f"]) == 2
    for f_t, f_j in zip(full_t["f"], full_j["f"]):
        np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(full_t["f_final"], full_j["f_final"])
    np.testing.assert_allclose(full_t["losses"], full_j["losses"], rtol=1e-5)
    # Adam's near-eps coordinates (tests/test_torch_fit.py): most agree to
    # 1e-5 of the mesh's size, none by more than the steps' total lr
    scale = np.abs(full_j["v_final"]).max()
    d = np.abs(full_t["v_final"] - full_j["v_final"])
    assert (d <= 1e-5 * scale).mean() >= 0.95, (d > 1e-5 * scale).mean()
    assert d.max() <= COORDS["steps"] * COORDS["step_size"] * 0.8


def test_smooth_remesh_schedule(smooth_runs):
    full_j, full_t = smooth_runs
    assert len(full_t["f"]) == 2
    assert full_t["f"][1].shape[0] != full_t["f"][0].shape[0]
    assert np.isfinite(full_t["losses"]).all()
    assert full_t["losses"].shape == (SMOOTH["steps"], 2)
    np.testing.assert_allclose(full_t["losses"][:4], full_j["losses"][:4],
                               rtol=1e-5)
    np.testing.assert_array_equal(full_t["f_final"], full_t["f"][1])
    assert full_t["v_final"].shape[0] == full_t["f"][1].max() + 1
    # the JAX run remeshed too, to a mesh of about the same size
    assert len(full_j["f"]) == 2
    assert abs(len(full_t["f"][1]) / len(full_j["f"][1]) - 1) < 0.1


def test_remesh_record(smooth_runs):
    _, full_t = smooth_runs
    (event,) = full_t["prof"]["remeshes"]
    assert event["it"] == 4
    assert event["faces_before"] == len(full_t["f"][0])
    assert event["faces_after"] == len(full_t["f"][1])
    assert event["faces_after"] > event["faces_before"]
    assert event["verts_after"] == full_t["v_final"].shape[0]
    # the remesher's own thresholds
    assert 0.8 * event["h"] <= event["mean_edge_after"] <= 4 / 3 * event["h"]
    assert event["step_size"] == pytest.approx(0.8 * SMOOTH["step_size"])
    assert event["solver"]["tier"] == "dense_inv"
    assert not event["use_host_bins"] and event["pipe"] == "dense"
    assert set(event["setup"]) == {"topology_s", "host_bins_s", "factor_s"}
    assert event["remesh_s"] >= 0 and event["seconds"] >= event["remesh_s"]
    assert 0 <= event["wall_at"] <= full_t["wall_time"]
    eps = common.epochs(full_t)
    assert [e["steps"] for e in eps] == [4, SMOOTH["steps"] - 4]
    assert [e["faces"] for e in eps] == [len(f) for f in full_t["f"]]
    assert all(e["it_per_s"] > 0 for e in eps)


def test_int_and_list_schedules_alike(scene, smooth_runs):
    _, full_t = smooth_runs
    as_int = optimize_shape(scene, {**SMOOTH, "remesh": 4}, device="cpu")
    np.testing.assert_array_equal(as_int["losses"], full_t["losses"])
    for a, b in zip(as_int["f"], full_t["f"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(as_int["v_final"], full_t["v_final"])


def test_two_remeshes_grow_twice(scene):
    res = optimize_shape(scene, {**SMOOTH, "steps": 5, "remesh": [1, 3]},
                         device="cpu")
    sizes = [len(f) for f in res["f"]]
    assert len(sizes) == 3 and sizes[0] < sizes[1] < sizes[2], sizes
    assert [e["it"] for e in res["prof"]["remeshes"]] == [1, 3]
    assert res["prof"]["remeshes"][1]["step_size"] == pytest.approx(
        0.64 * SMOOTH["step_size"])
    assert np.isfinite(res["losses"]).all()


def test_resume_at_a_scheduled_remesh(scene, tmp_path):
    """A checkpoint written at the step of a remesh holds the pending
    schedule and the old epoch; resumed, the remesh replays and the run
    equals the unbroken one.  A checkpoint written after the remesh holds
    the new epoch and the step size after the factor of 0.8."""
    base = {**SMOOTH, "steps": 6, "remesh": [3]}
    full = optimize_shape(scene, dict(base), device="cpu")

    ck = os.path.join(tmp_path, "ck.npz")
    first = optimize_shape(scene, {**base, "steps": 3, "checkpoint_every": 1,
                                   "checkpoint_path": ck}, device="cpu")
    meta = load_checkpoint(ck)
    assert meta["meta"]["remesh_schedule"] == [3]
    assert meta["meta"]["step"] == 3
    np.testing.assert_array_equal(meta["f_src"], full["f"][0])
    second = optimize_shape(scene, {**base, "resume": ck}, device="cpu")
    np.testing.assert_array_equal(first["losses"], full["losses"][:3])
    np.testing.assert_allclose(second["losses"], full["losses"][3:],
                               rtol=1e-5)
    np.testing.assert_array_equal(second["f_final"], full["f_final"])
    np.testing.assert_allclose(second["v_final"], full["v_final"],
                               rtol=1e-5, atol=1e-6)

    ck2 = os.path.join(tmp_path, "ck2.npz")
    optimize_shape(scene, {**base, "steps": 5, "checkpoint_every": 1,
                           "checkpoint_path": ck2}, device="cpu")
    after = load_checkpoint(ck2)
    assert after["meta"]["remesh_schedule"] == []
    assert after["meta"]["step_size"] == pytest.approx(
        0.8 * base["step_size"])
    np.testing.assert_array_equal(after["f_src"], full["f"][1])
    last = optimize_shape(scene, {**base, "resume": ck2}, device="cpu")
    np.testing.assert_allclose(last["losses"], full["losses"][5:], rtol=1e-5)


def test_old_epoch_freed_before_the_new_one(scene, monkeypatch):
    """Nothing of the old epoch (its state, topology and pipes, solver,
    parameters) is alive when the new epoch is built."""
    build = drv_mod._build_epoch
    refs = []

    def tracked(*args, **kw):
        alive = [name for name, r in refs if r() is not None]
        assert not alive, alive
        st = build(*args, **kw)
        refs.extend([("epoch", weakref.ref(st)),
                     ("topology", weakref.ref(st.topology)),
                     ("solver", weakref.ref(st.solver)),
                     ("structure", weakref.ref(st.M.structure)),
                     ("u", weakref.ref(st.u))])
        return st

    monkeypatch.setattr(drv_mod, "_build_epoch", tracked)
    res = optimize_shape(scene, {**SMOOTH, "steps": 4, "remesh": [1, 2]},
                         device="cpu")
    assert len(res["f"]) == 3


def test_sharding_still_raises(scene):
    with pytest.raises(NotImplementedError, match="sharding"):
        optimize_shape(scene, {"steps": 1, "remesh": 0,
                               "sharding": {"dp": 2}}, device="cpu")


def test_figure_legs_match_jax_experiments():
    """The port's legs carry the JAX experiments' settings
    (figures/remeshing/generate_data.py, figures/multiscale/
    generate_data.py), --quick included."""
    names = [n for n, _ in remeshing.legs()]
    assert names == ["reg", "base", "remesh_middle", "remesh_start"]
    full = dict(remeshing.legs())
    assert [full[n]["steps"] for n in names] == [1890, 1800, 1630, 1500]
    assert [full[n]["remesh"] for n in names] == [-1, -1, 750, 0]
    assert all(p["step_size"] == 1e-2 and p["alpha"] == 0.95
               and p["loss"] == "l1" and p["boost"] == 3
               for p in full.values())
    quick = dict(remeshing.legs(quick=True))
    assert quick["remesh_middle"]["remesh"] == 20
    assert all(p["steps"] == 60 for p in quick.values())
    (_, ms), = multiscale.legs()
    assert ms["remesh"] == [500, 1500, 3000, 4500, 7000, 10000, 12000,
                            14000] and ms["steps"] == 16000
    (_, mq), = multiscale.legs(quick=True)
    assert mq["remesh"] == [40, 80] and mq["steps"] == 120


def test_remeshing_harness_writes_every_leg(tmp_path, monkeypatch):
    """The remeshing figure's four legs through the port's harness (a small
    scene, 3 steps, the middle remesh at step 1) write the JAX harness's
    files."""
    monkeypatch.setitem(common.SCENES, "cranium", dict(
        source=("icosphere", 1), target=("supershape", 2), n_views=2,
        res=32))
    monkeypatch.setattr(common, "OUTPUT_DIR", str(tmp_path))
    for name, params in remeshing.legs(quick=True):
        params = {**params, "steps": 3}
        if params["remesh"] == 20:
            params["remesh"] = 1
        res, d = common.run(name, "cranium", params, "remeshing",
                            device="cpu")
        assert np.isfinite(d) and d > 0
        assert len(res["f"]) == (1 if params["remesh"] < 0 else 2)
        base = os.path.join(tmp_path, "remeshing", name)
        for suffix in ("_final.ply", "_loss.csv", "_metrics.csv"):
            assert os.path.getsize(base + suffix) > 0
