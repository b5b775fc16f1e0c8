"""The port's span recorder (``largesteps_torch/spans.py``) in the driver.

The driver at icosphere-2 in 2 views of 64×128 on host bins
(``host_bin_faces`` 1, ``rebin_every`` 2, at most one step queued, the
divergence check every 2 steps), so the prebinned pipe, the rebins and the
host waits all run.  On the CPU a span has host times only; its CUDA events
are held on the card by ``tests/test_torch_gpu.py``.  The recorder reads
events only after the driver's own waits: a fake event below fails any
read of one that has not run and any wait on one.
"""
import importlib
import weakref

import numpy as np
import pytest
import torch

from largesteps_torch import spans
from largesteps_torch.core.banded import BandedSolver
from largesteps_torch.core.geometry import compute_matrix
from largesteps_torch.driver import optimize_shape
from largesteps_torch.io.synth import make_scene
from largesteps_torch.ops.mesh import remove_duplicates

drv = importlib.import_module("largesteps_torch.driver.optimize_shape")

PARAMS = {"steps": 5, "step_size": 0.01, "lambda": 19.0, "boost": 3,
          "host_bin_faces": 1, "rebin_every": 2, "max_inflight": 1,
          "nan_check_every": 2}
STEP_SPANS = {"solve", "normals", "render", "pipe_setup", "loss",
              "backward", "adjoint_solve", "pipe_scatter", "optimizer",
              "displacement", "rebin", "host_wait"}
PARENT = {"adjoint_solve": {"backward"},
          "pipe_setup": {"render", "setup.reference"},
          "pipe_scatter": {"backward"}, "setup.reference": {"setup"},
          "setup.topology": {"setup"}, "setup.bins": {"setup"},
          "setup.matrix": {"setup"}, "setup.factor": {"setup"},
          "setup": {None}, "step": {None}, "host_wait": {None, "rebin", "setup.reference",
                                         "setup.topology", "setup.bins",
                                         "setup"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    s = make_scene(source=("icosphere", 2), target=("gourd", 2), n_views=2,
                   res=128)
    s["res_y"], s["res_x"] = 64, 128
    return s


@pytest.fixture(scope="module")
def runs(scene):
    return {"off": optimize_shape(scene, PARAMS, device="cpu"),
            "on": optimize_shape(scene, {**PARAMS, "trace": True},
                                 device="cpu")}


def test_tracing_changes_no_result(runs):
    off, on = runs["off"], runs["on"]
    assert "trace" not in off["prof"] and "trace" in on["prof"]
    assert np.array_equal(off["losses"], on["losses"])
    assert np.array_equal(off["v_final"], on["v_final"])
    assert off["prof"]["rebin_steps"] == on["prof"]["rebin_steps"] == [2, 4]


def test_spans_names_parents_and_steps(runs):
    trace = runs["on"]["prof"]["trace"]
    recs = trace["spans"]
    names = {s["name"] for s in recs}
    assert STEP_SPANS <= names
    for s in recs:
        if s["name"] in PARENT:
            assert s["parent"] in PARENT[s["name"]], s
        if s["name"] in STEP_SPANS - {"host_wait"} \
                and s["parent"] != "setup.reference":
            assert s["parent"] in (None, "step", "render", "backward"), s
            assert s["step"] in range(PARAMS["steps"]), s
        if s["name"].startswith("setup"):
            assert s["step"] is None, s
        pid = s["parent_id"]
        assert (pid is None) == (s["parent"] is None)
        if pid is not None:
            parent = recs[pid]
            assert parent["name"] == s["parent"]
            assert parent["host"][0] <= s["host"][0] <= s["host"][1] \
                <= parent["host"][1]
        assert s["stream"] is None          # no events on the CPU
    for k in range(PARAMS["steps"]):
        in_step = [s["name"] for s in recs if s["step"] == k]
        for name in ("solve", "render", "backward", "adjoint_solve",
                     "pipe_setup", "pipe_scatter"):
            assert in_step.count(name) == 1, (k, name)
    assert sorted(s["step"] for s in recs if s["name"] == "rebin") == [2, 4]
    sites = {s["site"] for s in recs if s["name"] == "host_wait"}
    assert {"inflight", "rebin_due", "overflow", "nan_check", "first_step",
            "end", "setup"} <= sites
    waits = trace["host_waits"]
    assert set(waits) == sites
    assert waits["nan_check"]["n"] == 2 and waits["first_step"]["n"] == 1
    assert waits["inflight"]["n"] == PARAMS["steps"] - 1


def test_self_time_within_total(runs):
    total, self_s = {}, {}
    for s in runs["on"]["prof"]["trace"]["spans"]:
        host = s["host"][1] - s["host"][0]
        assert 0.0 <= s["self_s"] <= host + 1e-12, s
        total[s["name"]] = total.get(s["name"], 0.0) + host
        self_s[s["name"]] = self_s.get(s["name"], 0.0) + s["self_s"]
    assert all(self_s[k] <= total[k] + 1e-12 for k in total)
    assert self_s["backward"] < total["backward"]


def test_setup_spans_record_with_tracing_off(scene, runs):
    # the setup's timings are its spans' host seconds, traced or not
    on = runs["on"]["prof"]
    host = {s["name"]: s["host"][1] - s["host"][0]
            for s in on["trace"]["spans"] if s["name"].startswith("setup.")}
    assert on["ref_render_s"] == host["setup.reference"]
    assert on["topology_s"] == host["setup.topology"]
    assert on["host_bins_s"] == host["setup.bins"]
    assert on["factor_s"] >= host["setup.matrix"] + host["setup.factor"]
    rec = spans.Recorder("cpu")
    p = {**drv.default_params(), **PARAMS}
    with spans.recording(rec):
        with spans.setup_span("setup"):
            drv._prepare(scene, p, torch.device("cpu"))
    assert not rec.used
    assert [r.name for r in rec.records] == [
        "setup.reference", "setup.topology", "setup.bins", "setup.matrix",
        "setup.factor", "setup"]
    assert all(r.t1 > r.t0 for r in rec.records)


def test_banded_solver_times_rcm_and_factor(scene):
    v = np.asarray(scene["mesh-source"]["vertices"], np.float32)
    f = np.asarray(scene["mesh-source"]["faces"], np.int64)
    v, f = remove_duplicates(v, f)[:2]
    M = compute_matrix(v, f, lambda_=19.0, device="cpu")
    rec = spans.Recorder("cpu")
    with spans.recording(rec):
        BandedSolver(M)
    assert [r.name for r in rec.records] == ["setup.rcm", "setup.factor"]


def test_rebin_routes_count_each_rebin(scene, runs):
    for res in runs.values():
        routes = res["prof"]["rebin_routes"]
        assert sum(routes.values()) == res["prof"]["rebin_n"] == 2
        assert routes["device"] == 2
    p = {**drv.default_params(), **PARAMS, "rebin_every": 1}
    run = drv._prepare(scene, p, torch.device("cpu"))
    st, prof = run.st, {}
    rebins = drv._Rebins(st, p, run.renderer, run.theta, 0, prof)
    v = drv._solved(st, run.theta, p)
    st.pending_occ = (torch.tensor(st.bin_cap + 1), None)
    with pytest.warns(UserWarning, match="growing"):
        rebins.before(1, v)
    st.device_rebin_ok = False
    rebins.before(2, v)
    st.device_rebin_ok = True
    rebins.before(3, v)
    assert prof["rebin_routes"] == {"device": 1, "host_spans": 1,
                                    "host_overflow": 1}
    assert prof["rebin_n"] == 3


@pytest.mark.parametrize("share", [None, 0.0], ids=["batched", "big"])
def test_slot_sums_are_freed_before_the_scatter(scene, monkeypatch, share):
    """``pipe_scatter`` chains the per-slot sums and frees them before the
    scatter runs, as when the chain ran inside the kernels' call: the
    large-F step's peak memory stays where it was.  ``share`` 0 sends the
    driver to the camera-sequential pipe."""
    from largesteps_torch.render import pipeline, renderer
    if share is not None:
        monkeypatch.setattr(renderer, "BATCHED_SHARE", share)
    refs, seen = [], []
    chain, scatter = pipeline.chain_planes, pipeline._scatter

    def chain_spy(dslot, dslot_aa, *args):
        refs[:] = [weakref.ref(dslot), weakref.ref(dslot_aa)]
        return chain(dslot, dslot_aa, *args)

    def scatter_spy(*args):
        seen.append([r() is None for r in refs])
        return scatter(*args)

    monkeypatch.setattr(pipeline, "chain_planes", chain_spy)
    monkeypatch.setattr(pipeline, "_scatter", scatter_spy)
    optimize_shape(scene, {**PARAMS, "steps": 1}, device="cpu")
    assert len(seen) == (1 if share is None else 2)    # cameras
    assert all(all(freed) for freed in seen), seen


class _Event:
    """A CUDA event on a made-up stream: ``done`` is how many recorded
    events the card has run.  Reading one it has not run, or waiting on
    any, fails."""
    created = recorded = done = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.created += 1
        self.seq = None

    def record(self):
        _Event.recorded += 1
        self.seq = _Event.recorded

    def elapsed_time(self, end):
        assert max(self.seq, end.seq) <= _Event.done, "read before it ran"
        return float(end.seq - self.seq)

    def synchronize(self):
        raise AssertionError("the recorder waited")

    query = synchronize


def test_events_are_read_only_after_the_drivers_waits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for k in ("created", "recorded", "done"):
        monkeypatch.setattr(_Event, k, 0)
    rec = spans.Recorder("cuda", always=True)
    inflight, most_unread = 1, 0
    with spans.recording(rec):
        _Event.done = _Event.recorded
        rec.waited()                     # the epoch build's drain
        ends = {}
        for it in range(6):
            rec.step = it
            with spans.span("solve"):
                with spans.span("render"):
                    pass
            with spans.span("backward"):
                with spans.span("host_wait", "nan_check"):
                    pass                 # a host wait records no events
            ends[it] = _Event.recorded
            most_unread = max(most_unread, len(rec._unread))
            if it >= inflight:           # the wait on the step inflight back
                _Event.done = max(_Event.done, ends[it - inflight])
                rec.waited(it - inflight)
        _Event.done = _Event.recorded
        rec.waited()                     # the final drain
    assert most_unread == 3 * (inflight + 1)
    out = rec.export()["spans"]
    timed = [s for s in out if s["name"] != "host_wait"]
    assert all(s["stream"] is not None for s in timed)
    assert all(s["stream"] is None for s in out if s["name"] == "host_wait")
    for s in timed:
        assert s["stream"][0] <= s["stream"][1]
    # read events are recorded again: two anchors and the unread steps'
    assert _Event.created == 2 + 2 * most_unread < _Event.recorded
