"""The driver's choice between the step's CUDA graph and the eager step,
its counters and spans, and the benchmark's readers of them, on the CPU.

A CUDA graph runs only on the card (``tests/test_torch_gpu.py`` holds a
graphed fit to the eager fit's bits and to its peak memory); here every
run is eager, and the driver must say why: ``prof["graph"]["eager"]``
counts each step under the first reason of :func:`_graph_reason` that
holds.  The last test drives a small traced-bin fit at the bunny leg's
settings through ``optimize_shape`` and holds its first step to the
benchmark's plain reference (``perfbench/reference.py``) by
``perfbench/check.py``, within the ``bunny-views49`` cell's limits.
"""
import contextlib
import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from largesteps_torch.driver import optimize_shape
from largesteps_torch.io.synth import make_scene
from perfbench import check, reference, run as bench

drv = importlib.import_module("largesteps_torch.driver.optimize_shape")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# the bunny leg's settings (perfbench/configs/bunny.json and the traffic
# viewpoints-ours-49v)
BUNNY = {"step_size": 0.01, "boost": 3, "alpha": 0.95, "loss": "l1",
         "smooth": True, "optimizer": "AdamUniform"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return make_scene(source=("icosphere", 2), target=("gourd", 2),
                      n_views=2, res=128)


def _epoch(host_bins=False, tier="dense_inv", mesh=None, backend="tiles",
           smooth=True):
    st = SimpleNamespace(use_host_bins=host_bins,
                         solver=None if tier is None
                         else SimpleNamespace(tier=tier))
    renderer = SimpleNamespace(mesh=mesh, backend=backend)
    return st, {**drv.default_params(), "smooth": smooth}, renderer


@pytest.mark.parametrize("kw,dev,want", [
    ({}, CUDA, None),                                   # the graph
    ({"tier": "banded"}, CUDA, "banded_solver"),        # never captured
    ({"tier": None, "smooth": False}, CUDA, None),      # coordinates
    ({}, CPU, "cpu"),
    ({"host_bins": True}, CUDA, "host_bins"),
    ({"tier": "cg"}, CUDA, "iterative_solver"),
    ({"tier": "amg"}, CUDA, "iterative_solver"),
    ({"tier": "blockamg"}, CUDA, "iterative_solver"),
    ({"tier": "host"}, CUDA, "host_solver"),
    ({"mesh": object()}, CUDA, "sharded"),
    ({"backend": "dense"}, CUDA, "dense"),
    # the first reason that holds is the one counted
    ({"host_bins": True, "tier": "cg"}, CPU, "host_bins"),
    ({"mesh": object(), "host_bins": True}, CPU, "sharded"),
])
def test_graph_reason_by_path(kw, dev, want):
    assert drv._graph_reason(*_epoch(**kw), dev) == want
    assert want is None or want in drv.EAGER_REASONS


@pytest.mark.parametrize("params,reason", [
    ({}, "cpu"),                                        # traced bins
    ({"host_bin_faces": 1}, "host_bins"),
    ({"solver": "CG"}, "iterative_solver"),
])
def test_each_eager_step_is_counted_under_its_reason(scene, params, reason):
    res = optimize_shape(scene, {**BUNNY, "steps": 2, **params},
                         device="cpu")
    g = res["prof"]["graph"]
    assert (g["captures"], g["replays"], g["capture_s"]) == (0, 0, [])
    assert g["eager"] == {k: 2 if k == reason else 0
                          for k in drv.EAGER_REASONS}


def test_each_step_is_one_step_span(scene):
    res = optimize_shape(scene, {**BUNNY, "steps": 3, "trace": True},
                         device="cpu")
    spans = res["prof"]["trace"]["spans"]
    steps = [s for s in spans if s["name"] == "step"]
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert all(s["parent"] is None for s in steps)
    for name in ("solve", "render", "loss", "backward", "optimizer"):
        assert {s["parent"] for s in spans if s["name"] == name} \
            == {"step"}, name
    # no graph on the CPU: nothing captured, nothing replayed
    assert not {"graph_capture", "step_graph"} & {s["name"] for s in spans}


def test_capturing_records_no_span():
    from largesteps_torch import spans
    rec = spans.Recorder("cpu", always=True)
    rec.step = 0
    with spans.recording(rec):
        with spans.span("solve"):
            pass
        with spans.capturing():
            assert rec.capturing
            with spans.span("render"):
                pass
        assert not rec.capturing
        with spans.span("loss"):
            pass
    assert [r["name"] for r in rec.export()["spans"]] == ["solve", "loss"]


class _NoGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` off the card: a capture runs
    the work once, as ``torch.cuda.graph`` does, and a replay runs
    nothing."""

    def replay(self):
        pass


@pytest.fixture
def graph_off_the_card(monkeypatch):
    from largesteps_torch.core import banded
    from largesteps_torch.render import kernels
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(drv, "_clear_blas_workspaces", lambda: None)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    monkeypatch.setattr(banded, "LAUNCHES", dict.fromkeys(banded.LAUNCHES, 0))
    q = torch.zeros(3, requires_grad=True)

    def work():
        # one step's launches, as the kernels' wrappers count them
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] += 1
        q.grad = torch.ones(3)
        v = q.detach() + 1
        return (v.sum(), v.sum()), v, v, None

    return drv._StepGraph([q], drv._graph_stats()), work, q, kernels, banded


def test_a_capture_counts_no_launch_and_each_replay_one_step(
        graph_off_the_card):
    """A capture launches nothing on the card, so the counters stay where
    they were; each replay adds one step's launches."""
    sg, work, _, kernels, banded = graph_off_the_card
    sg.capture(work)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    for n in (1, 2, 3):
        sg.replay()
        assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, n)
    assert banded.LAUNCHES == {"banded_sweep": 0}
    assert (sg.stats["captures"], sg.stats["replays"]) == (1, 3)
    assert len(sg.stats["capture_s"]) == 1


def test_a_replay_hands_the_optimizer_the_graphs_gradients(
        graph_off_the_card):
    """``zero_grad`` drops ``.grad``; the replay points it back at the
    tensor the graph writes."""
    sg, work, q, _, _ = graph_off_the_card
    sg.capture(work)
    g = q.grad
    q.grad = None
    sg.replay()
    assert q.grad is g


def _rec(name, step, host, stream=None):
    return {"name": name, "parent": None, "parent_id": None, "step": step,
            "site": None, "host": list(host),
            "stream": None if stream is None else list(stream),
            "self_s": host[1] - host[0]}


def _ctx(graph=True, spans=True):
    recs = [_rec("step", 4, (1.0, 1.5)),                 # before the window
            _rec("step_graph", 4, (1.1, 1.2), (1.1, 1.9))]
    for k in (5, 6):
        recs += [_rec("step", k, (k, k + 0.004)),
                 _rec("step_graph", k, (k + 0.001, k + 0.002),
                      (k + 0.001, k + 0.006)),
                 _rec("optimizer", k, (k + 0.002, k + 0.003))]
    prof = {"rebin_steps": []}
    if spans:
        prof["trace"] = {"spans": recs, "host_waits": {},
                         "ts_offset_us": None}
    if graph:
        prof["graph"] = {"captures": 1, "replays": 39, "capture_s": [0.2],
                         "eager": {"before_capture": 1}}
    summary = {"spans": {"other": {"device_ms": 4.75, "host_ms": 0.1}}}
    return {"prof": prof, "steps": 40, "trace_first": 5, "trace_last": 7,
            "summary": summary}


@pytest.mark.parametrize("name,want", [
    ("step_graph_stream_ms", 5.0), ("step_graph_device_ms", 4.75),
    ("step_host_ms", 4.0), ("graph_replay_pct", 97.5)])
def test_graph_readers_read_the_counted_steps(name, want):
    assert bench.reader(name)(_ctx()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["step_graph_stream_ms",
                                  "step_graph_device_ms", "step_host_ms",
                                  "graph_replay_pct"])
def test_graph_readers_read_nothing_without_the_graph(name):
    # the parent commit records neither the spans nor prof["graph"]
    assert bench.reader(name)(_ctx(graph=False, spans=False)) is None
    if name != "step_host_ms":
        # an eager program with spans: no replay to read
        ctx = _ctx(graph=False)
        ctx["prof"]["trace"]["spans"] = [
            s for s in ctx["prof"]["trace"]["spans"]
            if s["name"] != "step_graph"]
        assert bench.reader(name)(ctx) is None


def test_the_cell_and_its_metrics_are_listed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    (cell,) = [w for w in b["workloads"] if w["name"] == "bunny-views49"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("bunny", "viewpoints-ours-49v", 1)
    names = {m["name"]: m for m in bench.per_layer_of("bunny-views49")}
    assert set(names) == {"step_graph_stream_ms", "step_graph_device_ms",
                          "step_host_ms", "graph_replay_pct"}
    assert all(m["moves"] == "steps_per_s" for m in names.values())
    assert not {"step_graph_stream_ms", "graph_replay_pct"} & {
        m["name"] for m in bench.per_layer_of("nefertiti-ours")}


def test_a_traced_bin_fit_agrees_with_the_reference():
    """icosphere-2 to gourd-2, 3 views of 128² (the smallest square image
    the tiles take: 32 × 128 pixels a tile), 3 steps of the bunny leg:
    the first step's image loss, its gradient in v-space and its update
    against the reference, each within the bunny cell's limit.  The limits
    hold the float32 solve against the reference's float64 one (some 1e-5
    of a vertex) and the two sides' own tie-breaks between faces at one
    depth, which move a boosted antialias gradient between vertices."""
    wl = bench.load("workloads", "bunny-views49")
    scn = make_scene(source=("icosphere", 2), target=("gourd", 2),
                     n_views=3, res=128, seed=2147483659)
    res, probe = bench.timed_call(
        optimize_shape, scn, BUNNY, "cpu", 3,
        {"keep_theta": {0, 1, 2}, "keep_grad": {0, 2}})
    assert res["prof"]["graph"]["eager"]["cpu"] == 3
    out = {"losses": np.asarray(res["losses"])[:, 0].tolist(),
           "grad0": probe.grad[0], "theta0": probe.theta[0],
           "theta1": probe.theta[1],
           "loss_last": float(res["losses"][-1, 0]),
           "grad_last": probe.grad[2]}
    ref = reference.Reference(scn, BUNNY, "cpu")
    nums = check.numbers(out, check.side_outputs(ref, probe.theta[2]), ref)
    for k in ("loss_first", "grad_first", "update_first"):
        assert nums[k] <= wl["limits"][k], (k, nums[k])
