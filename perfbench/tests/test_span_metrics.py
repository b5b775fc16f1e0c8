"""The readers of the program's span records (``perfbench/spans.py`` and
the six ``metrics/`` files that use it) on a made-up ``ctx``: two counted
steps, one step before and one after them, and the setup's spans.

    python -m pytest perfbench/tests/test_span_metrics.py -q
"""
import pytest

from perfbench import run

READERS = ("solve_stream_ms", "adjoint_solve_stream_ms",
           "pipe_setup_stream_ms", "pipe_scatter_stream_ms", "host_wait_ms",
           "epoch_build_s")


def rec(name, step, host, stream=None, site=None):
    return {"name": name, "parent": None, "parent_id": None, "step": step,
            "site": site, "host": list(host),
            "stream": None if stream is None else list(stream),
            "self_s": host[1] - host[0]}


def ctx_of(spans, first=5, last=7):
    return {"prof": {"trace": {"spans": spans, "host_waits": {},
                               "ts_offset_us": None}},
            "trace_first": first, "trace_last": last}


SPANS = [
    rec("setup.reference", None, (0.0, 4.0)),
    rec("setup.factor", None, (4.0, 10.5)),
    rec("setup", None, (0.0, 11.0)),
    rec("solve", 4, (20.0, 20.01), (20.0, 21.0)),       # before the window
    rec("solve", 5, (30.0, 30.01), (30.0, 30.030)),
    rec("adjoint_solve", 5, (30.1, 30.11), (30.1, 30.108)),
    rec("pipe_setup", 5, (30.2, 30.21), (30.2, 30.204)),
    rec("pipe_setup", 5, (30.3, 30.31), (30.3, 30.302)),
    rec("pipe_scatter", 5, (30.4, 30.41), (30.4, 30.41)),
    rec("host_wait", 5, (30.5, 30.503), site="inflight"),
    rec("solve", 6, (31.0, 31.01), (31.0, 31.034)),
    rec("adjoint_solve", 6, (31.1, 31.11), (31.1, 31.112)),
    rec("host_wait", 6, (31.5, 31.501), site="rebin_due"),
    rec("solve", 7, (32.0, 32.01), (32.0, 33.0)),       # after it
    rec("host_wait", 7, (32.5, 33.5), site="inflight"),
]

WANT = {"solve_stream_ms": 32.0, "adjoint_solve_stream_ms": 10.0,
        "pipe_setup_stream_ms": 3.0, "pipe_scatter_stream_ms": 5.0,
        "host_wait_ms": 2.0, "epoch_build_s": 10.5}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_counted_steps(name):
    got = run.reader(name)(ctx_of(SPANS))
    assert got == pytest.approx(WANT[name], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name):
    # the parent commit's prof has no "trace": the metric is left out
    ctx = {"prof": {"rebin_steps": []}, "trace_first": 5, "trace_last": 7}
    assert run.reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS[:5])
def test_no_traced_steps_reads_nothing(name):
    # a run whose profiler gave no trace (the CPU) has no counted steps
    assert run.reader(name)(ctx_of(SPANS, None, None)) is None


def test_spans_without_events_give_no_stream_time():
    # the CPU records host intervals only
    host_only = [dict(s, stream=None) for s in SPANS]
    ctx = ctx_of(host_only)
    assert run.reader("solve_stream_ms")(ctx) is None
    assert run.reader("host_wait_ms")(ctx) == pytest.approx(2.0)


def test_new_readers_are_listed_for_the_cell_only():
    wanted = {m["name"]: m for m in run.per_layer_of("nefertiti-ours")}
    for name in READERS:
        m = wanted[name]
        assert m["source"] == "program_counter"
        assert m["workloads"] == ["nefertiti-ours"]
        assert m["moves"] == ("setup_s" if name == "epoch_build_s"
                              else "steps_per_s")
