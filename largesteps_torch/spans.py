"""Named spans of the port's work, and the recorder that times them.

``span(name)`` opens a ``torch.profiler.record_function`` range of that
name: the driver's step layers (``solve``, ``normals``, ``render``,
``loss``, ``backward``, ``optimizer``, ``displacement``, ``rebin``), the
dense renderer's stages, the tile pipe's triangle setup and record gather
(``pipe_setup``) and its chain and scatter (``pipe_scatter``), the adjoint
solve (``adjoint_solve``) and every place the driver blocks the host on the
card (``host_wait``, with the ``site`` that waits), and the driver's own: each
call of the step (``step``), and on the CUDA-graph path each capture of
the step's work (``graph_capture``) and each replay (``step_graph``).

While a :class:`Recorder` is active (``optimize_shape`` makes one a call,
:func:`recording`) and tracing is on, a span also records its name, its
parent, the recorder's step index, its host start and end
(``time.perf_counter`` seconds) and, on CUDA, a pair of events on the
current stream.  Tracing is on when the recorder was made with ``always``
(the driver's ``"trace"`` parameter) or while a ``torch.profiler`` is
recording, checked at each span's entry; otherwise a span costs one flag
check beside its range.  The parent is the innermost recorded span open on
the span's thread or, on a thread with none open (autograd's), the one
open on the thread that made the recorder.

``setup_span(name)`` times the work outside the step loop (the epoch
build, the reference render, the remesh) in host seconds whether tracing is
on or not, as the driver's setup timings always were; its ``seconds`` are
read after the block.

No span waits on its events.  The driver calls :func:`waited` right after
each wait it makes anyway: after a wait that drained the stream every
closed span's events have run and are read against an anchor event
recorded right after a drained wait (so device times land on the host
clock); after the wait for the step ``max_inflight`` back, those of the
steps up to it.  At most ``max_inflight + 1`` steps of the large-F path
hold unread events; elsewhere the steps since the last drained wait (the
divergence check every ``nan_check_every`` steps, or the call's end).
Read events are recorded again by later spans.  The recorder's one module-level handle is the active
recorder: a span inside the solvers or the pipe (on autograd's thread too)
has no other way to find it.

While the driver captures a CUDA graph (:func:`capturing`) a span is its
``record_function`` range alone: it records nothing and no event, since an
event recorded into a capture is never timed.  A replay of that graph is
one ``step_graph`` span.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["span", "setup_span", "waited", "recording", "capturing",
           "Recorder", "summarize"]

# libkineto writes a Chrome trace's ``ts`` as µs since the epoch less a
# base floored to 7,889,238-second intervals (ChromeTraceBaseTime)
_TRACE_BASE_S = 7889238

_active = None          # the Recorder of the running optimize_shape call


def _ts_offset_us() -> float:
    """µs to add to ``perf_counter() * 1e6`` to get a Chrome trace's
    ``ts``."""
    perf, wall_ns = time.perf_counter(), time.time_ns()
    base_ns = wall_ns // 10**9 // _TRACE_BASE_S * _TRACE_BASE_S * 10**9
    return (wall_ns - base_ns) * 1e-3 - perf * 1e6


class _Record:
    __slots__ = ("name", "parent", "step", "site", "t0", "t1", "e0", "e1",
                 "anchor", "d0", "d1")

    def __init__(self, name, parent, step, site):
        self.name, self.parent, self.step, self.site = name, parent, step, site
        self.e0 = self.e1 = self.anchor = self.d0 = self.d1 = None


class Recorder:
    """The spans of one driver call (see the module doc).  ``step`` is the
    driver's step index, set before each step's work; ``used`` says whether
    any span outside the setup recorded."""

    def __init__(self, device, always: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.always = bool(always)
        self.step = None
        self.capturing = False      # a CUDA graph capture is under way
        self.used = self.always
        self.records = []           # closed, in closing order
        self._unread = deque()      # closed records whose events are unread
        self._free = []             # read events, recorded again later
        self._local = threading.local()
        self._main = self._stack()  # the stack of the thread that made it
        self._anchor = None         # (event, perf_counter) after a drain
        self.ts_offset_us = None

    def on(self) -> bool:
        return self.always or _profiler_enabled()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        e = self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def open(self, name, site, setup):
        """A new record on this thread's stack, its host start taken last:
        a setup span's, or (tracing on) a step span's."""
        stack = self._stack()
        parent = stack[-1] if stack else (self._main[-1] if self._main
                                          else None)
        r = _Record(name, parent, self.step, site)
        stack.append(r)
        if not setup:
            self.used = True
            if self.ts_offset_us is None and _profiler_enabled():
                self.ts_offset_us = _ts_offset_us()
        r.t0 = time.perf_counter()
        return r

    def close(self, r):
        r.t1 = time.perf_counter()
        if r.e1 is not None:
            self._unread.append(r)
        self._stack().pop()
        self.records.append(r)

    def waited(self, upto_step=None):
        """Read the events of the closed spans of steps up to
        ``upto_step``, whose work a wait just saw complete; with None the
        wait drained the stream: read every closed span's, and (on CUDA,
        while tracing is on or before the first anchor) record a new
        anchor."""
        while self._unread and (upto_step is None
                                or self._unread[0].step is None
                                or self._unread[0].step <= upto_step):
            r = self._unread.popleft()
            if r.anchor is not None:
                ev, t = r.anchor
                r.d0 = t + ev.elapsed_time(r.e0) * 1e-3
                r.d1 = t + ev.elapsed_time(r.e1) * 1e-3
            self._free += (r.e0, r.e1)
            r.e0 = r.e1 = r.anchor = None
        if upto_step is None and self.cuda and (self._anchor is None
                                                or self.on()):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._anchor = (ev, time.perf_counter())

    def export(self) -> dict:
        """The records as plain data, once every wait is done: ``spans``
        (name, parent name and index, step, site, ``host`` [start, end] and
        ``stream`` [start, end] or None, in perf_counter seconds, and
        ``self_s``, the host seconds no child span covers), ``host_waits``
        (count and host seconds by site) and ``ts_offset_us`` (µs from
        ``perf_counter() * 1e6`` to the Chrome trace's ``ts``; None if no
        profiler ran)."""
        index = {id(r): i for i, r in enumerate(self.records)}
        child_s = [0.0] * len(self.records)
        for r in self.records:
            if r.parent is not None and id(r.parent) in index:
                child_s[index[id(r.parent)]] += r.t1 - r.t0
        spans, waits = [], {}
        for i, r in enumerate(self.records):
            pid = None if r.parent is None else index.get(id(r.parent))
            spans.append({
                "name": r.name, "parent": None if pid is None
                else r.parent.name, "parent_id": pid, "step": r.step,
                "site": r.site, "host": [r.t0, r.t1],
                "stream": None if r.d0 is None else [r.d0, r.d1],
                "self_s": (r.t1 - r.t0) - child_s[i]})
            if r.name == "host_wait":
                w = waits.setdefault(r.site, {"n": 0, "s": 0.0})
                w["n"] += 1
                w["s"] += r.t1 - r.t0
        return {"spans": spans, "host_waits": waits,
                "ts_offset_us": self.ts_offset_us}


class _Span:
    """A ``record_function`` range that records into ``rec``: a step's span
    (under tracing; on CUDA between two events unless it is a host wait)
    or a setup span (``setup``: host seconds, also without a recorder).
    The host clock is read outside the range and the events inside it."""

    __slots__ = ("rec", "name", "site", "setup", "events", "rf", "r",
                 "seconds")

    def __init__(self, rec, name, site=None, setup=False):
        self.rec, self.name, self.site, self.setup = rec, name, site, setup
        self.events = (rec is not None and rec.cuda and not setup
                       and site is None)
        self.seconds = None

    def __enter__(self):
        rec = self.rec
        self.r = time.perf_counter() if rec is None \
            else rec.open(self.name, self.site, self.setup)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if self.events:
            self.r.anchor, self.r.e0 = rec._anchor, rec._event()
        return self

    def __exit__(self, *exc):
        if self.events:
            self.r.e1 = self.rec._event()
        self.rf.__exit__(*exc)
        if self.rec is None:
            self.seconds = time.perf_counter() - self.r
        else:
            self.rec.close(self.r)
            self.seconds = self.r.t1 - self.r.t0
        return False


def span(name: str, site: str | None = None):
    """The range ``name`` (see the module doc); ``site`` names a
    ``host_wait``'s wait."""
    rec = _active
    if rec is None or rec.capturing or not rec.on():
        return record_function(name)
    return _Span(rec, name, site)


def setup_span(name: str):
    """A range outside the step loop whose host ``seconds`` are always
    measured, and recorded when a recorder is active."""
    return _Span(_active, name, setup=True)


def waited(upto_step=None):
    """:meth:`Recorder.waited` of the active recorder, if any."""
    if _active is not None:
        _active.waited(upto_step)


@contextlib.contextmanager
def recording(rec: Recorder):
    """Make ``rec`` the active recorder for the block."""
    global _active
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev


@contextlib.contextmanager
def capturing():
    """Mark the block as a CUDA graph capture: the active recorder's spans
    record nothing inside it (see the module doc)."""
    rec = _active
    if rec is None:
        yield
        return
    prev, rec.capturing = rec.capturing, True
    try:
        yield
    finally:
        rec.capturing = prev


def summarize(trace: dict, first: int, last: int) -> dict:
    """Per span name over the steps [first, last): spans a step, host ms,
    self ms and stream ms (device end minus device start, where timed) a
    step; and the host waits by site, count and host ms a step."""
    n = max(last - first, 1)
    names, waits = {}, {}
    for s in trace["spans"]:
        if s["step"] is None or not first <= s["step"] < last:
            continue
        a = names.setdefault(s["name"], {"n": 0, "host_ms": 0.0,
                                         "self_ms": 0.0, "stream_ms": None})
        a["n"] += 1
        a["host_ms"] += (s["host"][1] - s["host"][0]) * 1e3
        a["self_ms"] += s["self_s"] * 1e3
        if s["stream"] is not None:
            a["stream_ms"] = (a["stream_ms"] or 0.0) + \
                (s["stream"][1] - s["stream"][0]) * 1e3
        if s["name"] == "host_wait":
            w = waits.setdefault(s["site"], {"n": 0, "ms": 0.0})
            w["n"] += 1
            w["ms"] += (s["host"][1] - s["host"][0]) * 1e3
    per = {k: {"n": a["n"] / n, "host_ms": a["host_ms"] / n,
               "self_ms": a["self_ms"] / n,
               "stream_ms": None if a["stream_ms"] is None
               else a["stream_ms"] / n}
           for k, a in sorted(names.items())}
    return {"steps": last - first, "spans": per,
            "host_waits": {k: {"n": w["n"] / n, "ms": w["ms"] / n}
                           for k, w in sorted(waits.items())}}
