"""Reading a ``torch.profiler`` Chrome trace of the timed steps.

:func:`summarize` is a frozen copy of the port's
``largesteps_torch/profiling.py:_summarize`` (device work charged to the
innermost of the driver's ``record_function`` ranges around its launch),
kept here so that a change to the program's profiler does not change the
yardstick.  :func:`window` cuts a trace to the work launched from a given
host time on, :func:`busy` takes the union of the card's intervals (not
their sum) over the traced window, and :func:`breakdown` lists the device
operations that took most time and the longest idle gaps by what the host
was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

__all__ = ["SPANS", "window", "summarize", "busy", "breakdown",
           "device_events"]

SPANS = ("solve", "normals", "render", "loss", "backward", "optimizer",
         "displacement", "rebin", "zbuffer", "interpolate", "shade",
         "antialias")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _complete(trace):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def device_events(trace):
    return [e for e in _complete(trace) if e.get("cat") in _DEVICE_CATS]


def window(trace: dict, t_lo: float) -> dict:
    """The trace's events from host time ``t_lo`` (µs) on: host events
    that start there or later, and device work launched there or later."""
    events = _complete(trace)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in _LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    keep = []
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            ts = launch.get(e.get("args", {}).get("correlation"))
            if ts is not None and ts >= t_lo:
                keep.append(e)
        elif e["ts"] >= t_lo:
            keep.append(e)
    return {"traceEvents": keep}


def summarize(trace: dict, steps: int, wall_s: float) -> dict:
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"] in SPANS)
    host_span = defaultdict(float)
    for lo, hi, name in ranges:
        host_span[name] += hi - lo
    # device work belongs to the span whose host range holds its launch,
    # on whichever thread (the backward launches from autograd's thread)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    dev_span = defaultdict(float)
    for d in dev:
        ts = launch_ts.get(d.get("args", {}).get("correlation"))
        # the innermost range: the last to start of those around the launch
        inside = [n for lo, hi, n in ranges
                  if ts is not None and lo <= ts <= hi]
        dev_span[inside[-1] if inside else "other"] += d["dur"]
    per = 1e-3 / steps                              # µs total → ms a step
    busy_ms = sum(by_name.values()) * per
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_ms_per_step": busy_ms,
        "device_busy": busy_ms / (wall_s * 1e3 / steps),
        "device_events_per_step": len(dev) / steps,
        "spans": {s: {"host_ms": host_span[s] * per,
                      "device_ms": dev_span[s] * per}
                  for s in (*SPANS, "other")},
        "kernels": [{"name": n[:120], "ms_per_step": t * per}
                    for n, t in top],
        "by_name_us": dict(by_name),
    }


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def busy(full: dict, cut: dict) -> tuple:
    """(busy µs, window µs, the busy intervals): the window runs from the
    start of the first device operation of ``cut`` (the work launched in
    the counted steps) to the end of the last; every device interval of
    ``full`` inside it counts, whenever it was launched."""
    dev = device_events(cut)
    if not dev:
        return 0.0, 0.0, []
    lo = min(e["ts"] for e in dev)
    hi = max(e["ts"] + e["dur"] for e in dev)
    iv = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
          for e in device_events(full)]
    merged = _union([(a, b) for a, b in iv if b > a])
    return sum(b - a for a, b in merged), hi - lo, merged


def breakdown(full: dict, cut: dict, merged, top: int = 10) -> dict:
    """The device operations of the counted steps that took most time, and
    the card's idle gaps summed by the host range open when each began
    (the innermost driver span, else the innermost host operation)."""
    by_name = defaultdict(float)
    for e in device_events(cut):
        by_name[e["name"][:100]] += e["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    starts, named = {}, {}
    for cat, keep in (("span", lambda e: e.get("cat") == "user_annotation"
                       and e["name"] in SPANS),
                      ("op", lambda e: e.get("cat") == "cpu_op")):
        ev = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in _complete(full) if keep(e))
        starts[cat], named[cat] = [x[0] for x in ev], ev
    gaps = defaultdict(float)
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        name = "no host range"
        for cat in ("span", "op"):
            k = bisect.bisect_right(starts[cat], a1) - 1
            if k >= 0 and named[cat][k][1] >= a1:
                name = named[cat][k][2][:100]
                break
        gaps[name] += (b0 - a1) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
