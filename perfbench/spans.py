"""Reading the program's span records: ``prof["trace"]`` of the timed call
(``largesteps_torch/spans.py``: each span's name, step, host interval and,
on the card, its stream interval from CUDA events, all on the host clock
in seconds).  The step readers count the traced steps [trace_first,
trace_last), those the device-trace readers count; a call whose program
records no spans (no ``trace`` in its ``prof``) reads None."""
from __future__ import annotations

__all__ = ["counted", "stream_ms", "host_ms", "setup_s"]


def counted(ctx):
    """The span records of the counted steps and their number of steps,
    or None."""
    trace = ctx["prof"].get("trace")
    lo, hi = ctx.get("trace_first"), ctx.get("trace_last")
    if trace is None or lo is None or hi is None or hi <= lo:
        return None
    recs = [s for s in trace["spans"]
            if s["step"] is not None and lo <= s["step"] < hi]
    return (recs, hi - lo) if recs else None


def stream_ms(ctx, name):
    """Device end minus device start of the spans ``name``, ms a step."""
    got = counted(ctx)
    if got is None:
        return None
    recs, steps = got
    xs = [s["stream"] for s in recs
          if s["name"] == name and s["stream"] is not None]
    return sum(b - a for a, b in xs) * 1e3 / steps if xs else None


def host_ms(ctx, name):
    """Host ms a step inside the spans ``name`` (0 where none ran)."""
    got = counted(ctx)
    if got is None:
        return None
    recs, steps = got
    return sum(s["host"][1] - s["host"][0] for s in recs
               if s["name"] == name) * 1e3 / steps


def setup_s(ctx):
    """Host seconds of the call's ``setup.*`` spans (its epoch builds)."""
    trace = ctx["prof"].get("trace")
    if trace is None:
        return None
    xs = [s["host"][1] - s["host"][0] for s in trace["spans"]
          if s["name"].startswith("setup.")]
    return sum(xs) if xs else None
