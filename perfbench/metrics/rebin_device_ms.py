"""Device ms of one rebin: the work launched inside the driver's
``rebin`` range over the traced steps, over the rebins among them (those
before the counted steps after the first, and before the step that stops
the trace)."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None:
        return None
    lo, hi = ctx["trace_first"], ctx["trace_last"]
    n = sum(1 for k in ctx["prof"].get("rebin_steps", []) if lo < k <= hi)
    if n == 0:
        return None
    ms = summary["spans"]["rebin"]["device_ms"] * summary["steps"]
    return ms / n
