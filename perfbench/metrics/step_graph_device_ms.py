"""Device ms a step of the work launched inside the program's
``step_graph`` range, over the traced steps.  That range is not one of
the driver's layer ranges that ``trace.summarize`` charges work to, so its
kernels land in the summary's ``other``: on the graph path that is the
replay's kernels, with the loss log's copy beside them (a few µs,
launched in no range).  A program
that records no replay (``prof["graph"]`` missing or no replay in the
traced steps) reads None."""


def _replays_traced(ctx):
    trace = ctx["prof"].get("trace")
    lo, hi = ctx.get("trace_first"), ctx.get("trace_last")
    if trace is None or lo is None or hi is None:
        return False
    return any(s["name"] == "step_graph" and s["step"] is not None
               and lo <= s["step"] < hi for s in trace["spans"])


def read(ctx):
    summary = ctx.get("summary")
    graph = ctx["prof"].get("graph")
    if summary is None or not graph or not _replays_traced(ctx):
        return None
    return summary["spans"]["other"]["device_ms"]
