"""The share of the timed call's steps that replayed the step's CUDA graph
(``prof["graph"]["replays"]`` over the call's steps), %.  A program without
the graph's counters reads None."""


def read(ctx):
    graph = ctx["prof"].get("graph")
    if not graph or not ctx.get("steps"):
        return None
    return 100.0 * graph["replays"] / ctx["steps"]
