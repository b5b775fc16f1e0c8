"""The share of the traced window in which no kernel, copy or set ran on
the card: one minus the union of their intervals over the window."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
