"""Host ms a step inside the program's ``step`` spans (each call of the
step in the driver's loop, eager or a graph's replay with the optimizer),
over the traced steps.  A program without that span reads None."""
from perfbench import spans


def read(ctx):
    got = spans.counted(ctx)
    if got is None or not any(s["name"] == "step" for s in got[0]):
        return None
    return spans.host_ms(ctx, "step")
