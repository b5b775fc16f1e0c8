"""Host ms a step inside the program's ``host_wait`` spans, over the
traced steps: the driver blocked on the card (its queue bound, its rebin
decisions, its divergence check, a host rebin's copies)."""
from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, "host_wait")
