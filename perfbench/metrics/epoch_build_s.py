"""Host seconds of the timed call's ``setup.*`` spans: its epoch build
(reference render, topology, host bins, matrix, RCM, factor), outside the
profiled steps."""
from perfbench import spans


def read(ctx):
    return spans.setup_s(ctx)
