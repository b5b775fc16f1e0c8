"""Device ms a step on the stream inside the program's ``pipe_scatter``
spans (their CUDA events), over the traced steps: the tile pipe's chain to
clip space and its scatter of the per-slot sums to the vertices."""
from perfbench import spans


def read(ctx):
    return spans.stream_ms(ctx, "pipe_scatter")
