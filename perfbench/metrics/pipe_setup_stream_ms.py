"""Device ms a step on the stream inside the program's ``pipe_setup``
spans (their CUDA events), over the traced steps: the tile pipe's triangle
setup and the gather of its records by bins, forward and recompute."""
from perfbench import spans


def read(ctx):
    return spans.stream_ms(ctx, "pipe_setup")
