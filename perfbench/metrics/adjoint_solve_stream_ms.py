"""Device ms a step from the start to the end of the program's
``adjoint_solve`` span on the stream (its CUDA events), over the traced
steps: the adjoint solve inside the backward, kernels and gaps."""
from perfbench import spans


def read(ctx):
    return spans.stream_ms(ctx, "adjoint_solve")
