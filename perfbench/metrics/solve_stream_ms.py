"""Device ms a step from the start to the end of the program's ``solve``
span on the stream (its CUDA events), over the traced steps: the forward
solve's kernels and the gaps between them, so its excess over
``solve_device_ms`` is the solve's stall on the host's launches."""
from perfbench import spans


def read(ctx):
    return spans.stream_ms(ctx, "solve")
