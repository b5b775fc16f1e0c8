"""Stream ms a step of the program's ``step_graph`` spans (each replay of
the step's CUDA graph, between the CUDA events around it), over the traced
steps: the graph's kernels and the gaps between them on the card.  A
program without the graph records no such span and reads None."""
from perfbench import spans


def read(ctx):
    return spans.stream_ms(ctx, "step_graph")
