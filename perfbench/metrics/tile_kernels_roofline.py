"""The least time the H100 could take for the tile kernels' work in the
traced steps (``perfbench/roofline.py``: the larger of bytes over HBM
bandwidth and float ops over the float32 peak, the work counted from each
step's own vertices by the reference's rasterization) over their measured
device time, in percent."""
from perfbench import roofline
from perfbench.metrics.tile_kernels_device_ms import tile_us


def read(ctx):
    summary, work = ctx.get("summary"), ctx.get("work")
    if summary is None or not work:
        return None
    us = tile_us(summary)
    if us <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.tile_work(w)) for w in work)
    return 100.0 * least / (us * 1e-6)
