"""Device ms a step of the four tile kernels (raster and antialias,
forward and backward) and aa_bwd's second kernel, found by kernel name in
the traced steps."""

KERNELS = ("raster_fwd_kernel", "raster_bwd_kernel", "aa_fwd_kernel",
           "aa_bwd_kernel", "aa_bwd_sums")


def tile_us(summary):
    return sum(us for name, us in summary["by_name_us"].items()
               if any(k in name for k in KERNELS))


def read(ctx):
    summary = ctx.get("summary")
    if summary is None:
        return None
    us = tile_us(summary)
    return us * 1e-3 / summary["steps"] if us > 0 else None
