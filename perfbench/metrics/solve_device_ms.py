"""Device ms a step of the work launched inside the driver's ``solve``
range (the innermost range around each launch), over the traced steps.  This is the forward solve: the adjoint solve
runs inside ``backward``."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None:
        return None
    return summary["spans"]["solve"]["device_ms"]
