"""Device ms a step of the work launched inside the driver's ``backward``
range (the innermost range around each launch), over the traced steps: the render backward, its glue and the
adjoint solve."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None:
        return None
    return summary["spans"]["backward"]["device_ms"]
