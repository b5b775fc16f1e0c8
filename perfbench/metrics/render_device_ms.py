"""Device ms a step of the work launched inside the driver's ``render``
range (the innermost range around each launch), over the traced steps."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None:
        return None
    return summary["spans"]["render"]["device_ms"]
