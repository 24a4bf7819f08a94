"""Device seconds a step of the operations launched inside the
``mst.augment`` span (``FusedConverterPipeline.augment``: upload, the FX
chains, K2)."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("steps"):
        return None
    s = ctx.trace.span_device_s("mst.augment")
    return None if s is None else s / ctx.counters["steps"]
