"""Device seconds a step of the operations launched inside the
``mst.train_step`` span (``FusedConverterPipeline._train``: the frozen
encoder, the converter's forward and backward, the loss, Adam)."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("steps"):
        return None
    s = ctx.trace.span_device_s("mst.train_step")
    return None if s is None else s / ctx.counters["steps"]
