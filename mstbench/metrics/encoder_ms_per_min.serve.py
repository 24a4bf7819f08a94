"""Device milliseconds of the operations launched inside the ``mst.encoder``
span, per minute of song audio sent in the window."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.span_device_s("mst.encoder")
    minutes = ctx.counters.get("attempted_audio_s", 0.0) / 60.0
    return None if s is None or not minutes else 1e3 * s / minutes
