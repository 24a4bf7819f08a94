"""Device milliseconds of K2 (the compressor envelope, ``envelope_scan_kernel``)
per minute of song audio sent in the window."""


def read(ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernels("envelope_scan_kernel")
    minutes = ctx.counters.get("attempted_audio_s", 0.0) / 60.0
    return 1e3 * sum(times) / minutes if times and minutes else None
