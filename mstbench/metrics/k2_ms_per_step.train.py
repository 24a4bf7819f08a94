"""Device milliseconds a step of K2 (``envelope_scan_kernel``: the FX
chains' compressors)."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("steps"):
        return None
    times = ctx.trace.kernels("envelope_scan_kernel")
    return 1e3 * sum(times) / ctx.counters["steps"] if times else None
