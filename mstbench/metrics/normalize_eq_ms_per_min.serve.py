"""Device milliseconds of the operations launched inside the program's span
``normalize.eq`` (EQ matching: average spectra, FIR design, the FFT
filtering), per minute of song audio sent."""
from mstbench.metrics.program import span_ms_per_min


def read(ctx):
    return span_ms_per_min(ctx, "normalize.eq")
