"""Device milliseconds of the operations launched inside the program's span
``normalize.compression`` (compression matching: the candidate sweep with
K2, the choice, the final compression), per minute of song audio sent."""
from mstbench.metrics.program import span_ms_per_min


def read(ctx):
    return span_ms_per_min(ctx, "normalize.compression")
