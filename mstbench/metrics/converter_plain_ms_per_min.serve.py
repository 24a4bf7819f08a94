"""Device milliseconds of the operations launched inside the program's span
``models.tcn.plain`` (the converter's blocks that K1 does not take: blocks
0-2 in serving), per minute of song audio sent."""
from mstbench.metrics.program import span_ms_per_min


def read(ctx):
    return span_ms_per_min(ctx, "models.tcn.plain")
