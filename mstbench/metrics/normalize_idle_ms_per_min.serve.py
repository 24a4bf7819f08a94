"""Milliseconds inside the program's span ``normalize.batch`` in which the
device ran nothing (the normalizer's host round trips), per minute of song
audio sent."""
from mstbench.metrics.program import idle_ms_per_min


def read(ctx):
    return idle_ms_per_min(ctx, "normalize.batch")
