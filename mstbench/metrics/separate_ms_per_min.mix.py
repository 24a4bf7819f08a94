"""Device milliseconds of the operations launched inside the program's span
``separate.htdemucs`` (a mixture's whole separation: the front end, both
U-Nets and the transformer), per minute of mixture sent (input and
reference)."""
from mstbench.metrics.separation import ms_per_min


def read(ctx):
    return ms_per_min(ctx, "separate.htdemucs")
