"""Device milliseconds inside the program's span
``separate.htdemucs.transformer`` (the channel samplers and the 5
cross-domain layers), per minute of mixture sent (input and reference)."""
from mstbench.metrics.separation import ms_per_min


def read(ctx):
    return ms_per_min(ctx, "separate.htdemucs.transformer")
