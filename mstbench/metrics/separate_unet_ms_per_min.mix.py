"""Device milliseconds inside the program's span ``separate.htdemucs.unet``
(both branches' encoders and decoders), per minute of mixture sent (input
and reference)."""
from mstbench.metrics.separation import ms_per_min


def read(ctx):
    return ms_per_min(ctx, "separate.htdemucs.unet")
