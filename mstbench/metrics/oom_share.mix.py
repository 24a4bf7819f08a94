"""Share of the traced window spent in requests that failed (the program's
``infer.request`` spans, separation included, whose record says ``ok``
false: the whole-song converter dispatch's ``torch.OutOfMemoryError``)."""
from mstbench.metrics.program import failed_share


def read(ctx):
    return failed_share(ctx, "infer.request")
