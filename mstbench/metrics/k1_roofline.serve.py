"""K1's share of its roofline: the least time of every launch in the window
(``counts.k1_bound_s`` of the shapes its blocks' hooks saw) over the
device time of ``tcn_block_kernel`` in the trace."""
from mstbench.metrics.counts import k1_bound_s


def read(ctx):
    if ctx.trace is None:
        return None
    launches = ctx.counters.get("k1_launches", [])
    times = ctx.trace.kernels("tcn_block_kernel")
    if not launches or len(times) != len(launches):
        return None
    return 100.0 * sum(k1_bound_s(*shape) for shape in launches) / sum(times)
