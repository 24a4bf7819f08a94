"""The whole step's share of the card's float32 peak (TF32 off): the
converter's forward and backward (three times its forward's operations)
and the frozen encoder's forward over every triplet's samples, over the
traced window."""
from mstbench.metrics.counts import PEAKS, converter_flops_per_sample, encoder_flops_per_sample


def read(ctx):
    steps = ctx.counters.get("steps")
    if ctx.trace is None or not steps:
        return None
    tc = ctx.config["train"]
    samples = ctx.counters["triplets"] * tc["segment_length"]
    flops = steps * samples * (3 * converter_flops_per_sample(ctx.config["converter"])
                               + encoder_flops_per_sample(ctx.config["encoder"]))
    return 100.0 * flops / (ctx.trace.window_s * PEAKS[tc["compute_dtype"]])
