"""The whole song's share of the card's bfloat16 peak: the model operations
of the useful work (the real segments of the songs that completed: the
converter over the input stems, the encoder over the reference stems; no
bucket padding) over the traced window."""
from mstbench.metrics.counts import PEAKS, converter_flops_per_sample, encoder_flops_per_sample


def read(ctx):
    if ctx.trace is None:
        return None
    inf = ctx.config["inference"]
    done = [a for a in ctx.counters.get("attempts", []) if a["ok"]]
    flops = sum(a["segments"] * inf["segment_length"] * converter_flops_per_sample(ctx.config["converter"])
                + a["ref_segments"] * inf["segment_length_ref"] * encoder_flops_per_sample(ctx.config["encoder"])
                for a in done)
    if not flops:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAKS[inf["dtype"]])
