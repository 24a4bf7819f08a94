"""The completed requests' share of the card's peaks: their least time (the
separation of both mixtures at the float32 peak, TF32 off; the converter
over the input's real segments and the encoder over the reference's at the
bfloat16 peak; no padding) over the traced window."""
from mstbench.metrics.counts import PEAKS, converter_flops_per_sample, encoder_flops_per_sample
from mstbench.metrics.counts_htdemucs import flops_per_chunk


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    cfg, inf = ctx.config, ctx.config["inference"]
    done = [a for a in ctx.counters.get("attempts", []) if a["ok"]]
    sep = sum(a["chunks"] for a in done) * flops_per_chunk(cfg["separator"])
    nets = sum(a["segments"] * inf["segment_length"] * converter_flops_per_sample(cfg["converter"])
               + a["ref_segments"] * inf["segment_length_ref"] * encoder_flops_per_sample(cfg["encoder"])
               for a in done)
    if not sep + nets:
        return None
    least = sep / PEAKS["float32"] + nets / PEAKS[inf["dtype"]]
    return 100.0 * least / ctx.trace.window_s
