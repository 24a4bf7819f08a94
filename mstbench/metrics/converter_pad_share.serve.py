"""Share of the converter's dispatched segments that are bucket padding,
over the songs that completed in the window (the engine pads a song's
``4 x n`` segments up to its next bucket, ``infer/pipeline.py:_bucket``)."""


def read(ctx):
    done = [a for a in ctx.counters.get("attempts", []) if a["ok"] and a["batches"]]
    dispatched = sum(sum(a["batches"]) for a in done)
    if not dispatched:
        return None
    return 100.0 * (1.0 - sum(a["segments"] for a in done) / dispatched)
