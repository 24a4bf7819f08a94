"""Readings for the ``.mix`` readers: of the separator's spans and counter
(device time a minute of mixture sent, and the transformer's share of its
roofline), and of the stages after separation, which ``serve_mixes`` shares
with ``serve_songs`` (``serve_reader``). Each returns ``None`` where the
cell gave it nothing (no trace, no device operation, a program without the
span or the counter, records that do not pair one to one with the spans)."""
from __future__ import annotations

import os

from mstbench.harness import load_module
from mstbench.metrics.counts_htdemucs import transformer_bound_s
from mstbench.metrics.program import records


def serve_reader(name: str):
    """The ``read`` of ``<name>.serve``: the same reading of the stages after
    separation (the spans, hooks and counters of ``drivers/songs.py``'s
    ``install_spans``, per minute of input song sent)."""
    return load_module(os.path.join(os.path.dirname(__file__), name + ".serve.py")).read


def _traced(ctx):
    return ctx.trace if ctx.trace is not None and ctx.trace.ops else None


def ms_per_min(ctx, name: str):
    """Device milliseconds of the operations launched inside the program's
    span ``name``, per minute of mixture sent in the window (the input and
    the reference mixture of every request)."""
    tr = _traced(ctx)
    s = None if tr is None else tr.span_device_s(name)
    minutes = ctx.counters.get("attempted_mix_s", 0.0) / 60.0
    return None if s is None or not minutes else 1e3 * s / minutes


def transformer_roofline(ctx):
    """``counts_htdemucs.transformer_bound_s`` of every dispatch the
    separator recorded (counter ``separate.htdemucs``: its chunks and each
    chunk's tokens) over the device time inside the program's span
    ``separate.htdemucs.transformer``; one span interval a record."""
    tr = _traced(ctx)
    recs = None if tr is None else records("separate.htdemucs")
    spans = None if tr is None else tr.spans.get("separate.htdemucs.transformer")
    if not recs or spans is None or len(spans) != len(recs):
        return None
    cfg = ctx.config["separator"]
    bound = sum(transformer_bound_s(cfg, r["batch"], r["freq_tokens"], r["time_tokens"])
                for r in recs)
    return 100.0 * bound / tr.span_device_s("separate.htdemucs.transformer")
