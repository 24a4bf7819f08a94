"""Readings of the port's own spans and counters (``utils/profiling.py`` of
``music_mixing_style_transfer_tpu_torch``), for the per-layer readers.
Each returns ``None`` where the cell gave it nothing: no trace, no device
operation in it (a CPU run), a program without the span or the counter,
or records that do not pair one to one with what they describe."""
from __future__ import annotations

import bisect

from mstbench.metrics.counts import k2_bound_s


def records(name: str):
    """The program's records of counter ``name`` in the traced window, or
    ``None`` where the program keeps no counters."""
    from music_mixing_style_transfer_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return None if read is None else read(name)


def _traced(ctx):
    return ctx.trace if ctx.trace is not None and ctx.trace.ops else None


def _minutes(ctx) -> float:
    return ctx.counters.get("attempted_audio_s", 0.0) / 60.0


def span_ms_per_min(ctx, name: str):
    """Device milliseconds of the operations launched inside the program's
    span ``name``, per minute of song audio sent in the window."""
    tr = _traced(ctx)
    s = None if tr is None else tr.span_device_s(name)
    return None if s is None or not _minutes(ctx) else 1e3 * s / _minutes(ctx)


def idle_ms_per_min(ctx, name: str):
    """Milliseconds in the program's span ``name`` (within the window) in
    which no operation ran on the device, per minute of song audio sent."""
    tr = _traced(ctx)
    if tr is None or name not in tr.spans or not _minutes(ctx):
        return None
    w0, w1 = tr.window
    starts = [x for x, _ in tr.busy]
    idle = 0.0
    for a, b in tr.spans[name]:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        idle += b - a
        i = max(bisect.bisect_left(starts, a) - 1, 0)
        while i < len(tr.busy) and tr.busy[i][0] < b:
            idle -= max(0.0, min(b, tr.busy[i][1]) - max(a, tr.busy[i][0]))
            i += 1
    return 1e3 * idle / _minutes(ctx)


def k2_roofline(ctx):
    """K2's share of its roofline: ``counts.k2_bound_s`` of every envelope
    the program recorded (counter ``ops.cuda.envelope``: lanes, samples,
    rows read) over the device time of ``envelope_scan_kernel``; the
    records must pair one to one with the kernels."""
    tr = _traced(ctx)
    recs = None if tr is None else records("ops.cuda.envelope")
    if not recs:
        return None
    times = tr.kernels("envelope_scan_kernel")
    if len(times) != len(recs):
        return None
    return 100.0 * sum(k2_bound_s(*r) for r in recs) / sum(times)


def failed_share(ctx, name: str):
    """Share of the window in the program's request spans ``name`` whose
    record (counter ``name``: ``{"samples", "ok"}``, one a request, in
    order) says ``ok`` false; the spans, the records and the driver's
    attempts must pair one to one, sample counts and outcomes alike."""
    tr = _traced(ctx)
    recs = None if tr is None else records(name)
    spans = None if tr is None else tr.spans.get(name)
    attempts = ctx.counters.get("attempts", [])
    if not recs or spans is None or not len(spans) == len(recs) == len(attempts):
        return None
    if any(r["samples"] != a["samples"] or r["ok"] != a["ok"] for r, a in zip(recs, attempts)):
        return None
    w0, w1 = tr.window
    failed = sum(max(0.0, min(b, w1) - max(a, w0))
                 for (a, b), r in zip(spans, recs) if not r["ok"])
    return 100.0 * failed / tr.window_s
