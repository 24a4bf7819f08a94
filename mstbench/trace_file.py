"""The reading of a traced window's Chrome trace, in a process of its own.

    python3 -m mstbench.trace_file <trace.json> <out.pickle>

reads the trace that :func:`mstbench.tracing.profiled` wrote and pickles
what :class:`mstbench.tracing.Trace` needs: the window, the device's
operations with their launch times, the benchmark's spans and the
outermost host operations. It imports no torch, so that the run's own
process can check its outputs against the reference meanwhile.
"""
from __future__ import annotations

import gzip
import json
import pickle
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "mstbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _outermost(events: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The events not inside an earlier one (host ops nest)."""
    out, end = [], float("-inf")
    for a, b, name in sorted(events):
        if a >= end:
            out.append((a, b, name))
            end = b
    return out


def summarize(path: str) -> dict:
    """``{"window", "ops", "spans", "host"}`` of the trace at ``path``: the
    window's ``(start, end)``; the device's operations ``(name, start, end,
    launch_time)``; each span's merged intervals; the outermost host
    operations ``(start, end, name)``. Times are seconds."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    launches: Dict[int, float] = {}
    dev_ops, spans, host_ops = [], defaultdict(list), []
    window = None
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            dev_ops.append((e["name"], ts, ts + dur, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                window = (ts, ts + dur)
            else:
                spans[e["name"]].append((ts, ts + dur))
        elif cat == "cpu_op":
            host_ops.append((ts, ts + dur, e["name"]))
    if window is None:
        raise ValueError(f"{path}: no {WINDOW} range in the trace")
    return {"window": window,
            "ops": [(n, a, b, launches.get(c)) for n, a, b, c in dev_ops],
            "spans": {k: _merge(v) for k, v in spans.items()},
            "host": _outermost(host_ops)}


def main(argv=None) -> int:
    path, out = (argv or sys.argv[1:])[:2]
    with open(out, "wb") as f:
        pickle.dump(summarize(path), f, protocol=pickle.HIGHEST_PROTOCOL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
