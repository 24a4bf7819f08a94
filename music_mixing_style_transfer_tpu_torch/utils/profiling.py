"""Device profiling helpers (counterpart of
``music_mixing_style_transfer_tpu/utils/profiling.py``, the reference has
none): a ``torch.profiler`` trace exported for Chrome's trace viewer or
Perfetto, and a per-call wall time that waits for the card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host ops, and the card's kernels where there is a
    card) and write ``<log_dir>/trace.json`` (Chrome trace format). Yields
    the profiler, whose ``key_averages()`` sums time by operation."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(out) -> None:
    """Wait for the card when ``out`` (a tensor, or a list or tuple of them)
    holds a CUDA tensor; CPU work is done when it returns."""
    for t in out if isinstance(out, (list, tuple)) else [out]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def device_time(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median wall seconds per call of ``fn(*args)``, each call ending in a
    wait for the card (``torch.cuda.synchronize``) when its result is there."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
