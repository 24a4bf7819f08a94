"""Device profiling and the port's tracing (counterpart of
``music_mixing_style_transfer_tpu/utils/profiling.py``, the reference has
none): a ``torch.profiler`` trace exported for Chrome's trace viewer or
Perfetto, the program's spans and counters, and a per-call wall time that
waits for the card.

Tracing is on exactly while a ``torch.profiler`` session records, whoever
started it; there is no other switch. Then :func:`span` opens a
``record_function`` range, which the trace holds as a ``user_annotation``
event on the profiler's own clock, beside the card's kernels, and
:func:`count` keeps a record in memory. Off, a span is a shared null
context and a count returns at once: one check of a flag each.
Span names are the port's module paths (``normalize.eq``,
``models.tcn.plain``); a counter is named after the site that records it.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_records: Dict[str, List[Any]] = {}


def _tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording (in any thread)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while tracing, else a shared null
    context (no ``record_function`` is made)."""
    return torch.profiler.record_function(name) if _tracing() else _OFF


def spanned(name: str):
    """The decorator form of :func:`span`: each call inside span ``name``,
    decided at the call."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return wrap


def count(name: str, record: Any) -> None:
    """Append ``record`` to counter ``name`` while tracing; nothing else."""
    if _tracing():
        _records.setdefault(name, []).append(record)


def records(name: str) -> List[Any]:
    """Counter ``name``'s records, oldest first (a copy)."""
    return list(_records.get(name, ()))


def clear() -> None:
    """Empty every counter."""
    _records.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block (host ops, and the card's kernels where there is a
    card), with the counters emptied at its start, and write
    ``<log_dir>/trace.json`` (Chrome trace format) unless ``log_dir`` is
    ``None``. Yields the profiler, whose ``key_averages()`` sums time by
    operation and whose ``events()`` hold the spans."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
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
