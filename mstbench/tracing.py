"""Spans around the program's layers, and the reading of a profiler trace.

Spans are ``torch.profiler`` ranges (``record_function``) opened from the
benchmark's own files: forward pre-hooks and hooks on modules, and wrappers
on instance methods. They cost nothing unless a traced run installs them.
A traced window is one ``torch.profiler`` session; its Chrome trace is
read back into :class:`Trace`, which attributes each device operation to
the span that was open on the host when the operation was launched.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import os
import pickle
import subprocess
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .trace_file import WINDOW, _merge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spans:
    """Profiler ranges opened by hooks and wrappers; :meth:`close_all`
    ends the ranges left open by a call that raised."""

    def __init__(self):
        self._open: List = []
        self._undo: List = []

    def _enter(self, name: str) -> None:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._open.append(rf)

    def _exit(self) -> None:
        if self._open:
            self._open.pop().__exit__(None, None, None)

    def close_all(self) -> None:
        while self._open:
            self._exit()

    def module(self, module: torch.nn.Module, name: str, on_call=None) -> None:
        """A span around every call of ``module``; ``on_call(module, args)``
        runs in the pre-hook (to count the call's shapes)."""
        def pre(mod, args):
            if on_call is not None:
                on_call(mod, args)
            self._enter(name)

        self._undo.append(module.register_forward_pre_hook(pre))
        self._undo.append(module.register_forward_hook(lambda *a: self._exit()))

    def method(self, obj, attr: str, name: str) -> None:
        """A span around every call of ``obj.attr`` (an instance attribute
        shadows the class's method until :meth:`remove`)."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, wrapped)
        self._undo.append(_Restore(obj, attr))

    def remove(self) -> None:
        self.close_all()
        while self._undo:
            self._undo.pop().remove()


class _Restore:
    def __init__(self, obj, attr):
        self.obj, self.attr = obj, attr

    def remove(self):
        if self.attr in vars(self.obj):
            delattr(self.obj, self.attr)


@contextlib.contextmanager
def profiled(path: str, cuda: bool = True, mark=None):
    """Profile the block (the host, and the card with ``cuda``) inside a
    :data:`WINDOW` range and write its Chrome trace to ``path``;
    ``mark(phase)`` times the profiler's stop and the export."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    if mark is not None:
        mark("trace_stop")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    if mark is not None:
        mark("trace_export")


class Trace:
    """One traced window. Times are seconds; ``ops`` are the device's
    operations ``(name, start, end, launch_time)``."""

    def __init__(self, path: str):
        out = path + ".pickle"
        try:  # read in a process of its own: this one checks its outputs meanwhile
            done = subprocess.run([sys.executable, "-m", "mstbench.trace_file", path, out],
                                  cwd=ROOT, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"reading {path} failed: {done.stderr[-2000:]}")
            with open(out, "rb") as f:
                got = pickle.load(f)
        finally:
            if os.path.exists(out):
                os.remove(out)
        self.window = got["window"]
        self.window_s = self.window[1] - self.window[0]
        self.ops = got["ops"]
        self.spans = got["spans"]
        self._starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        self._host = got["host"]
        self._host_starts = [a for a, _, _ in self._host]
        w0, w1 = self.window
        self.busy = _merge([(max(a, w0), min(b, w1)) for _, a, b, _ in self.ops if b > w0 and a < w1])
        self.busy_s = sum(b - a for a, b in self.busy)

    def _around(self, name: str, t: Optional[float]) -> Optional[Tuple[float, float]]:
        """The interval of span ``name`` that holds host time ``t``."""
        if t is None or name not in self.spans:
            return None
        i = bisect.bisect_right(self._starts[name], t) - 1
        return self.spans[name][i] if i >= 0 and t <= self.spans[name][i][1] else None

    def in_span(self, name: str, t: Optional[float]) -> bool:
        return self._around(name, t) is not None

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside span ``name``;
        ``None`` when the span never opened."""
        if name not in self.spans:
            return None
        return sum(b - a for _, a, b, t in self.ops if self.in_span(name, t))

    def kernels(self, fragment: str) -> List[float]:
        """Durations of the device operations whose name holds ``fragment``."""
        return [b - a for n, a, b, _ in self.ops if fragment in n]

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, a, b, _ in self.ops:
            tot[n[:160]] += b - a
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def _host_label(self, t: float) -> str:
        held = [(iv[1] - iv[0], name) for name in self.spans
                for iv in [self._around(name, t)] if iv is not None]
        span = min(held)[1] if held else None
        i = bisect.bisect_right(self._host_starts, t) - 1
        op = self._host[i][2] if i >= 0 and t <= self._host[i][1] else "python"
        return f"{span}/{op}" if span else op

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host was
        doing when each gap began: the innermost benchmark span open then,
        and the outermost host operation running."""
        w0, w1 = self.window
        edges = [w0] + [x for ab in self.busy for x in ab] + [w1]
        tot: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                tot[self._host_label(a)] += b - a
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
