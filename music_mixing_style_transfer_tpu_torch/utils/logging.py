"""Logging, wall-clock timers and real-time-factor meters for the port
(counterpart of ``music_mixing_style_transfer_tpu/utils/logging.py``).

The timers read the host clock: around work on the card, the caller
synchronizes inside the timed block, or the time is the enqueue's.
"""
from __future__ import annotations

import contextlib
import logging
import sys
import time
from typing import Dict, Iterator


def get_logger(name: str = "mst_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class Timer:
    """Accumulating wall-clock timer with named sections."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "  ".join(
            f"{k}={v:.3f}s/{self.counts[k]}x" for k, v in sorted(self.totals.items())
        )


class RTFMeter:
    """Real-time-factor meter: processed audio seconds per wall second."""

    def __init__(self, sample_rate: int = 44100):
        self.sample_rate = sample_rate
        self.audio_samples = 0
        self.wall = 0.0

    @contextlib.contextmanager
    def measure(self, n_samples: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wall += time.perf_counter() - t0
            self.audio_samples += n_samples

    @property
    def rtf(self) -> float:
        if self.wall == 0:
            return float("inf")
        return (self.audio_samples / self.sample_rate) / self.wall
