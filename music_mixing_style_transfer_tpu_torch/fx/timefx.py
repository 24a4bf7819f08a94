"""Time/pitch-manipulation processors (sox replacements), in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/fx/timefx.py``: the
reference's libsox effects PitchShift / TimeStretch / PlaybackSpeed / Bend
(``common_audioeffects.py:1132-1422``). None is in the default instrument
chains (``audio_effects_chain.py:113-162``). Their factors change the output
geometry, so unlike the core processors they draw on the host from a numpy
``Generator``, with the JAX package's draws and quantisation: the same
numpy seed gives both packages the same parameters.

Each processor: ``sample_host(rng) -> params`` / ``apply(params, x)`` with
``x [..., 2, T]`` on any device; outputs keep the input length, as the
reference's ``fix_length=True``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.resample import bend, pitch_shift, playback_speed, time_stretch


def _round_factor(v: float, q: float = 0.01) -> float:
    """Quantise a host-drawn factor (bounds the JAX package's jit cache)."""
    return round(v / q) * q


def _headroom(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` run at a peak of at most 0.9 and scaled back."""
    scale = float(x.abs().max())
    y = x * (0.9 / scale) if scale > 0.9 else x
    y = fn(y)
    return y * (scale / 0.9) if scale > 0.9 else y


class PitchShift:
    """Pitch shift in semitones (reference :1132-1199)."""

    name = "pitch_shift"

    def __init__(self, sample_rate=44100, steps_range=(-6.0, 6.0)):
        self.steps_range = steps_range

    def sample_host(self, rng: np.random.Generator) -> Dict[str, float]:
        return {"steps": _round_factor(rng.uniform(*self.steps_range), 0.05)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        if params["steps"] == 0.0:
            return x
        return _headroom(lambda y: pitch_shift(y, params["steps"]), x)


class TimeStretch:
    """Tempo change without pitch change (reference :1203-1279)."""

    name = "time_stretch"

    def __init__(self, sample_rate=44100, factor_range=(1 / 1.33, 1.33)):
        self.factor_range = factor_range

    def sample_host(self, rng: np.random.Generator) -> Dict[str, float]:
        return {"factor": _round_factor(rng.uniform(*self.factor_range))}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        if params["factor"] == 1.0:
            return x
        return _headroom(lambda y: time_stretch(y, params["factor"]), x)


class PlaybackSpeed:
    """Rate change, duration and pitch (reference :1283-1347)."""

    name = "playback_speed"

    def __init__(self, sample_rate=44100, factor_range=(1 / 1.33, 1.33)):
        self.factor_range = factor_range

    def sample_host(self, rng: np.random.Generator) -> Dict[str, float]:
        return {"factor": _round_factor(rng.uniform(*self.factor_range))}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        if params["factor"] == 1.0:
            return x
        return _headroom(lambda y: playback_speed(y, params["factor"]), x)


class Bend:
    """Per-segment random pitch bends (reference :1351-1422)."""

    name = "bend"

    def __init__(self, sample_rate=44100, pitch_range=(-600, 600), n_bends_range=(2, 10)):
        self.sample_rate = sample_rate
        self.pitch_range = pitch_range
        self.n_bends_range = n_bends_range

    def sample_host(self, rng: np.random.Generator, n_samples: int) -> Dict[str, np.ndarray]:
        n = int(rng.integers(self.n_bends_range[0], self.n_bends_range[1] + 1))
        boundaries = np.sort(rng.integers(1, max(n_samples - 1, 2), size=n - 1))
        cents = rng.integers(self.pitch_range[0], self.pitch_range[1] + 1, size=n)
        cents = np.round(cents / 25) * 25  # quantised, as the JAX package draws them
        return {"boundaries": boundaries, "cents": cents}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        return bend(x, params["boundaries"], params["cents"])
