"""Dynamic range compressor / expander core, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/compressor.py``
(reference numba envelope follower, ``common_audioeffects.py:529-587``):

    x_g = 20*log10(|x|)            (floored at -120 dB below 1e-6)
    y_g = static gain curve        (ratio>1: downward comp; ratio<1: upward exp)
    x_l = x_g - y_g
    y_l[n] = max(a_att*y_l[n-1] + (1-a_att)*x_l[n], a_rel*y_l[n-1] + (1-a_rel)*x_l[n])
             (min where a_att > a_rel: the branchy reference's choice)
    y    = x * 10**(-y_l/20)

Every path goes through the envelope wrapper
(``ops/cuda/envelope.py:compressor_envelope``), which decides by the
tensor's device: the hand-written CUDA kernel on the card, its plain version
on the CPU. Not ported: the make-up gain (no caller sets one), the
chunk-parallel ``blockwise`` approximation and the sox-style ``compand``
(training and augmentation only; ROADMAP).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda.envelope import compressor_envelope

LOG10_FLOOR = 1e-6
DB_FLOOR = -120.0
LOG10_E = 0.4342944819032518  # 1/ln(10)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    """20*log10(|x|) with the reference's -120 dB floor below 1e-6. The
    log10 is ``log(x) / ln(10)``, the form ``jnp.log10`` takes (and many
    times faster than ``torch.log10`` on the CPU)."""
    mag = x.abs()
    db = 20.0 * (torch.log(mag.clamp_min(LOG10_FLOOR)) * LOG10_E)
    return torch.where(mag < LOG10_FLOOR, DB_FLOOR, db)


def static_gain_curve(x_g: torch.Tensor, threshold, ratio) -> torch.Tensor:
    """Static curve in dB: ratio > 1 compresses above the threshold, ratio < 1
    expands below it, ratio == 1 is the identity."""
    threshold = _f32(threshold, x_g.device)
    ratio = _f32(ratio, x_g.device)
    comp = torch.where(x_g >= threshold, threshold + (x_g - threshold) / ratio, x_g)
    expd = torch.where(x_g <= threshold, threshold + (x_g - threshold) * ratio, x_g)
    return torch.where(ratio > 1.0, comp, torch.where(ratio < 1.0, expd, x_g))


def alphas(attack_ms, release_ms, sample_rate, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    a_att = torch.exp(-1.0 / (0.001 * sample_rate * _f32(attack_ms, device)))
    a_rel = torch.exp(-1.0 / (0.001 * sample_rate * _f32(release_ms, device)))
    return a_att, a_rel


def _lanes(p, batch_shape, device) -> torch.Tensor:
    return _f32(p, device).broadcast_to(batch_shape).reshape(-1)


def compressor_process(
    x: torch.Tensor,
    threshold,
    attack_ms,
    release_ms,
    ratio,
    sample_rate: int = 44100,
    rows=None,
) -> torch.Tensor:
    """Full compressor over the last axis of ``x [..., T]`` (float32).

    Parameters are scalars or arrays broadcastable to ``x.shape[:-1]`` (one
    value per lane). With ``rows`` ([L] int64 on x's device), ``x`` is
    ``[R, T]``, lane l reads row ``rows[l]`` (read once, never copied per
    lane), the parameters broadcast to ``[L]`` and the result is ``[L, T]``."""
    T = x.shape[-1]
    batch_shape = x.shape[:-1] if rows is None else rows.shape
    dev = x.device
    a_att, a_rel = alphas(attack_ms, release_ms, sample_rate, dev)
    lanes = [_lanes(p, batch_shape, dev) for p in (threshold, ratio, a_att, a_rel)]
    y, _ = compressor_envelope(
        x.reshape(-1, T).contiguous(), *lanes, torch.zeros_like(lanes[0]), rows=rows
    )
    return y.reshape(*batch_shape, T)


def compress_and_clip(
    x2: torch.Tensor,  # [L, T], or [R, T] with rows
    thresholds,        # [L]
    attacks,           # [L] ms
    releases,          # [L] ms
    ratios,            # [L]
    sample_rate: int = 44100,
    rows=None,
) -> torch.Tensor:
    """Per-lane compressor + the reference's clip rule (clip only if the
    output exceeds full scale, ``utils_data_normalization.py:352-355``).
    ``rows`` as in :func:`compressor_process`."""
    y = compressor_process(x2, thresholds, attacks, releases, ratios, sample_rate, rows=rows)
    return torch.where(y.abs().amax(-1, keepdim=True) >= 1.0, y.clamp(-1.0, 1.0), y)


class CompressorStream:
    """Stateful slab-streaming compressor over ``[L, T]`` lanes.

    Feeding consecutive time slabs through :meth:`process` equals one
    :func:`compressor_process` pass over the concatenated signal: the
    envelope carries across slabs, for any slab lengths (the kernel masks
    ragged tails instead of padding them). The caller never materializes
    ``[L, T]`` for large ``L``, only ``[L, slab]``."""

    def __init__(self, thresholds, attacks, releases, ratios, sample_rate: int = 44100):
        self._th = _f32(thresholds, None).reshape(-1)
        self._ra = _f32(ratios, None).reshape(-1)
        self._a_att, self._a_rel = alphas(
            _f32(attacks, None).reshape(-1), _f32(releases, None).reshape(-1), sample_rate
        )
        self._env = torch.zeros_like(self._th)

    def process(self, x_slab: torch.Tensor, rows=None) -> torch.Tensor:
        """``[L, Ts] -> [L, Ts]`` compressed (no clip), carrying state. With
        ``rows`` ([L] int64), lane l reads row ``rows[l]`` of ``x_slab [R, Ts]``."""
        y, self._env = compressor_envelope(
            x_slab.to(torch.float32).contiguous(), self._th, self._ra, self._a_att,
            self._a_rel, self._env, rows=rows,
        )
        return y
