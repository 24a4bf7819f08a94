"""Resampling and phase-vocoder time/pitch manipulation, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/resample.py``, the
stand-ins for the reference's libsox processors (``common_audioeffects.py``:
PitchShift :1132-1199, TimeStretch :1203-1279, PlaybackSpeed :1283-1347,
Bend :1351-1422; none is in the default training chains):

- ``sinc_resample``: windowed-sinc interpolation, the cutoff lowered to
  anti-alias when it plays faster (a gather and a weighted sum);
- ``phase_vocoder``: STFT phase-vocoder time stretching;
- ``pitch_shift``: time stretch, then playback-speed resample.

The float32 arithmetic follows the JAX package's where it decides a value:
the sample positions of ``sinc_resample`` are float32 products, so at long
outputs their fractional parts are quantised (at 2^19 samples and factor
1.33, to 1/16 of a sample), as in the JAX package; the frame steps of the
vocoder are ``np.arange`` in float32, as ``jnp.arange`` takes them.
"""
from __future__ import annotations

import numpy as np
import torch

from .stft import hann_window, istft, stft


def sample_positions(out_len: int, factor: float, device=None) -> torch.Tensor:
    """The positions ``n * factor`` of :func:`sinc_resample`, float32
    products of float32 operands, as the JAX package computes them (see the
    module docstring)."""
    f = torch.tensor(factor, dtype=torch.float32, device=device)
    return torch.arange(out_len, dtype=torch.float32, device=device) * f


def frame_steps(n_frames: int, rate: float) -> np.ndarray:
    """The analysis positions of :func:`phase_vocoder`, ``jnp.arange(0,
    n_frames - 1, rate)``: numpy's float32 ``arange``, whose values (filled
    in float32) are not ``torch.arange``'s (rounded from float64); at
    ``n_frames`` 65 and ``rate`` 1.05 their floors differ at step 60."""
    return np.arange(0, n_frames - 1, rate, dtype=np.float32)


def sinc_resample(x: torch.Tensor, factor: float, out_len: int, width: int = 32) -> torch.Tensor:
    """``y[n] = x(n * factor)`` by windowed-sinc interpolation: ``x [..., T]``
    -> ``[..., out_len]``. ``factor > 1`` plays faster (sox ``speed``) and
    lowers the cutoff to anti-alias. The gather is ``[..., out_len, 2 *
    width + 1]`` (~270 MB for a stereo 2^19-sample signal)."""
    T = x.shape[-1]
    dev = x.device
    t = sample_positions(out_len, factor, dev)
    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0
    cutoff = torch.clamp(1.0 / torch.tensor(factor, dtype=torch.float32, device=dev), max=1.0) * 0.98
    j = torch.arange(-width, width + 1, dtype=torch.float32, device=dev)
    arg = j[None, :] - frac[:, None]  # [out_len, K]
    kernel = cutoff * torch.sinc(cutoff * arg)
    win = 0.5 + 0.5 * torch.cos(np.pi * torch.clamp(arg / width, -1.0, 1.0))
    kernel = kernel * win
    idx = (i0[:, None] + j[None, :].to(torch.int64)).clamp_(0, T - 1)
    return (x[..., idx] * kernel.to(x.dtype)).sum(-1)


def _fix_length(y: torch.Tensor, T: int) -> torch.Tensor:
    """Centre-crop or centre-pad the last axis to ``T``."""
    L = y.shape[-1]
    if L > T:
        i0 = (L - T) // 2
        return y[..., i0 : i0 + T]
    if L < T:
        pad = T - L
        return torch.nn.functional.pad(y, (pad // 2, pad - pad // 2))
    return y


def playback_speed(x: torch.Tensor, factor: float, fix_length: bool = True) -> torch.Tensor:
    """sox ``speed``: change the rate (duration and pitch) by ``factor``;
    with ``fix_length`` centre-cropped or centre-padded back to the input
    length (reference :1336-1345)."""
    T = x.shape[-1]
    y = sinc_resample(x, float(factor), int(round(T / factor)))
    return _fix_length(y, T) if fix_length else y


def phase_vocoder(x: torch.Tensor, rate: float, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """Time-stretch ``x [..., T]`` by ``rate`` (> 1: faster, shorter) with a
    Hann phase vocoder; the output is ~T/rate long.

    The phase arithmetic runs in float64 from the float32 spectrum: the
    output phase grows by up to pi/2 a bin a frame (~1e5 rad after 1000
    frames, where a float32 ulp is ~8e-3 rad), and each frame's increment
    ``phi_adv + princarg(dphi - phi_adv)`` passes through values ~1600 rad
    at the top bins (a float32 ulp ~1.2e-4). In float32, as the JAX package
    takes them, those roundings put the output ~1e-3 of its max from a
    float64 run even at 2^14 samples, and a card and a CPU, summing in
    other orders, would disagree as much. The increments are ``dphi``
    plus a multiple of 2 pi either way, so the float64 arithmetic is the
    same function with fewer roundings; the spectrum is rounded to
    complex64 once."""
    win = hann_window(n_fft, periodic=True)
    D = stft(x, n_fft, hop, win, center=True)  # [..., F, bins]
    n_frames = D.shape[-2]
    dev = x.device
    steps = torch.from_numpy(frame_steps(n_frames, rate)).to(dev)
    lo = torch.floor(steps).to(torch.int64)
    frac = (steps - lo)[:, None]

    mag_lo = D[..., lo, :].abs()
    mag_hi = D[..., lo + 1, :].abs()
    mag = (1 - frac) * mag_lo + frac * mag_hi

    # the phase arithmetic in float64 (module docstring)
    phase = torch.angle(D.to(torch.complex128))
    bins = torch.arange(D.shape[-1], dtype=torch.float64, device=dev)
    phi_adv = (2.0 * np.pi * hop / n_fft) * bins
    dphase = phase[..., lo + 1, :] - phase[..., lo, :] - phi_adv
    dphase = dphase - 2.0 * np.pi * torch.round(dphase / (2.0 * np.pi))
    inc = phi_adv + dphase  # [..., S, bins]

    # accumulated output phase: phi[s] = phi0 + sum_{u<s} inc[u]
    csum = torch.cumsum(inc, dim=-2)
    csum = torch.cat([torch.zeros_like(csum[..., :1, :]), csum[..., :-1, :]], dim=-2)
    spec = torch.polar(mag.double(), phase[..., :1, :] + csum).to(D.dtype)
    return istft(spec, hop, win, center=True)


def time_stretch(x: torch.Tensor, factor: float, fix_length: bool = True) -> torch.Tensor:
    """sox ``tempo``: change the duration (not the pitch) by 1/factor
    (factor > 1: faster)."""
    y = phase_vocoder(x, factor)
    return _fix_length(y, x.shape[-1]) if fix_length else y


def pitch_shift(x: torch.Tensor, semitones: float, fix_length: bool = True) -> torch.Tensor:
    """sox ``pitch``: shift the pitch and keep the duration: a phase-vocoder
    stretch by 1/f, then playback speed f, with f = 2^(semitones/12)."""
    f = 2.0 ** (semitones / 12.0)
    stretched = phase_vocoder(x, 1.0 / f)  # duration ~ T*f, pitch unchanged
    y = sinc_resample(stretched, float(f), int(round(stretched.shape[-1] / f)))
    return _fix_length(y, x.shape[-1]) if fix_length else y


def bend(x: torch.Tensor, boundaries: np.ndarray, cents: np.ndarray) -> torch.Tensor:
    """sox ``bend``: pitch-shift successive segments by the given cents.
    ``boundaries`` are sample indices into the last axis; a segment shorter
    than 4096 samples, or of 0 cents, passes through."""
    T = x.shape[-1]
    bounds = [0] + [int(b) for b in boundaries] + [T]
    parts = []
    for i in range(len(bounds) - 1):
        seg = x[..., bounds[i] : bounds[i + 1]]
        if seg.shape[-1] < 4096 or cents[i] == 0:
            parts.append(seg)
        else:
            parts.append(pitch_shift(seg, float(cents[i]) / 100.0))
    return torch.cat(parts, dim=-1)
