"""EQ / compression matching DSP for FX normalization, in PyTorch.

Counterpart of the part of ``music_mixing_style_transfer_tpu/normalize/matching.py``
that the batched normalizer runs (reference
``mixing_manipulator/utils_data_normalization.py:65-429``):

- the average magnitude spectrum and the batched zero-phase EQ FIR design
  (scipy ``firwin2``'s construction);
- the high-frequency-content onset detector that replaces aubio, and the
  onset-aligned mean peak level;
- the compressor's (ratio, threshold) candidate grid.

Not ported yet: the per-channel path (``eq_match``, ``comp_match``,
``_comp_match_select``, ``design_eq_fir``, ``panning_match``; ROADMAP).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops.stft import frame, sqrt_hann_window, stft


def amp_to_db(x):
    return 20.0 * np.log10(x + 1e-30)


def db_to_amp(x):
    return 10.0 ** (x / 20.0)


# ===========================================================================
# EQ matching
# ===========================================================================
def average_magnitude_spectrum(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Mean |STFT| over frames of ``x [..., T]`` (sqrt-hann, center=False)."""
    return stft(x, n_fft, hop_length, sqrt_hann_window(n_fft), center=False).abs().mean(-2)


def _interp_uniform(x: torch.Tensor, m: int, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, arange(m) / (m - 1), fp)`` row-wise over ``fp [N, m]``,
    with jnp.interp's formula (searchsorted to the right, then
    ``fp[i-1] + (x - xp[i-1]) / dx * df``)."""
    xp = torch.arange(m, dtype=torch.float32, device=fp.device) / (m - 1)
    i = torch.searchsorted(xp, x, right=True).clamp(1, m - 1)
    f = fp[:, i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (fp[:, i] - fp[:, i - 1])
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def design_eq_fir_batch(
    audio_specs: torch.Tensor, ref_specs: torch.Tensor, ntaps: int = 1001
) -> torch.Tensor:
    """Batched FIR design ``[N, m] x [N, m] -> [N, ntaps]`` for the sqrt
    amplitude-ratio curve (the forward-backward filtering squares it back).

    scipy ``firwin2``'s type-I construction: interpolate the desired
    response onto a uniform ``1 + 2**ceil(log2(ntaps))``-point grid, apply
    the linear-phase shift, irfft, symmetric Hamming window."""
    m = audio_specs.shape[-1]
    diff_db = 20.0 * (torch.log10(ref_specs + 1e-30) - torch.log10(audio_specs + 1e-30))
    gain = torch.sqrt(torch.pow(10.0, diff_db / 20.0))

    nfreqs = 1 + 2 ** int(np.ceil(np.log2(ntaps)))
    # jnp.linspace(0, 1, n) in float32 is iota / (n - 1) with the end point 1
    x = torch.arange(nfreqs, dtype=torch.float32, device=gain.device) / (nfreqs - 1)
    fx = _interp_uniform(x, m, gain)
    phase = torch.tensor(-(ntaps - 1) / 2.0 * math.pi, dtype=torch.float32) * x
    shift = torch.polar(torch.ones_like(phase), phase)
    out_full = torch.fft.irfft(fx * shift[None, :], n=2 * (nfreqs - 1), dim=-1)
    n = torch.arange(ntaps, dtype=torch.float32, device=gain.device)
    wind = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (ntaps - 1))
    return (out_full[:, :ntaps] * wind[None, :]).to(torch.float32)


# ===========================================================================
# HFC onsets + mean peak
# ===========================================================================
def frame_peak_features(
    x: torch.Tensor, window_size: int = 1024, hop_size: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame ``(hfc_raw, frame_max, frame_db)`` of ``x [..., Ts]``, each
    ``[..., F]``. Purely frame-local (``window == hop``), so whole-song
    analyses stream time slabs through this and concatenate."""
    if window_size != hop_size:
        raise ValueError("streaming framing requires window_size == hop_size")
    n_frames = x.shape[-1] // hop_size
    frames = frame(x[..., : n_frames * hop_size], window_size, hop_size)
    win = torch.as_tensor(np.hanning(window_size + 1)[:-1].astype(np.float32), device=x.device)
    mag = torch.fft.rfft(frames * win, dim=-1).abs()  # [..., F, K]
    k = torch.arange(mag.shape[-1], dtype=mag.dtype, device=x.device)
    hfc_raw = (mag * k).sum(-1)
    frame_max = frames.abs().amax(-1)
    frame_db = 20.0 * torch.log10(torch.sqrt((frames * frames).mean(-1)) + 1e-12)
    return hfc_raw, frame_max, frame_db


def _edge_pad(h: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return torch.cat(
        [h[..., :1].expand(*h.shape[:-1], left), h, h[..., -1:].expand(*h.shape[:-1], right)], -1
    )


def onset_mask_from_features(
    hfc_raw: torch.Tensor,
    frame_db: torch.Tensor,
    threshold: float = 0.3,
    silence_db: float = -70.0,
    median_span: int = 5,
) -> torch.Tensor:
    """Aubio-style adaptive peak-picking over per-frame HFC ``[..., F]``: an
    onset where the globally normalized HFC exceeds its local median (window
    ``2*span + 1``, edge-padded) by ``threshold * 0.1``, is a local maximum,
    and the frame is not silent."""
    hfc = hfc_raw / hfc_raw.amax(-1, keepdim=True).clamp_min(1e-12)
    windows = frame(_edge_pad(hfc, median_span, median_span), 2 * median_span + 1, 1)
    med = windows.median(-1).values  # odd window: the middle value, as jnp.median
    prev = _edge_pad(hfc, 1, 0)[..., :-1]
    nxt = _edge_pad(hfc, 0, 1)[..., 1:]
    local_max = (hfc >= prev) & (hfc > nxt)
    return local_max & (frame_db > silence_db) & (hfc > med + threshold * 0.1)


def hfc_onset_mask(
    x: torch.Tensor,
    window_size: int = 1024,
    hop_size: int = 1024,
    threshold: float = 0.3,
    silence_db: float = -70.0,
    median_span: int = 5,
) -> torch.Tensor:
    """Boolean onset mask per frame for ``x [..., T]``."""
    T = x.shape[-1]
    if T < window_size or T // hop_size == 0:
        return torch.zeros(x.shape[:-1] + (0,), dtype=torch.bool, device=x.device)
    hfc_raw, _, frame_db = frame_peak_features(x, window_size, hop_size)
    return onset_mask_from_features(hfc_raw, frame_db, threshold, silence_db, median_span)


def mean_peak_from_frames(
    frame_max: torch.Tensor, onset_mask: torch.Tensor, percentile: float = 75.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) of the dB peak levels of the inter-onset segments, from
    per-frame maxima ``[..., F]`` (reference ``get_mean_peak``,
    ``utils_data_normalization.py:284-338``): the peaks above the segments'
    ``percentile``, or all of them when none is above."""
    batch_shape, n_frames = frame_max.shape[:-1], frame_max.shape[-1]
    dev = frame_max.device
    # segment id per frame: the number of onsets at or before it (0 = pre-onset)
    seg_ids = torch.cumsum(onset_mask.to(torch.int64), -1).reshape(-1, n_frames)
    flat_fm = frame_max.reshape(-1, n_frames)
    n_segs = n_frames + 1
    seg_max = torch.zeros(flat_fm.shape[0], n_segs, dtype=flat_fm.dtype, device=dev)
    seg_max = seg_max.scatter_reduce(1, seg_ids, flat_fm, "amax", include_self=True)
    seg_cnt = torch.zeros(flat_fm.shape[0], n_segs, dtype=torch.int64, device=dev)
    seg_cnt = seg_cnt.scatter_add(1, seg_ids, torch.ones_like(seg_ids))
    seg_max = seg_max.reshape(*batch_shape, n_segs)
    seg_cnt = seg_cnt.reshape(*batch_shape, n_segs)
    valid = (seg_cnt > 0) & (torch.arange(n_segs, device=dev) > 0)  # drop pre-onset

    p_db = torch.where(valid, 20.0 * torch.log10(seg_max + 1e-30), torch.nan)
    nan = torch.isnan(p_db)
    thr = torch.nanquantile(p_db, percentile / 100.0, dim=-1, keepdim=True, interpolation="linear")
    above = (p_db > thr) & ~nan

    def masked_stats(m):
        m = m & ~nan
        n = m.sum(-1).clamp_min(1)
        mean = torch.where(m, p_db, 0.0).sum(-1) / n
        var = torch.where(m, (p_db - mean[..., None]) ** 2, 0.0).sum(-1) / n
        return mean, torch.sqrt(var)

    mean_a, std_a = masked_stats(above)
    mean_all, std_all = masked_stats(torch.ones_like(above))
    use_above = above.sum(-1) > 0
    return torch.where(use_above, mean_a, mean_all), torch.where(use_above, std_a, std_all)


def mean_peak_db(
    x: torch.Tensor, onset_mask: torch.Tensor, hop_size: int = 1024, percentile: float = 75.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) of dB peak levels in inter-onset intervals of ``x [..., T]``,
    onsets frame-aligned."""
    n_frames = onset_mask.shape[-1]
    xs = x[..., : n_frames * hop_size].abs().reshape(*x.shape[:-1], n_frames, hop_size)
    return mean_peak_from_frames(xs.amax(-1), onset_mask, percentile=percentile)


def measure_mean_peak(x: torch.Tensor, percentile: float = 75.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Onsets + peak statistics for ``x [..., T]``."""
    return mean_peak_db(x, hfc_onset_mask(x), percentile=percentile)


# ===========================================================================
# compression matching: the candidate grid
# ===========================================================================
def _comp_grid(ratio: float, min_th: float, max_ratio: float, expander: bool):
    """(ratio, threshold) candidate grid in the reference's search order
    (``utils_data_normalization.py:386-409``), ratio in the outer loop."""
    ratios = np.linspace(ratio, max_ratio, int(max_ratio - ratio + 1))
    if expander:
        ths = np.linspace(-1, min_th, int(2 * abs(min_th) - 1))[::-1]
    else:
        ths = np.linspace(-1 - 9, min_th, int(2 * abs(min_th) - 1 - 18))
    R, T = np.meshgrid(ratios, ths, indexing="ij")
    return R.reshape(-1).astype(np.float32), T.reshape(-1).astype(np.float32)
