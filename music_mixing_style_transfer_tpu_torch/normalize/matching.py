"""EQ / compression matching DSP for FX normalization, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/normalize/matching.py``
(reference ``mixing_manipulator/utils_data_normalization.py:65-429``):

- EQ matching: the average magnitude spectrum, the zero-phase FIR design
  (scipy ``firwin2`` on the host per channel, or its construction batched
  on the device) and its application (``eq_match``);
- panning matching (dataset-prep normalization, ``panning_match``);
- the high-frequency-content onset detector that replaces aubio, and the
  onset-aligned mean peak level;
- compression matching of one channel (``comp_match``): the reference's
  (ratio, threshold) search as sweeps of 96 candidates through the
  envelope kernel (K2), the channel read once for all of them (``rows``),
  stopping at the first chunk that holds a satisfying candidate.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.signal
import torch

from ..ops.biquad import filtfilt_fir
from ..ops.compressor import compress_and_clip
from ..ops.loudness import lufs_normalize, peak_normalize
from ..ops.stft import frame, istft, sqrt_hann_window, stft


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


def design_eq_fir(audio_spec: np.ndarray, ref_spec: np.ndarray, ntaps: int = 1001) -> np.ndarray:
    """Host-side FIR design for the sqrt amplitude-ratio curve (reference
    ``utils_data_normalization.py:82-98``; filtering forward and backward
    squares the response back to the full ratio)."""
    m = ref_spec.shape[0]
    frq = np.arange(m) / (m / 1.0)
    frq = frq / np.max(frq)
    diff = np.sqrt(db_to_amp(amp_to_db(ref_spec) - amp_to_db(audio_spec)))
    return scipy.signal.firwin2(ntaps, frq, diff, window="hamming").astype(np.float32)


def eq_match(
    audio: torch.Tensor,
    ref_spec: np.ndarray,
    sr: int = 44100,
    n_fft: int = 2**16,
    hop_length: int = 2**14,
    min_db: float = -50.0,
    ntaps: int = 1001,
    lufs: float = -30.0,
) -> torch.Tensor:
    """Match a mono channel ``[T]`` to the target average spectrum: LUFS
    normalization and the average spectrum on the device, the FIR design on
    the host, the zero-phase filtering on the device."""
    if amp_to_db(float(audio.abs().max())) <= min_db:
        return audio
    audio = lufs_normalize(audio, sr, lufs)
    spec = average_magnitude_spectrum(audio, n_fft, hop_length).cpu().numpy()
    taps = design_eq_fir(spec, np.asarray(ref_spec), ntaps)
    return filtfilt_fir(audio, torch.from_numpy(taps).to(audio.device))


# ===========================================================================
# panning matching (dataset-prep normalization)
# ===========================================================================
def _sps(x: torch.Tensor, n_fft: int, hop: int):
    """Stereo panning spectrum of ``[T, 2]`` audio (reference ``get_SPS``,
    ``utils_data_normalization.py:109-139``): ``(sps, phi)``, each
    ``[F, bins]``. eps is 1e-8, not the reference's float64 1e-20, whose
    square underflows in float32."""
    spec = stft(x.T, n_fft, hop, sqrt_hann_window(n_fft), center=False)  # [2, F, bins]
    eps = 1e-8
    L = spec[0].abs() + eps
    R = spec[1].abs() + eps
    phi = 2 * (L * R) / (L**2 + R**2)
    delta_sign = torch.sign((L * R) / L**2 - (R * L) / R**2)
    return (1 - phi) * delta_sign, phi


def _panning_gains(phi: torch.Tensor, side) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin (L, R) gains from the similarity measure (reference
    ``get_panning_param_values`` :157-177)."""
    g = (phi + 1e-30).clamp(0, 1) / 2
    p = 1.0 - g if side > 0 else g if side < 0 else torch.full_like(g, 0.5)
    return 1.0 - p, p


def panning_match(
    audio: torch.Tensor,
    ref_phi: np.ndarray,
    sr: int = 44100,
    n_fft: int = 2048,
    hop_length: int = 1024,
    min_db_f: float = -10.0,
    max_freq_pan: float = 16000.0,
) -> torch.Tensor:
    """Match the stereo panning spectrum of ``[2, T]`` audio to a target
    (reference ``get_panning_matching``, ``utils_data_normalization.py:179-280``):
    pre-pan toward the dominant side, then scale the L/R STFT magnitudes by
    the per-frame gain ratio toward the target, gated for quiet frames and
    for frequencies above ``max_freq_pan``."""
    T = audio.shape[-1]
    x = torch.nn.functional.pad(audio, (n_fft, n_fft))
    sps_frames, _ = _sps(x.T, n_fft, hop_length)
    sps_sm = scipy.signal.savgol_filter(
        sps_frames.mean(0).cpu().numpy(), 501, 1, mode="mirror"
    )
    f1 = int(np.floor(50 * n_fft / sr))
    f2 = int(np.floor(2500 * n_fft / sr))
    m = np.mean(np.sign(sps_sm[f1:f2] + 1e-10))
    side = m / abs(m) if m != 0 else 0.0

    alpha = 0.7 if side > 0 else 0.3
    x = x * torch.tensor([1.0 - alpha, alpha], dtype=torch.float32, device=x.device)[:, None]

    _, phi_frames = _sps(x.T, n_fft, hop_length)
    gl_i, gr_i = _panning_gains(phi_frames, side)
    gl_r, gr_r = _panning_gains(
        torch.as_tensor(ref_phi, dtype=torch.float32, device=x.device)[None, :], side
    )
    g_l = gl_r / (gl_i + 1e-20)
    g_r = gr_r / (gr_i + 1e-20)

    win = sqrt_hann_window(n_fft)
    spec = stft(x, n_fft, hop_length, win, center=False)  # [2, F, bins]
    mono_mag = (spec[0] + spec[1]).abs()
    quiet = 20 * torch.log10(mono_mag.amax(-1, keepdim=True) + 1e-30) < min_db_f
    band = (torch.arange(g_l.shape[-1], device=x.device) < int(np.floor(max_freq_pan * n_fft / sr)))[None, :]
    g_l = torch.where(quiet | ~band, 1.0, g_l)
    g_r = torch.where(quiet | ~band, 1.0, g_r)
    new_spec = torch.stack([
        torch.polar(spec[0].abs() * g_l, spec[0].angle()),
        torch.polar(spec[1].abs() * g_r, spec[1].angle()),
    ])
    return istft(new_spec, hop_length, win, center=False)[:, n_fft : n_fft + T]


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
# compression matching
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


class MatchingError(ArithmeticError):
    """A matching with no answer for its input. The per-channel normalizer
    lets the channel through unchanged on it, as the reference does on its
    matching's failures (``data_normalization.py:120-139``)."""


def _grid_compress(x, ratios, ths, attack, release, sample_rate, mode):
    """Compress the channel ``x [T]`` against a chunk of (ratio, threshold)
    candidates: ``[G, T]``. Every lane reads the one row of ``x`` through
    the envelope kernel's ``rows``; the channel is never copied per lane."""
    rr = ratios if mode == "down" else 1.0 / ratios
    rows = torch.zeros(len(ratios), dtype=torch.int64, device=x.device)
    return compress_and_clip(
        x.reshape(1, -1).contiguous(), ths, attack, release, rr, sample_rate, rows=rows
    )


def _grid_peaks(x, ratios, ths, attack, release, sample_rate, percentile, mode):
    y = _grid_compress(x, ratios, ths, attack, release, sample_rate, mode)
    peaks, _ = measure_mean_peak(y, percentile=percentile)
    return peaks


def _grid_one(x, ratio, th, attack, release, sample_rate, mode):
    return _grid_compress(
        x, np.reshape(ratio, (1,)), np.reshape(th, (1,)), attack, release, sample_rate, mode
    )[0]


def _comp_match_select(
    x: torch.Tensor,
    ratios: np.ndarray,
    ths: np.ndarray,
    attack: float,
    release: float,
    ref_peak: float,
    ref_std: float,
    sample_rate: int,
    percentile: float,
    mode: str,
    chunk: int = 96,
) -> torch.Tensor:
    """Sweep the candidate grid in chunks of ``chunk`` (the last one padded
    with the last candidate), stop at the first chunk that holds a
    satisfying candidate, take the first satisfying one in the reference's
    order (``utils_data_normalization.py:386-424``; the last candidate when
    none satisfies), and compress with it alone."""
    G = len(ratios)
    if G == 0:
        raise MatchingError("empty (ratio, threshold) candidate grid")
    chosen = G - 1
    for lo in range(0, G, chunk):
        r = np.full(chunk, ratios[-1], np.float32)
        t = np.full(chunk, ths[-1], np.float32)
        n = min(chunk, G - lo)
        r[:n] = ratios[lo : lo + n]
        t[:n] = ths[lo : lo + n]
        peaks = _grid_peaks(
            x, r, t, attack, release, sample_rate, percentile, mode
        ).cpu().numpy()[:n]
        ok = peaks < (ref_peak + ref_std) if mode == "down" else peaks > (ref_peak - ref_std)
        if ok.any():
            chosen = lo + int(np.argmax(ok))
            break
    return _grid_one(x, ratios[chosen], ths[chosen], attack, release, sample_rate, mode)


def comp_match(
    audio: torch.Tensor,
    ref_peak: float,
    ref_std: float,
    ratio: float,
    attack_ms: float,
    release_ms: float,
    sr: int = 44100,
    min_db: float = -50.0,
    comp_peak_norm: float = -10.0,
    min_th: float = -40.0,
    max_ratio: float = 20.0,
    percentile: float = 75.0,
    expander: bool = True,
) -> torch.Tensor:
    """Compression matching of a mono channel ``[T]`` (reference
    ``get_comp_matching``, ``utils_data_normalization.py:357-429``):
    downward compression when the onset-peak feature is above the target
    band, upward expansion (optional) when below, unchanged in the band."""
    if amp_to_db(float(audio.abs().max())) <= min_db:
        return audio
    x = peak_normalize(audio, comp_peak_norm)
    peak = float(measure_mean_peak(x, percentile=percentile)[0])
    if (ref_peak - ref_std) < peak < (ref_peak + ref_std):
        return x
    if peak > ref_peak - ref_std:  # too dynamic: downward compression
        R, T = _comp_grid(ratio, min_th, max_ratio, expander=False)
        mode = "down"
    elif expander:  # too flat: upward expansion
        R, T = _comp_grid(ratio, min_th, max_ratio, expander=True)
        mode = "up"
    else:
        return x
    return _comp_match_select(
        x, R, T, attack_ms, release_ms, ref_peak, ref_std, sr, percentile, mode
    )
