"""Objective audio evaluation metrics, the port's own copy.

Counterpart of ``music_mixing_style_transfer_tpu/metrics.py``: a
self-contained numpy re-implementation of the reference's metric library
(``mixing_manipulator/utils_data_normalization.py:483-905`` and
``fx_utils.py:276-313``) without librosa/sklearn/pyloudnorm:

- loudness features: MAPE of integrated LUFS and dB peak
- spectral features: centroid / bandwidth / contrast (low-mid-high) /
  rolloff / flatness, windowed running means, MAPE vs target
- panning features: SPS (stereo panning spectrum) RMS in 4 frequency bands
- dynamic features: frame RMS, dynamic spread, crest factor, low/full
  spectral-energy ratio
- MFCC distance (mel filterbank + DCT-II)

These are evaluation-time host utilities (numpy and scipy); the
K-weighting coefficients come from the port's ``ops/loudness.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.fft
import scipy.signal

from .ops.loudness import k_weighting_coeffs

EPS64 = np.finfo(np.float64).eps


# ===========================================================================
# small primitives
# ===========================================================================
def amp_to_db(x):
    return 20.0 * np.log10(np.abs(x) + 1e-30)


def mape(y_true, y_pred) -> float:
    """sklearn.mean_absolute_percentage_error semantics."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    return float(np.mean(np.abs(y_true - y_pred) / np.maximum(np.abs(y_true), EPS64)))


def peak_normalize(x: np.ndarray, target_db: float = -1.0) -> np.ndarray:
    peak = np.max(np.abs(x)) + 1e-30
    return x * (10 ** (target_db / 20.0) / peak)


def running_mean_std(x: np.ndarray, N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Moving window mean/std (reference ``running_mean_std`` :53-63)."""
    c1 = np.cumsum(np.insert(np.asarray(x, np.float64), 0, 0))
    c2 = np.cumsum(np.insert(np.asarray(x, np.float64) ** 2, 0, 0))
    mean = (c1[N:] - c1[:-N]) / N
    var = (c2[N:] - c2[:-N]) / N - mean * mean
    return mean, np.sqrt(np.maximum(var, 0))


def _stft_mag(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| per channel: [T, C] -> [C, bins, frames] (sqrt-hann, center=False)."""
    win = np.sqrt(np.hanning(n_fft + 1)[:-1])
    T, C = x.shape
    n_frames = 1 + (T - n_fft) // hop
    out = np.empty((C, n_fft // 2 + 1, n_frames), np.float64)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    for c in range(C):
        frames = x[:, c][idx] * win
        out[c] = np.abs(np.fft.rfft(frames, axis=-1)).T
    return out


# ===========================================================================
# loudness
# ===========================================================================
def integrated_loudness_np(x: np.ndarray, sr: int = 44100) -> float:
    """Host-side BS.1770-4 integrated loudness (numpy/scipy).

    Same algorithm as ``ops.loudness.integrated_loudness`` (K-weighting
    biquads, 400 ms blocks @ 75% overlap, -70 LUFS absolute + relative
    gating), with the biquads in float64 by scipy ``lfilter``, on any file
    length. ``x [T]`` or ``[T, C]``."""
    if x.ndim == 1:
        x = x[:, None]
    (sc, _), (hc, _) = k_weighting_coeffs(sr)
    y = np.asarray(x, np.float64).T  # [C, T]
    for c in (sc.numpy().astype(np.float64), hc.numpy().astype(np.float64)):
        y = scipy.signal.lfilter([c[0], c[1], c[2]], [1.0, c[3], c[4]], y, axis=-1)
    C = y.shape[0]
    G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])[:C]
    block, hop = int(0.4 * sr), int(0.4 * sr * 0.25)
    num_blocks = int(round((x.shape[0] / sr - 0.4) / 0.1)) + 1
    if num_blocks <= 0:
        return -np.inf
    usable = hop * (num_blocks - 1) + block
    if usable > y.shape[-1]:
        y = np.pad(y, ((0, 0), (0, usable - y.shape[-1])))
    idx = np.arange(num_blocks)[:, None] * hop + np.arange(block)[None, :]
    z = np.mean(y[:, idx] ** 2, axis=-1)  # [C, J]
    l_j = -0.691 + 10 * np.log10(np.maximum((G[:, None] * z).sum(axis=0), 1e-30))
    mask = l_j > -70.0
    if not mask.any():
        return -np.inf
    z_avg = (z * mask).sum(axis=1) / mask.sum()
    gamma_r = -0.691 + 10 * np.log10(np.maximum((G * z_avg).sum(), 1e-30)) - 10.0
    mask &= l_j > gamma_r
    if not mask.any():
        return -np.inf
    z_avg = (z * mask).sum(axis=1) / mask.sum()
    return float(-0.691 + 10 * np.log10(np.maximum((G * z_avg).sum(), 1e-30)))


def compute_loudness_features(
    audio_out: np.ndarray, audio_tar: np.ndarray, sr: int = 44100
) -> Dict[str, List[float]]:
    """``[T, C]`` inputs; MAPE of LUFS and of peak dB
    (reference :483-507)."""
    peak_tar_db = 20 * np.log10(np.max(np.abs(audio_tar)) + 1e-30)
    peak_out_db = 20 * np.log10(np.max(np.abs(audio_out)) + 1e-30)
    loud_tar = integrated_loudness_np(audio_tar, sr)
    loud_out = integrated_loudness_np(audio_out, sr)
    return {
        "d_lufs": [mape([loud_tar], [loud_out])],
        "d_peak": [mape([peak_tar_db], [peak_out_db])],
    }


# ===========================================================================
# spectral
# ===========================================================================
def spectral_centroid(S: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    Sn = S / np.maximum(S.sum(axis=0, keepdims=True), 1e-30)
    return (freqs[:, None] * Sn).sum(axis=0)


def spectral_bandwidth(S: np.ndarray, freqs: np.ndarray, centroid: np.ndarray, p: float = 2.0) -> np.ndarray:
    Sn = S / np.maximum(S.sum(axis=0, keepdims=True), 1e-30)
    dev = np.abs(freqs[:, None] - centroid[None, :])
    return (Sn * dev**p).sum(axis=0) ** (1.0 / p)


def spectral_contrast(
    S: np.ndarray,
    sr: float,
    n_fft: int,
    fmin: float = 250.0,
    n_bands: int = 4,
    quantile: float = 0.02,
) -> np.ndarray:
    """librosa-compatible octave-band contrast, dB output [n_bands+1, frames]."""
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    out = np.zeros((n_bands + 1, S.shape[1]))
    for k in range(n_bands + 1):
        lo, hi = octa[k], octa[k + 1]
        band = (freqs >= lo) & (freqs <= hi)
        if k > 0:
            band |= freqs == lo
        sub = S[band]
        if sub.shape[0] == 0:
            continue
        idx = max(int(quantile * sub.shape[0]), 1)
        srt = np.sort(sub, axis=0)
        valley = np.mean(srt[:idx], axis=0)
        peak = np.mean(srt[-idx:], axis=0)
        out[k] = 10 * np.log10(np.maximum(peak, 1e-10)) - 10 * np.log10(
            np.maximum(valley, 1e-10)
        )
    return out


def spectral_rolloff(S: np.ndarray, freqs: np.ndarray, roll_percent: float = 0.85) -> np.ndarray:
    total = S.sum(axis=0, keepdims=True)
    cum = np.cumsum(S, axis=0)
    mask = cum >= roll_percent * total
    idx = mask.argmax(axis=0)
    return freqs[idx]


def spectral_flatness(S: np.ndarray, amin: float = 1e-10, power: float = 2.0) -> np.ndarray:
    Sp = np.maximum(S, 0) ** power
    Sp = np.maximum(Sp, amin)
    return np.exp(np.mean(np.log(Sp), axis=0)) / np.mean(Sp, axis=0)


def compute_spectral_features(
    audio_out: np.ndarray,
    audio_tar: np.ndarray,
    sr: int = 44100,
    fft_size: int = 4096,
    hop_length: int = 1024,
) -> Dict[str, List[float]]:
    """``[T, C]`` inputs (reference :509-679); MAPE of windowed running means
    of each spectral statistic."""
    audio_out = peak_normalize(audio_out, -1.0)
    audio_tar = peak_normalize(audio_tar, -1.0)
    S_out = _stft_mag(audio_out, fft_size, hop_length)
    S_tar = _stft_mag(audio_tar, fft_size, hop_length)
    freqs = np.fft.rfftfreq(fft_size, 1.0 / sr)

    N = 40
    acc = {k: [] for k in ["centroid", "bandwidth", "ct_l", "ct_m", "ct_h", "rolloff", "flatness"]}
    eps = 1.0
    for c in range(S_out.shape[0]):
        to, ta = S_out[c], S_tar[c]
        sc_t = spectral_centroid(ta, freqs)
        sc_o = spectral_centroid(to, freqs)
        bw_t = spectral_bandwidth(ta, freqs, sc_t)
        bw_o = spectral_bandwidth(to, freqs, sc_o)
        ct_t = spectral_contrast(ta, sr, fft_size)
        ct_o = spectral_contrast(to, sr, fft_size)
        ro_t = spectral_rolloff(ta, freqs)
        ro_o = spectral_rolloff(to, freqs)
        ft_t = spectral_flatness(ta)
        ft_o = spectral_flatness(to)

        # NaN guards mirroring the reference's asserts
        # (utils_data_normalization.py:608-628)
        for nm, v in (("centroid_tar", sc_t), ("centroid_out", sc_o),
                      ("bandwidth_tar", bw_t), ("bandwidth_out", bw_o)):
            assert not np.isnan(v).any(), f"NaN values in {nm}"
        acc["centroid"].append(
            mape(running_mean_std(sc_t + eps, N)[0], running_mean_std(sc_o + eps, N)[0])
        )
        acc["bandwidth"].append(
            mape(running_mean_std(bw_t + eps, N)[0], running_mean_std(bw_o + eps, N)[0])
        )
        acc["ct_l"].append(
            mape(running_mean_std(ct_t[0], N)[0], running_mean_std(ct_o[0], N)[0])
        )
        acc["ct_m"].append(
            mape(
                running_mean_std(ct_t[1:4].mean(axis=0), N)[0],
                running_mean_std(ct_o[1:4].mean(axis=0), N)[0],
            )
        )
        acc["ct_h"].append(
            mape(running_mean_std(ct_t[-1], N)[0], running_mean_std(ct_o[-1], N)[0])
        )
        acc["rolloff"].append(
            mape(running_mean_std(ro_t + eps, N)[0], running_mean_std(ro_o + eps, N)[0])
        )
        nft = min(800, len(ft_t))
        acc["flatness"].append(
            mape(running_mean_std(ft_t, nft)[0], running_mean_std(ft_o, nft)[0])
        )

    out = {
        "centroid_mean": [float(np.mean(acc["centroid"]))],
        "bandwidth_mean": [float(np.mean(acc["bandwidth"]))],
        "contrast_l_mean": [float(np.mean(acc["ct_l"]))],
        "contrast_m_mean": [float(np.mean(acc["ct_m"]))],
        "contrast_h_mean": [float(np.mean(acc["ct_h"]))],
        "rolloff_mean": [float(np.mean(acc["rolloff"]))],
        "flatness_mean": [float(np.mean(acc["flatness"]))],
    }
    out["mape_mean"] = [float(np.mean([v[0] for v in out.values()]))]
    return out


# ===========================================================================
# panning (SPS)
# ===========================================================================
def get_sps(
    x: np.ndarray, n_fft: int = 2048, hop_length: int = 1024, smooth: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stereo panning spectrum (reference ``get_SPS`` :109-139).

    ``x [T, 2]`` -> (SPS_mean [bins], phi_mean [bins], SPS [frames, bins],
    phi [frames, bins]).
    """
    S = _stft_mag(x, n_fft, hop_length)  # [2, bins, frames]
    eps = 1e-20
    L = S[0].T + eps
    R = S[1].T + eps
    phi = 2 * (L * R) / (L**2 + R**2)
    phi_l = (L * R) / L**2
    phi_r = (R * L) / R**2
    delta_sign = np.sign(phi_l - phi_r)
    sps = (1 - phi) * delta_sign

    phi_mean = phi.mean(axis=0)
    sps_mean = sps.mean(axis=0)
    if smooth:
        phi_mean = scipy.signal.savgol_filter(phi_mean, 501, 1, mode="mirror")
        sps_mean = scipy.signal.savgol_filter(sps_mean, 501, 1, mode="mirror")
    return sps_mean, phi_mean, sps, phi


def panning_rms(
    sps: np.ndarray, freqs: Sequence[Tuple[float, float]], sr: int, n_fft: int
) -> np.ndarray:
    """Band RMS of the panning spectrum per frame (reference :682-703)."""
    out = np.zeros((sps.shape[0], len(freqs)))
    for j, (f1, f2) in enumerate(freqs):
        b1 = int(np.floor(f1 * n_fft / sr))
        b2 = int(np.floor(f2 * n_fft / sr))
        out[:, j] = np.sqrt(np.sum(sps[:, b1:b2] ** 2, axis=1) / max(b2 - b1, 1))
    return out


def compute_panning_features(
    audio_out: np.ndarray,
    audio_tar: np.ndarray,
    sr: int = 44100,
    fft_size: int = 2048,
    hop_length: int = 1024,
) -> Dict[str, List[float]]:
    """``[T, 2]`` inputs (reference :707-773)."""
    audio_out = peak_normalize(audio_out, -1.0)
    audio_tar = peak_normalize(audio_tar, -1.0)
    bands = [(0, sr // 2), (0, 250), (250, 2500), (2500, sr // 2)]
    _, _, sps_t, _ = get_sps(audio_tar, fft_size, hop_length, smooth=True)
    _, _, sps_o, _ = get_sps(audio_out, fft_size, hop_length, smooth=True)
    rms_t = panning_rms(sps_t, bands, sr, fft_size)
    rms_o = panning_rms(sps_o, bands, sr, fft_size)

    # drop frames where the target full-band rms is zero (reference :742-755)
    keep = rms_t[:, 0] != 0.0
    rms_t, rms_o = rms_t[keep], rms_o[keep]

    N = 40
    names = ["P_t_mean", "P_l_mean", "P_m_mean", "P_h_mean"]
    out: Dict[str, List[float]] = {}
    for j, name in enumerate(names):
        out[name] = [
            mape(running_mean_std(rms_t[:, j], N)[0], running_mean_std(rms_o[:, j], N)[0])
        ]
    out["mape_mean"] = [float(np.mean([out[n][0] for n in names]))]
    return out


# ===========================================================================
# dynamics
# ===========================================================================
def rms_dynamic_crest(
    x: np.ndarray, frame_length: int, hop_length: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame RMS dB, dynamic spread, crest (reference :777-811);
    channel-averaged. ``x [T, C]``."""
    T, C = x.shape
    n = 1 + (T - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms, dyn, crest = [], [], []
    for c in range(C):
        fr = x[:, c][idx]
        x_rms = amp_to_db(np.sqrt(np.sum(fr**2, axis=1) / frame_length))
        x_d = np.sum(amp_to_db(np.abs(fr)) - x_rms[:, None], axis=1) / frame_length
        x_c = amp_to_db(np.max(np.abs(fr), axis=1)) / x_rms
        rms.append(x_rms)
        dyn.append(x_d)
        crest.append(x_c)
    return (
        np.mean(rms, axis=0)[None],
        np.mean(dyn, axis=0)[None],
        np.mean(crest, axis=0)[None],
    )


def low_freq_weighting(
    x: np.ndarray, sr: int, n_fft: int, hop_length: int, f0: float = 1000.0
) -> np.ndarray:
    """Low/full spectral energy ratio per frame (reference :823-846)."""
    b, a = scipy.signal.butter(4, f0 / (sr / 2), "lowpass")
    x_low = np.stack(
        [scipy.signal.filtfilt(b, a, x[:, c]) for c in range(x.shape[1])], axis=1
    )
    X_low = _stft_mag(x_low, n_fft, hop_length)
    X = _stft_mag(x, n_fft, hop_length)
    ratio = X_low / (X + 1e-5)
    return ratio.sum(axis=1).mean(axis=0)[None]


def compute_dynamic_features(
    audio_out: np.ndarray,
    audio_tar: np.ndarray,
    sr: int = 44100,
    fft_size: int = 4096,
    hop_length: int = 1024,
) -> Dict[str, List[float]]:
    """``[T, C]`` inputs (reference :848-905)."""
    audio_out = peak_normalize(audio_out, -1.0)
    audio_tar = peak_normalize(audio_tar, -1.0)
    rms_t, dyn_t, crest_t = rms_dynamic_crest(audio_tar, fft_size, hop_length)
    rms_o, dyn_o, crest_o = rms_dynamic_crest(audio_out, fft_size, hop_length)
    low_t = low_freq_weighting(audio_tar, sr, fft_size, hop_length)
    low_o = low_freq_weighting(audio_out, sr, fft_size, hop_length)

    N = 40
    rms_t, rms_o = 1.0 - rms_t, 1.0 - rms_o
    dyn_t, dyn_o = 1.0 - dyn_t, 1.0 - dyn_o

    def rmean(v):
        return running_mean_std(v[0], N)[0]

    out = {
        "rms_mean": [mape(rmean(rms_t), rmean(rms_o))],
        "dyn_mean": [mape(rmean(dyn_t), rmean(dyn_o))],
        "crest_mean": [mape(rmean(crest_t), rmean(crest_o))],
        "l_ratio_mean_mape": [mape(rmean(low_t), rmean(low_o))],
        "l_ratio_mean_l2": [
            float(np.mean((rmean(low_t) - rmean(low_o)) ** 2))
        ],
    }
    out["mape_mean"] = [
        float(np.mean([out["rms_mean"][0], out["dyn_mean"][0], out["crest_mean"][0]]))
    ]
    return out


# ===========================================================================
# MFCC
# ===========================================================================
def _hz_to_mel(f, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f = np.asanyarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m, htk=False):
    m = np.asanyarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style mel filterbank (librosa.filters.mel defaults)."""
    fmax = fmax or sr / 2
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return fb * enorm[:, None]


def mfcc(
    x: np.ndarray, sr: int, n_mels: int = 128, n_mfcc: int = 13, mean_norm: bool = False
) -> np.ndarray:
    """MFCC of mono ``[T]`` (reference ``getMFCC``, ``fx_utils.py:293-302``:
    melspec n_fft=1024 hop=256 power=2 -> dB(ref=max) -> DCT-II ortho)."""
    S = _stft_mag(x[:, None], 1024, 256)[0] ** 2
    mel = mel_filterbank(sr, 1024, n_mels) @ S
    mel_db = 10 * np.log10(np.maximum(mel, 1e-10) / np.maximum(mel.max(), 1e-10))
    mel_db = np.maximum(mel_db, mel_db.max() - 80.0)
    coefs = scipy.fft.dct(mel_db, axis=0, type=2, norm="ortho")[:n_mfcc]
    if mean_norm:
        coefs -= np.mean(coefs, axis=0)
    return coefs


def mfcc_distances(
    y_true: np.ndarray, y_pred: np.ndarray, sr: int, n_mels: int = 128, n_mfcc: int = 13
) -> Dict[str, float]:
    """MFCC distance set (reference ``getMSE_MFCC``/``getDistances``,
    ``fx_utils.py:276-313``)."""
    ratio = np.mean(np.abs(y_true)) / np.maximum(np.mean(np.abs(y_pred)), 1e-30)
    y_pred = ratio * y_pred
    a = mfcc(y_true, sr, n_mels, n_mfcc)
    b = mfcc(y_pred, sr, n_mels, n_mfcc)
    diff = a - b
    cos = np.array(
        [
            1.0
            - np.dot(a[:, i], b[:, i])
            / max(np.linalg.norm(a[:, i]) * np.linalg.norm(b[:, i]), 1e-30)
            for i in range(a.shape[1])
        ]
    )
    return {
        "mae": round(float(np.mean(np.abs(diff))), 5),
        "mse": round(float(np.mean(diff**2)), 5),
        "euclidean": round(float(np.mean(np.linalg.norm(diff, axis=0))), 5),
        "manhattan": round(float(np.mean(np.sum(np.abs(diff), axis=0))), 5),
        "cosine": round(float(np.mean(cos)), 5),
    }


def highpass_filtering(x_list, f0: float, sr: int):
    """4th-order butterworth zero-phase highpass over a list of signals
    (reference ``fx_utils.highpassFiltering`` :203-210)."""
    b, a = scipy.signal.butter(4, f0 / (sr / 2), "highpass")
    return [np.asarray(scipy.signal.filtfilt(b, a, x), dtype=np.float32) for x in x_list]
