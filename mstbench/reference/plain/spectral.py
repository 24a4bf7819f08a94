"""Multi-scale mid/side spectral loss and RMS gain loss, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/losses/spectral.py``
(reference ``modules/loss.py:77-213`` and its STFT front end
``modules/front_back_end.py:9-82``):

- ``frontend_mag``: torch.stft-style magnitudes (``center=True`` reflect
  pad, periodic Hann, the DC bin dropped, the last frame trimmed when
  ``T % round(n_fft/4) == 0``, as the reference's FrontEnd slices);
- ``multiscale_spectral_midside``: the DDSP multi-resolution loss on mid
  (L + R) and side (L - R), 4 scales (4096/2048/1024/512, hops /4),
  ``0.9 * L1(mag) + 0.1 * L2(log10 mag)``, mid weight 0.5;
- ``multiscale_spectral_stereo``: the same on the raw L/R channels (the
  reference's ``mode='ori'``);
- ``rms_loss``: the nonlinearly weighted RMS loss (gain supervision).

The losses run in the dtype they are given; the converter trainer gives
them float32 predictions whatever its compute dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .stft import hann_window, magnitude, stft

FFT_SIZES = (4096, 2048, 1024, 512)
HOP_SIZES = (1024, 512, 256, 128)


def frontend_mag(x: torch.Tensor, n_fft: int, hop_length: int, eps: float = 1e-7) -> torch.Tensor:
    """Magnitude STFT features of a mono batch ``[B, T]`` -> ``[B, bins-1, frames]``
    (reference FrontEnd(channel='mono', mode=['mag']))."""
    spec = stft(x, n_fft, hop_length, hann_window(n_fft, periodic=True), center=True)
    mag = magnitude(spec, eps).transpose(-1, -2)  # [B, bins, frames]
    if x.shape[-1] % round(n_fft / 4) == 0:
        mag = mag[..., :-1]
    if n_fft % 2 == 0:
        mag = mag[:, 1:]
    return mag


def _mag_loss(est: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    # reference: torch.norm(L1Loss(est, tgt)) == |mean abs diff|
    return torch.abs(torch.mean(torch.abs(est - tgt)))


def _logmag_loss(est: torch.Tensor, tgt: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.mean((torch.log10(est + eps) - torch.log10(tgt + eps)) ** 2)


def multiscale_spectral_midside(
    est: torch.Tensor,
    tgt: torch.Tensor,
    fft_sizes: Sequence[int] = FFT_SIZES,
    hop_sizes: Sequence[int] = HOP_SIZES,
    mid_weight: float = 0.5,
    logmag_weight: float = 0.1,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Multi-scale DDSP spectral loss on mid/side of stereo ``[B, 2, T]``
    (reference ``MultiScale_Spectral_Loss_MidSide_DDSP``, ``loss.py:99-213``;
    mid = L + R, side = L - R, ``loss.py:200-203``)."""
    est_mid, est_side = est[:, 0] + est[:, 1], est[:, 0] - est[:, 1]
    tgt_mid, tgt_side = tgt[:, 0] + tgt[:, 1], tgt[:, 0] - tgt[:, 1]
    total_mag = total_logmag = 0.0
    for n_fft, hop in zip(fft_sizes, hop_sizes):
        em, es = frontend_mag(est_mid, n_fft, hop, eps), frontend_mag(est_side, n_fft, hop, eps)
        tm, ts = frontend_mag(tgt_mid, n_fft, hop, eps), frontend_mag(tgt_side, n_fft, hop, eps)
        total_mag = total_mag + mid_weight * _mag_loss(em, tm) + (1 - mid_weight) * _mag_loss(es, ts)
        total_logmag = (
            total_logmag
            + mid_weight * _logmag_loss(em, tm, eps)
            + (1 - mid_weight) * _logmag_loss(es, ts, eps)
        )
    return (1 - logmag_weight) * total_mag + logmag_weight * total_logmag


def multiscale_spectral_stereo(
    est: torch.Tensor,
    tgt: torch.Tensor,
    fft_sizes: Sequence[int] = FFT_SIZES,
    hop_sizes: Sequence[int] = HOP_SIZES,
    logmag_weight: float = 0.1,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Multi-scale spectral loss on the raw L/R channels of stereo
    ``[B, 2, T]`` (the reference's ``mode='ori'``, ``loss.py:154-177``): it
    sees a static L/R imbalance, which the mid/side magnitudes cannot."""
    est_lr = est.reshape(-1, est.shape[-1])
    tgt_lr = tgt.reshape(-1, tgt.shape[-1])
    total_mag = total_logmag = 0.0
    for n_fft, hop in zip(fft_sizes, hop_sizes):
        em, tm = frontend_mag(est_lr, n_fft, hop, eps), frontend_mag(tgt_lr, n_fft, hop, eps)
        total_mag = total_mag + _mag_loss(em, tm)
        total_logmag = total_logmag + _logmag_loss(em, tm, eps)
    return (1 - logmag_weight) * total_mag + logmag_weight * total_logmag


def rms_loss(est: torch.Tensor, tgt: torch.Tensor, weight_factor: float = 100.0) -> torch.Tensor:
    """RMS gain loss (reference ``RMSLoss``, ``loss.py:77-93``): the
    elementwise MSE collapses to a scalar before the nonlinear weight, and
    the weight's gradient flows, as in the reference and the JAX package."""
    e = est.reshape(-1, est.shape[-1])
    t = tgt.reshape(-1, tgt.shape[-1])
    rms_e = torch.sqrt(torch.mean(e**2, dim=-1))
    rms_t = torch.sqrt(torch.mean(t**2, dim=-1))
    weight = torch.clamp(torch.abs(rms_t - rms_e), min=1.0 / weight_factor) * weight_factor
    mse = torch.mean((rms_e - rms_t) ** 2)
    return torch.mean(weight**1.5 * mse)
