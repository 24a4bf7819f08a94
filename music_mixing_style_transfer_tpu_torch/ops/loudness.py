"""ITU-R BS.1770-4 loudness metering and normalization, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/loudness.py``
(reference pyloudnorm use, ``fx_utils.py:220-238``):

- K-weighting pre-filter: RBJ high-shelf (+4 dB @ 1500 Hz, Q=1/sqrt(2)) then
  high-pass (38 Hz, Q=0.5), per channel;
- 400 ms gating blocks with 75% overlap; absolute gate -70 LUFS; relative
  gate (mean - 10 LU); integrated loudness over surviving blocks.

``integrated_loudness`` takes leading batch axes (the JAX package vmaps it).
"""
from __future__ import annotations

import numpy as np
import torch

from .biquad import biquad_apply, biquad_cascade_fft, rbj_coeffs, rbj_poles
from .stft import frame

K_WEIGHT_SPECTRAL_MIN = 65536


def k_weighting_coeffs(rate: float):
    """(high_shelf, high_pass) biquad ``(coeffs [5], poles [2])`` for the rate."""
    shelf_args = ("high_shelf", 4.0, 1.0 / np.sqrt(2.0), 1500.0, rate)
    hpf_args = ("high_pass", 0.0, 0.5, 38.0, rate)
    return (
        (rbj_coeffs(*shelf_args), rbj_poles(*shelf_args)),
        (rbj_coeffs(*hpf_args), rbj_poles(*hpf_args)),
    )


def k_weight(x: torch.Tensor, rate: float) -> torch.Tensor:
    """The two-stage K pre-filter over the last axis. Signals of 65536
    samples or more take the spectral cascade (one FFT round trip), shorter
    ones the recurrence with the analytic poles (exact transients), as in
    the JAX package."""
    (sc, sp), (hc, hp) = k_weighting_coeffs(rate)
    if x.shape[-1] >= K_WEIGHT_SPECTRAL_MIN:
        return biquad_cascade_fft(x, torch.stack([sc, hc]))
    return biquad_apply(biquad_apply(x, sc, poles=sp), hc, poles=hp)


def integrated_loudness(x: torch.Tensor, rate: int = 44100) -> torch.Tensor:
    """Integrated (gated) loudness in LUFS of ``x [T]`` (mono) or
    ``[..., T, C]`` (pyloudnorm layout, any leading batch axes). Returns
    ``[...]``; -inf for fully-gated (silent) input."""
    if x.dim() == 1:
        x = x[:, None]
    batch, (T, C) = x.shape[:-2], x.shape[-2:]
    G = torch.tensor([1.0, 1.0, 1.0, 1.41, 1.41][:C], dtype=torch.float32, device=x.device)

    T_g = 0.4
    step = 0.25  # fraction of T_g (75% overlap)
    block_len = int(T_g * rate)
    hop = int(T_g * rate * step)
    # pyloudnorm: numBlocks = round((T_total - T_g)/(T_g*step)) + 1, with
    # Python's round-half-even; counted before filtering, so input too short
    # for one block is -inf whatever its length
    num_blocks = max(int(round((T / rate - T_g) / (T_g * step))) + 1, 0)
    if num_blocks == 0:
        return torch.full(batch, -torch.inf, device=x.device)

    y = k_weight(x.transpose(-1, -2), rate)  # [..., C, T]
    usable = hop * (num_blocks - 1) + block_len
    if usable > T:
        y = torch.nn.functional.pad(y, (0, usable - T))
    if block_len == 4 * hop:
        # each 400 ms block is 4 consecutive 100 ms hops: block mean squares
        # from non-overlapped partial sums, one pass over the audio
        n_hops = usable // hop
        psum = (y[..., : n_hops * hop].reshape(*y.shape[:-1], n_hops, hop) ** 2).sum(-1)
        z = (psum[..., :-3] + psum[..., 1:-2] + psum[..., 2:-1] + psum[..., 3:]) / block_len
    else:  # int() rounding broke the 4:1 ratio (non-standard rate)
        z = (frame(y[..., :usable], block_len, hop) ** 2).mean(-1)  # [..., C, J]

    def lufs(power):
        return -0.691 + 10.0 * torch.log10(power.clamp_min(1e-30))

    l_j = lufs((G[:, None] * z).sum(-2))  # [..., J]
    abs_mask = l_j > -70.0
    n_abs = abs_mask.sum(-1, keepdim=True).clamp_min(1)
    z_avg_abs = torch.where(abs_mask[..., None, :], z, 0.0).sum(-1) / n_abs  # [..., C]
    gamma_r = lufs((G * z_avg_abs).sum(-1)) - 10.0

    mask = abs_mask & (l_j > gamma_r[..., None])
    n_rel = mask.sum(-1)
    z_avg = torch.where(mask[..., None, :], z, 0.0).sum(-1) / n_rel[..., None].clamp_min(1)
    return torch.where(n_rel > 0, lufs((G * z_avg).sum(-1)), -torch.inf)


def loudness_normalize(x: torch.Tensor, input_lufs, target_lufs) -> torch.Tensor:
    """pyloudnorm.normalize.loudness: pure gain to hit the target."""
    return x * torch.pow(10.0, (target_lufs - input_lufs) / 20.0)


def peak_normalize(x: torch.Tensor, target_db: float) -> torch.Tensor:
    """pyloudnorm.normalize.peak: scale so max |x| hits target dBFS."""
    return x * (10.0 ** (target_db / 20.0) / x.abs().max().clamp_min(1e-30))


def lufs_normalize(x: torch.Tensor, rate: int, target_lufs) -> torch.Tensor:
    """Reference ``fx_utils.lufs_normalize``: measure, gain to the target,
    divide by max(1, peak). Fully-gated input (-inf LUFS) passes through
    unchanged, where pyloudnorm NaNs."""
    loud = integrated_loudness(x + 1e-10, rate)
    y = torch.where(torch.isfinite(loud), loudness_normalize(x, loud, target_lufs), x)
    return y / torch.clamp_min(1e-6 + y.abs().max(), 1.0)
