"""Stereo-image normalization (mid/side + panning balance), in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/normalize/imager.py``
(reference ``mixing_manipulator/normalization_imager.py:22-113``):
  1. if the input is near-mono (mid energy ratio > threshold), stereoize it
     with a Haas effect + RMS re-normalization
  2. balance mid/side energies to the precomputed target
  3. balance left/right to 50-50
  4. balance mid/side again
on ``[..., 2, T]`` audio with per-item targets (the JAX package vmaps over
stems; here the stems are a batch axis). The Haas parameters are those of
the JAX package's ``PRNGKey(0)`` draw at ``sr`` (``fx/processors.py:haas_params``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .processors import Haas, haas_params, rms_normalize


def lr_to_ms(left: torch.Tensor, right: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return left + right, left - right


def ms_to_lr(mid: torch.Tensor, side: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (mid + side) / 2.0, (mid - side) / 2.0


def process_balance(d1, d2, tgt_e1_bal=0.5, eps=1e-4):
    """Rebalance two signals' energies (over the last axis) to (tgt, 1-tgt)
    of the total (reference ``normalization_imager.py:86-99``)."""
    tgt_e1_bal = torch.as_tensor(tgt_e1_bal, dtype=d1.dtype, device=d1.device)
    if tgt_e1_bal.dim():
        tgt_e1_bal = tgt_e1_bal[..., None]
    e1 = (d1 * d1).sum(-1, keepdim=True)
    e2 = (d2 * d2).sum(-1, keepdim=True)
    total = e1 + e2
    g1 = torch.sqrt(tgt_e1_bal * total / (e1 + eps))
    new_e1 = e1 * g1**2
    g2 = torch.sqrt((total - new_e1).clamp_min(0.0) / (e2 + 1e-3))
    return d1 * g1, d2 * g2


def normalize_imager(
    audio: torch.Tensor,
    target_side_mid_bal=0.9,
    mono_threshold=0.95,
    sr: int = 44100,
) -> torch.Tensor:
    """Normalize the stereo image of ``audio [..., 2, T]`` to the target
    balance; ``target_side_mid_bal`` and ``mono_threshold`` are scalars or
    one value per leading item."""
    mono_threshold = torch.as_tensor(mono_threshold, dtype=audio.dtype, device=audio.device)
    mid, side = lr_to_ms(audio[..., 0, :], audio[..., 1, :])
    mid_e = (mid * mid).sum(-1)
    side_e = (side * side).sum(-1)
    is_mono = mid_e / (mid_e + side_e) > mono_threshold

    stereoized = rms_normalize(audio, Haas(sr).apply(haas_params(sr), audio))
    audio = torch.where(is_mono[..., None, None], stereoized, audio)

    mid, side = lr_to_ms(audio[..., 0, :], audio[..., 1, :])
    new_mid, new_side = process_balance(mid, side, target_side_mid_bal)
    left, right = ms_to_lr(new_mid, new_side)

    left, right = process_balance(left, right, 0.5)
    mid, side = lr_to_ms(left, right)

    new_mid, new_side = process_balance(mid, side, target_side_mid_bal)
    left, right = ms_to_lr(new_mid, new_side)
    return torch.stack([left, right], dim=-2)
