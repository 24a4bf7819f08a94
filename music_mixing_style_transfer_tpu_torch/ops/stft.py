"""STFT primitives, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/stft.py``: the windows,
framing, the forward STFT (both ``center`` conventions) and its inverse.
The FX-normalization DSP uses ``center=False`` with a sqrt-Hann window
(reference ``utils_data_normalization.py``). Not ported yet: the loss front
end's helpers (training).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.blocks import reflect_pad


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window. ``periodic=True`` matches torch.hann_window's default;
    ``periodic=False`` the symmetric np.hanning."""
    n = win_length if periodic else win_length - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / max(n, 1))
    return w.astype(np.float32)


def sqrt_hann_window(n_fft: int) -> np.ndarray:
    """``np.sqrt(np.hanning(n_fft+1)[:-1])``: the analysis window of the
    reference normalization DSP (``utils_data_normalization.py:76``)."""
    return np.sqrt(np.hanning(n_fft + 1)[:-1]).astype(np.float32)


def frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """``[..., T] -> [..., n_frames, frame_length]`` with
    ``n_frames = 1 + (T - frame_length) // hop_length`` (a strided view)."""
    return x.unfold(-1, frame_length, hop_length)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: np.ndarray,
    center: bool = False,
) -> torch.Tensor:
    """Short-time Fourier transform over the last axis of ``x [..., T]``.

    ``window`` (length ``<= n_fft``) is zero-padded to the centre as in
    torch.stft. ``center=True`` reflect-pads ``n_fft//2`` on both sides
    first (numpy's semantics); ``center=False`` starts the frames at
    sample 0. Returns complex64
    ``[..., n_frames, n_fft//2 + 1]``."""
    win_length = len(window)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    w = torch.as_tensor(window, dtype=x.dtype, device=x.device)
    if center:
        x = reflect_pad(x, n_fft // 2, n_fft // 2)
    return torch.fft.rfft(frame(x, n_fft, hop_length) * w, n=n_fft, dim=-1)


def istft(
    spec: torch.Tensor,
    hop_length: int,
    window: np.ndarray,
    center: bool = False,
    length: Optional[int] = None,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Inverse STFT of complex ``spec [..., n_frames, n_fft//2 + 1]`` with
    squared-window overlap-add normalization; returns ``[..., T]``. The
    overlap-add is ``F.fold`` (a sum per output sample, no atomics)."""
    n_fft = 2 * (spec.shape[-1] - 1)
    n_frames = spec.shape[-2]
    w = torch.as_tensor(window, dtype=torch.float32, device=spec.device)
    if len(window) < n_fft:
        lpad = (n_fft - len(window)) // 2
        w = F.pad(w, (lpad, n_fft - len(window) - lpad))
    frames_t = torch.fft.irfft(spec, n=n_fft, dim=-1) * w  # [..., n_frames, n_fft]
    T_full = n_fft + hop_length * (n_frames - 1)
    batch = spec.shape[:-2]

    def overlap_add(frames):  # [B, n_frames, n_fft] -> [B, T_full]
        return F.fold(
            frames.transpose(1, 2), output_size=(1, T_full), kernel_size=(1, n_fft),
            stride=(1, hop_length),
        ).reshape(frames.shape[0], T_full)

    y = overlap_add(frames_t.reshape(-1, n_frames, n_fft)).reshape(*batch, T_full)
    wsq = overlap_add((w * w).expand(1, n_frames, n_fft))[0]
    y = y / wsq.clamp_min(eps)
    if center:
        y = y[..., n_fft // 2 : T_full - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y
