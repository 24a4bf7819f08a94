"""STFT primitives, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/stft.py``: the windows,
framing, the forward STFT (both ``center`` conventions) and its inverse,
the reference normalization's STFT pair (``compute_stft`` /
``compute_istft``) and ``fx_utils``'s framing pair (``slicing`` /
``overlap``).
The FX-normalization DSP uses ``center=False`` with a sqrt-Hann window
(reference ``utils_data_normalization.py``); the training losses'
front end (``losses/spectral.py``) ``center=True`` with a periodic Hann
window and :func:`magnitude`. Every op here is differentiable (the reflect
pad is an index gather, framing a strided view, then ``rfft``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .blocks import reflect_pad


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window. ``periodic=True`` matches torch.hann_window's default;
    ``periodic=False`` the symmetric np.hanning."""
    n = win_length if periodic else win_length - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / max(n, 1))
    return w.astype(np.float32)


def hamming_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hamming window, periodic (torch.hamming_window's default) or
    symmetric."""
    n = win_length if periodic else win_length - 1
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(win_length) / max(n, 1))
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


def magnitude(spec: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """``sqrt(|S|^2 + eps)``: the eps inside the root, as the reference
    front end takes it (``front_back_end.py:80-82``), so the gradient is
    finite at ``S = 0``."""
    return torch.sqrt(spec.real**2 + spec.imag**2 + eps)


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


def compute_stft(samples: torch.Tensor, hop_length: int, fft_size: int) -> torch.Tensor:
    """``[T, C] -> [n_frames, C, n_bins]`` complex, sqrt-Hann, ``center=False``
    (reference ``common_miscellaneous.py:50-77``)."""
    spec = stft(samples.T, fft_size, hop_length, sqrt_hann_window(fft_size), center=False)
    return spec.transpose(0, 1)  # [C, F, B] -> [F, C, B]


def compute_istft(
    spec: torch.Tensor, hop_length: int, fft_size: int, length: Optional[int] = None
) -> torch.Tensor:
    """``[n_frames, C, n_bins] -> [T, C]``, the inverse of
    :func:`compute_stft` (reference ``common_miscellaneous.py:80-104``)."""
    y = istft(spec.transpose(0, 1), hop_length, sqrt_hann_window(fft_size), center=False,
              length=length)
    return y.T


def slicing(
    x, win_length: int, hop_length: int, center: bool = True, windowing: bool = False,
    pad: int = 0,
) -> torch.Tensor:
    """A 1-D signal as ``[n_frames, win_length]`` float32 frames (reference
    ``fx_utils.slicing`` :164-179): with ``center``, zero padding of
    ``(win - hop + pad)//2`` on the left and ``(win + hop + pad)//2`` on the
    right; with ``windowing``, a periodic Hann window on each frame."""
    x = torch.as_tensor(x)
    if center:
        x = F.pad(x, (int((win_length - hop_length + pad) // 2),
                      int((win_length + hop_length + pad) // 2)))
    frames = frame(x, win_length, hop_length)
    if windowing:
        frames = frames * torch.as_tensor(hann_window(win_length), device=frames.device)
    return frames.to(torch.float32)


def overlap(
    frames, x_len: int, win_length: int, hop_length: int, windowing: bool = True,
    rate: float = 1.0,
) -> torch.Tensor:
    """Overlap-add ``[n_frames, win_length]`` frames back to a float32
    signal (reference ``fx_utils.overlap`` :182-198): with ``windowing``, a
    periodic Hann window and a ``rate * hop / win`` gain; the first
    ``x_len // hop`` frames added into ``win + hop * (x_len / hop)`` samples,
    then ``win // 2`` trimmed from both ends."""
    frames = torch.as_tensor(frames)
    if windowing:
        w = torch.as_tensor(hann_window(win_length), device=frames.device)
        rate = rate * hop_length / win_length
    else:
        w = torch.ones(win_length, device=frames.device)
        rate = 1.0
    n_frames = min(int(x_len / hop_length), frames.shape[0])
    expected_len = int(win_length + hop_length * (x_len / hop_length))
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(win_length, device=frames.device)[None, :])
    y = torch.zeros(expected_len, dtype=frames.dtype, device=frames.device)
    y = y.index_add(0, idx.reshape(-1), (frames[:n_frames] * w).reshape(-1).to(frames.dtype))
    y = y[win_length // 2 : -(win_length // 2)]
    return (y * rate).to(torch.float32)
