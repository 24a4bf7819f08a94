"""FFT convolution for the reverb engine, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/fftconv.py`` (it
replaces scipy ``oaconvolve`` of the reference ConvolutionalReverb,
``common_audioeffects.py:753``): one large rfft on ``torch.fft`` (cuFFT on
the card), at a 5-smooth size.
"""
from __future__ import annotations

import torch


def _next_fast_len(n: int) -> int:
    """Next 5-smooth size >= n (FFTs are efficient for 2/3/5 radices)."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            # round up to the next power-of-two multiple
            rem = -(-n // f35)
            p2 = 1 << max(rem - 1, 0).bit_length()
            cand = f35 * p2
            if n <= cand < best:
                best = cand
            f35 *= 3
        f5 *= 5
    return best


def fft_convolve_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis: ``x [..., T]``,
    ``h [..., L]`` (broadcastable batch dims) -> ``[..., T + L - 1]``."""
    T, L = x.shape[-1], h.shape[-1]
    n = _next_fast_len(T + L - 1)
    X = torch.fft.rfft(x, n=n, dim=-1)
    H = torch.fft.rfft(h, n=n, dim=-1)
    return torch.fft.irfft(X * H, n=n, dim=-1)[..., : T + L - 1]


def convolve_wet(
    x: torch.Tensor, h: torch.Tensor, peak_idx, trim_to_input: bool = True
) -> torch.Tensor:
    """Reverb wet path: the full convolution, then ``x``-length audio from
    the IR's peak index on (reference ``common_audioeffects.py:752-761``).
    ``peak_idx`` is an int or a 0-d tensor, clipped to ``[0, L - 1]``."""
    y = fft_convolve_full(x, h)
    if not trim_to_input:
        return y
    start = min(max(int(peak_idx), 0), h.shape[-1] - 1)
    return y[..., start : start + x.shape[-1]]
