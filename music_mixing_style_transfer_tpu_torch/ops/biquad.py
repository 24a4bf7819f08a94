"""RBJ-cookbook biquads and their spectral evaluation, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/biquad.py``:
coefficient design, the exact transfer function, a cascade applied as one
spectral multiply (how the K-weighting filter runs on long signals), and
scipy's odd extension. Not ported yet: the recurrence forms
(``biquad_apply``, ``biquad_apply_scan``, ``rbj_poles``), which come with
the FX engine (ROADMAP).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rbj_coeffs(filter_type: str, G_db, Q, fc, rate) -> torch.Tensor:
    """Normalized ``[b0, b1, b2, a1, a2]`` (a0 == 1), float32, of the
    {'low_shelf', 'high_shelf', 'peaking', 'low_pass', 'high_pass'} designs
    (reference ``common_audioeffects.py:438-462``). Computed in float32 like
    the JAX package."""
    G_db = torch.as_tensor(G_db, dtype=torch.float32)
    A = 10.0 ** (G_db / 40.0)
    w0 = torch.as_tensor(2.0 * math.pi * (fc / rate), dtype=torch.float32)
    cosw, sinw = torch.cos(w0), torch.sin(w0)
    alpha = sinw / (2.0 * Q)
    sqA = torch.sqrt(A)

    if filter_type == "low_shelf":
        b0 = A * ((A + 1) - (A - 1) * cosw + 2 * sqA * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cosw)
        b2 = A * ((A + 1) - (A - 1) * cosw - 2 * sqA * alpha)
        a0 = (A + 1) + (A - 1) * cosw + 2 * sqA * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cosw)
        a2 = (A + 1) + (A - 1) * cosw - 2 * sqA * alpha
    elif filter_type == "high_shelf":
        b0 = A * ((A + 1) + (A - 1) * cosw + 2 * sqA * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cosw)
        b2 = A * ((A + 1) + (A - 1) * cosw - 2 * sqA * alpha)
        a0 = (A + 1) - (A - 1) * cosw + 2 * sqA * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cosw)
        a2 = (A + 1) - (A - 1) * cosw - 2 * sqA * alpha
    elif filter_type == "peaking":
        b0 = 1 + alpha * A
        b1 = -2 * cosw
        b2 = 1 - alpha * A
        a0 = 1 + alpha / A
        a1 = -2 * cosw
        a2 = 1 - alpha / A
    elif filter_type == "low_pass":
        b0 = (1 - cosw) / 2
        b1 = 1 - cosw
        b2 = (1 - cosw) / 2
        a0 = 1 + alpha
        a1 = -2 * cosw
        a2 = 1 - alpha
    elif filter_type == "high_pass":
        b0 = (1 + cosw) / 2
        b1 = -(1 + cosw)
        b2 = (1 + cosw) / 2
        a0 = 1 + alpha
        a1 = -2 * cosw
        a2 = 1 - alpha
    else:
        raise ValueError(f"unknown filter type: {filter_type}")
    return torch.stack([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0]).to(torch.float32)


def biquad_freq_response(coeffs: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Exact transfer function H(e^{jw}) at normalized frequencies:
    ``coeffs [..., 5]``, ``omega [M]`` -> complex64 ``[..., M]``."""
    z1 = torch.exp(-1j * omega.to(torch.complex64))
    z2 = z1 * z1
    c = coeffs.to(torch.complex64)
    b0, b1, b2, a1, a2 = (c[..., i : i + 1] for i in range(5))
    return (b0 + b1 * z1 + b2 * z2) / (1.0 + a1 * z1 + a2 * z2)


def biquad_cascade_fft(x: torch.Tensor, coeffs_list: torch.Tensor, tail: int = 16384) -> torch.Tensor:
    """A cascade of biquads ``coeffs_list [n_filters, ..., 5]`` over long
    ``x [..., T]`` as ONE spectral multiply: the combined response evaluated
    at the rfft bins of the signal zero-padded by at least ``tail`` (longer
    than the filters' decay), so no recurrence runs anywhere."""
    T = x.shape[-1]
    n = 1 << int(np.ceil(np.log2(T + tail)))
    omega = 2.0 * math.pi * torch.arange(n // 2 + 1, dtype=torch.float32, device=x.device) / n
    coeffs_list = coeffs_list.to(x.device)
    H = None
    for i in range(coeffs_list.shape[0]):
        Hi = biquad_freq_response(coeffs_list[i], omega)
        H = Hi if H is None else H * Hi
    X = torch.fft.rfft(x, n=n, dim=-1)
    return torch.fft.irfft(X * H, n=n, dim=-1)[..., :T].to(x.dtype)


def _odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by ``n`` on both ends of the last axis (scipy
    ``padtype='odd'``); the JAX package's negative-step slices become flips."""
    left = 2 * x[..., :1] - x[..., 1 : n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -n - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)
