"""RBJ-cookbook biquads and their spectral evaluation, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/biquad.py``:

- coefficient design and the analytic pole pair of the RBJ designs;
- the order-2 recurrence, sequential (``biquad_apply_scan``, scipy
  ``lfilter``'s order of operations) or log-depth (``biquad_apply``: two
  first-order complex64 recurrences, each a doubling scan: torch has no
  ``associative_scan``);
- the exact transfer function, a cascade as one spectral multiply (how the
  K-weighting filter runs on long signals) and the truncated-IR FFT form;
- FIR filtering (``F.conv1d`` in full float32) and zero-phase filtering
  with scipy's odd extension.

All filters follow scipy ``lfilter``'s zero initial state.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import full_float32


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


def rbj_poles(filter_type: str, G_db, Q, fc, rate) -> torch.Tensor:
    """Analytic pole pair ``[..., 2]`` (complex64) of the RBJ designs, with
    no discriminant cancellation: for all five types the normalized
    discriminant reduces to ``alpha'^2 - sin^2(w0)`` (``alpha' = alpha/A``
    for peaking, ``alpha`` otherwise), which float32 cannot take from
    ``a1^2 - 4 a2`` near critical damping (the 38 Hz, Q = 0.5 high-pass of
    the K-weighting)."""
    G_db = torch.as_tensor(G_db, dtype=torch.float32)
    A = 10.0 ** (G_db / 40.0)
    w0 = torch.as_tensor(2.0 * math.pi * (fc / rate), dtype=torch.float32)
    cosw, sinw = torch.cos(w0), torch.sin(w0)
    alpha = sinw / (2.0 * Q)

    def csqrt(v):
        return torch.sqrt(v.to(torch.complex64))

    if filter_type == "peaking":
        ap = alpha / A
        s = csqrt(ap * ap - sinw * sinw)
        denom = (1.0 + ap).to(torch.complex64)
        p1, p2 = (cosw + s) / denom, (cosw - s) / denom
    elif filter_type in ("low_pass", "high_pass"):
        s = csqrt(alpha * alpha - sinw * sinw)
        denom = (1.0 + alpha).to(torch.complex64)
        p1, p2 = (cosw + s) / denom, (cosw - s) / denom
    elif filter_type in ("low_shelf", "high_shelf"):
        sqA = torch.sqrt(A)
        s = csqrt(alpha * alpha - sinw * sinw)
        if filter_type == "low_shelf":
            u = (A - 1) + (A + 1) * cosw
            a0 = (A + 1) + (A - 1) * cosw + 2 * sqA * alpha
        else:
            u = (A + 1) * cosw - (A - 1)
            a0 = (A + 1) - (A - 1) * cosw + 2 * sqA * alpha
        u, a0 = u.to(torch.complex64), a0.to(torch.complex64)
        p1, p2 = (u + 2.0 * sqA * s) / a0, (u - 2.0 * sqA * s) / a0
    else:
        raise ValueError(f"unknown filter type: {filter_type}")
    return torch.stack([p1, p2], dim=-1).to(torch.complex64)


# --------------------------------------------------------------------------
# application
# --------------------------------------------------------------------------
def biquad_apply_scan(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Sequential direct-form-II-transposed biquad over the last axis of
    ``x [..., T]``; ``coeffs [5]`` or ``[..., 5]`` broadcastable to the batch
    shape. scipy ``lfilter``'s order of operations, a Python loop over time."""
    coeffs = coeffs.to(x.device, x.dtype)
    b0, b1, b2, a1, a2 = (coeffs[..., i] for i in range(5))
    z1 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    z2 = torch.zeros_like(z1)
    y = torch.empty_like(x)
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = b0 * xn + z1
        z1 = b1 * xn + z2 - a1 * yn
        z2 = b2 * xn - a2 * yn
        y[..., n] = yn
    return y


def _compensated_disc(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """``a1*a1 - 4*a2`` with Dekker's two-product compensation: the
    Veltkamp split recovers the low bits of ``a1*a1`` that float32 loses
    near critical damping."""
    split = 4097.0  # 2^12 + 1 for float32
    c = a1 * split
    hi = c - (c - a1)
    lo = a1 - hi
    p = a1 * a1
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    return (p - 4.0 * a2) + err


def _first_order_scan(p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``t[n] = p t[n-1] + f[n]`` (``t[-1] = 0``) over the last axis of
    complex ``f [..., T]``, ``p`` broadcastable to ``f[..., :1]``. A
    Hillis-Steele doubling scan: after step k, ``t[n]`` sums ``f`` over the
    2^(k+1) samples up to n, and a full window's slope is ``p^(2^k)`` (p is
    constant in time), so each step is one complex FMA on the shifted signal."""
    pk = p
    shift = 1
    while shift < f.shape[-1]:
        f = torch.cat([f[..., :shift], f[..., shift:] + pk * f[..., :-shift]], dim=-1)
        pk = pk * pk
        shift *= 2
    return f


def _clamp_radius(p: torch.Tensor) -> torch.Tensor:
    """Designed filters are stable; a radius above 0.999999 is rounding
    error that would blow the scan up, so it is pulled back to 0.999999."""
    r = p.abs()
    return torch.where(r > 0.999999, p * (0.999999 / r), p)


def biquad_apply(
    x: torch.Tensor, coeffs: torch.Tensor, poles: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Biquad over the last axis of ``x [..., T]`` as two first-order
    recurrences in series: with the FIR part ``f = b0 x + b1 x[-1] +
    b2 x[-2]``, ``1/D(z) = 1/((1 - p1 z^-1)(1 - p2 z^-1))``, so

        t[n] = p1 t[n-1] + f[n];   y[n] = p2 y[n-1] + t[n]

    each a log-depth scan on complex64. No partial fractions (robust at
    repeated poles). ``poles [..., 2]`` (e.g. :func:`rbj_poles`) are used
    when given; otherwise they come from ``a1, a2`` with a compensated
    discriminant, accurate except near critical damping."""
    coeffs = coeffs.to(x.device)
    b = coeffs[..., :3]
    a1, a2 = coeffs[..., 3], coeffs[..., 4]
    x1 = F.pad(x, (1, 0))[..., :-1]
    x2 = F.pad(x, (2, 0))[..., :-2]
    f = b[..., 0:1] * x + b[..., 1:2] * x1 + b[..., 2:3] * x2
    if poles is not None:
        poles = poles.to(x.device)
        p1, p2 = poles[..., 0], poles[..., 1]
    else:
        disc = torch.sqrt(_compensated_disc(a1, a2).to(torch.complex64))
        p1 = (-a1.to(torch.complex64) + disc) / 2.0
        p2 = (-a1.to(torch.complex64) - disc) / 2.0
    p1, p2 = (_clamp_radius(p).to(torch.complex64)[..., None] for p in (p1, p2))
    t = _first_order_scan(p1, f.to(torch.complex64))
    return _first_order_scan(p2, t).real.to(x.dtype)


def biquad_impulse_response(
    coeffs: torch.Tensor, poles: Optional[torch.Tensor] = None, ir_len: int = 16384
) -> torch.Tensor:
    """Impulse response ``[..., ir_len]`` of the biquad."""
    delta = torch.zeros(coeffs.shape[:-1] + (ir_len,), dtype=torch.float32, device=coeffs.device)
    delta[..., 0] = 1.0
    return biquad_apply(delta, coeffs, poles=poles)


def biquad_apply_fft(
    x: torch.Tensor,
    coeffs: torch.Tensor,
    poles: Optional[torch.Tensor] = None,
    ir_len: int = 16384,
) -> torch.Tensor:
    """Causal biquad filtering by truncated-IR FFT convolution: the
    recurrence runs over ``ir_len`` samples only, then one FFT convolution
    applies the response (stable audio biquads decay far below 1e-6 within
    16k samples)."""
    ir = biquad_impulse_response(coeffs.to(x.device), poles=poles, ir_len=ir_len).to(x.dtype)
    T = x.shape[-1]
    n = 1 << int(np.ceil(np.log2(T + ir_len - 1)))
    X = torch.fft.rfft(x, n=n, dim=-1)
    return torch.fft.irfft(X * torch.fft.rfft(ir, n=n, dim=-1), n=n, dim=-1)[..., :T]


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


def biquad_cascade(x: torch.Tensor, coeffs_list: torch.Tensor, parallel: bool = True) -> torch.Tensor:
    """``coeffs_list [n_filters, ..., 5]`` biquads applied in series."""
    apply_fn = biquad_apply if parallel else biquad_apply_scan
    for i in range(coeffs_list.shape[0]):
        x = apply_fn(x, coeffs_list[i])
    return x


# --------------------------------------------------------------------------
# zero-phase filtering (scipy.filtfilt parity)
# --------------------------------------------------------------------------
def _odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by ``n`` on both ends of the last axis (scipy
    ``padtype='odd'``); the JAX package's negative-step slices become flips."""
    left = 2 * x[..., :1] - x[..., 1 : n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -n - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def fir_filter(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal FIR, ``lfilter(b, 1, x)`` over the last axis: a correlation
    with the reversed taps (``F.conv1d``), in full float32 (TF32 off on the
    card, as the JAX package runs it at ``Precision.HIGHEST``)."""
    ntaps = taps.shape[-1]
    xr = F.pad(x, (ntaps - 1, 0)).reshape(-1, 1, x.shape[-1] + ntaps - 1)
    k = taps.flip(-1).reshape(1, 1, -1).to(x.device, x.dtype)
    with full_float32():
        y = F.conv1d(xr, k)
    return y.reshape(x.shape)


def filtfilt_fir(x: torch.Tensor, taps: torch.Tensor, padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase FIR filtering, scipy ``filtfilt(b, 1, x, padtype='odd')``
    (the EQ-matching FIR, reference ``utils_data_normalization.py:100-102``)."""
    if padlen is None:
        padlen = 3 * int(taps.shape[-1])
    ext = _odd_ext(x, padlen)
    y = fir_filter(fir_filter(ext, taps).flip(-1), taps).flip(-1)
    return y[..., padlen : ext.shape[-1] - padlen]


def filtfilt_biquad(x: torch.Tensor, coeffs: torch.Tensor, padlen: int = 9) -> torch.Tensor:
    """Zero-phase biquad filtering with odd padding and a zero initial
    state (scipy's ``lfilter_zi`` start differs only near the ends)."""
    ext = _odd_ext(x, padlen)
    y = biquad_apply(biquad_apply(ext, coeffs).flip(-1), coeffs).flip(-1)
    return y[..., padlen : ext.shape[-1] - padlen]
