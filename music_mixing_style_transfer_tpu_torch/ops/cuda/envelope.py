"""Compressor envelope follower: dB side chain, one-pole attack/release
smoothing carried across calls, and gain, in one pass over device memory.

Counterpart of ``music_mixing_style_transfer_tpu/ops/pallas/envelope.py``.
The kernel is hand-written CUDA for Hopper, ``csrc/envelope.cu`` (its header
says how it is laid out and what bounds it); ``envelope_reference`` is its
plain PyTorch version. The wrapper ``compressor_envelope`` takes the plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.

``compressor_envelope.launches`` counts kernel launches (and nothing else),
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch


REFERENCE_CHUNK = 256  # time steps of the plain version's side chain at a time


def envelope_reference(x, threshold, ratio, a_att, a_rel, env0):
    """Plain version: ``x [L, T]`` float32 with per-lane ``threshold``,
    ``ratio``, ``a_att``, ``a_rel`` and carried envelope ``env0`` (each
    ``[L]``) -> ``(y [L, T], env_out [L])``.

    The side chain is ``compressor_process``'s (``x_g - static_gain_curve``);
    then a Python loop over time on ``[L]`` vectors, the counterpart of the
    JAX package's ``_envelope_scan``. The loop runs in the signed form
    ``z = s * e`` with ``s = +1`` where ``a_att <= a_rel`` (max of the two
    candidates) and ``-1`` elsewhere (min): ``min(a, b) = -max(-a, -b)`` and
    a sign flip is exact, so the result is the same and each step is three
    operations. Time goes in chunks of ``REFERENCE_CHUNK`` samples, so the
    elementwise side chain and gain work on tensors that stay in cache (every
    operation is per sample, so the chunking changes no value); time-major
    copies keep each step's ``[L]`` rows contiguous, and the walk writes each
    step's envelope over the row it has just read."""
    from ..compressor import amp_to_db, static_gain_curve

    s = torch.where(a_att <= a_rel, 1.0, -1.0).to(x.dtype)
    b_att, b_rel = s * (1.0 - a_att), s * (1.0 - a_rel)
    y = torch.empty_like(x)
    z = s * env0
    for t0 in range(0, x.shape[1], REFERENCE_CHUNK):
        xc = x[:, t0 : t0 + REFERENCE_CHUNK]
        x_g = amp_to_db(xc)
        x_l = (x_g - static_gain_curve(x_g, threshold[:, None], ratio[:, None])).t().contiguous()
        p_att = x_l * b_att  # [chunk, L]: s * (1 - a_att) * x_l
        p_rel = x_l.mul_(b_rel)
        for t in range(p_att.shape[0]):
            z = torch.maximum(
                torch.addcmul(p_att[t], a_att, z), torch.addcmul(p_rel[t], a_rel, z), out=p_att[t]
            )
        y_l = s[:, None] * p_att.t()
        y[:, t0 : t0 + REFERENCE_CHUNK] = xc * torch.pow(10.0, -y_l / 20.0)
    return y, s * z


@functools.lru_cache(maxsize=None)
def _kernel():
    from .build import load

    fn = load("envelope").compressor_envelope_f32
    # x, threshold, ratio, a_att, a_rel, env_in, y, env_out; L, T; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compressor_envelope(x, threshold, ratio, a_att, a_rel, env0):
    """Envelope follower over ``x [L, T]`` (float32, contiguous) with per-lane
    parameters ``[L]`` (cast to float32); returns ``(y [L, T], env_out [L])``,
    the gain-applied signal and the envelope after its last sample, to carry
    into the next slab."""
    if x.dtype != torch.float32:
        raise ValueError(f"compressor_envelope: x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"compressor_envelope: x must be [L, T], got {tuple(x.shape)}")
    L, T = x.shape
    params = []
    for name, a in (
        ("threshold", threshold), ("ratio", ratio), ("a_att", a_att), ("a_rel", a_rel),
        ("env0", env0),
    ):
        if tuple(a.shape) != (L,) or a.device != x.device:
            raise ValueError(
                f"compressor_envelope: {name} must be ({L},) on {x.device}, "
                f"got {tuple(a.shape)} on {a.device}"
            )
        params.append(a.to(torch.float32).contiguous())
    if x.device.type == "cpu":
        return envelope_reference(x, *params)
    if x.device.type != "cuda":
        raise ValueError(f"compressor_envelope: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("compressor_envelope: x must be contiguous (row-major [L, T])")
    y = torch.empty_like(x)
    if L == 0 or T == 0:  # nothing to walk: the envelope carries through
        return y, params[-1].clone()
    env_out = torch.empty(L, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), *(a.data_ptr() for a in params), y.data_ptr(), env_out.data_ptr(),
            L, T, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"compressor_envelope: kernel launch failed with CUDA error {err}")
    compressor_envelope.launches += 1
    return y, env_out


compressor_envelope.launches = 0
