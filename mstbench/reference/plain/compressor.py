"""Dynamic range compressor / expander core, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/compressor.py``
(reference numba envelope follower, ``common_audioeffects.py:529-587``):

    x_g = 20*log10(|x|)            (floored at -120 dB below 1e-6)
    y_g = static gain curve        (ratio>1: downward comp; ratio<1: upward exp)
    x_l = x_g - y_g
    y_l[n] = max(a_att*y_l[n-1] + (1-a_att)*x_l[n], a_rel*y_l[n-1] + (1-a_rel)*x_l[n])
             (min where a_att > a_rel: the branchy reference's choice)
    y    = x * 10**(-y_l/20)

Every compressor path goes through the envelope wrapper
(``ops/cuda/envelope.py:compressor_envelope``), which decides by the
tensor's device: the hand-written CUDA kernel on the card, its plain version
on the CPU; the chunk-parallel ``blockwise`` approximation is one such
launch over the signal's blocks as lanes. The make-up gain is left out (no
caller sets one).

The sox-style compander (``compand``) smooths the channel-max amplitude in
the linear domain, with no dB side chain and no static curve, so K2 does
not compute it: its envelope walks serially on the CPU and by the
kernel's three phases in whole-tensor steps on the card
(``ops/cuda/envelope.py:serial_scan``, ``chunked_scan``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .envelope import chunked_scan, compressor_envelope, serial_scan

LOG10_FLOOR = 1e-6
DB_FLOOR = -120.0
LOG10_E = 0.4342944819032518  # 1/ln(10)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    """20*log10(|x|) with the reference's -120 dB floor below 1e-6. The
    log10 is ``log(x) / ln(10)``, the form ``jnp.log10`` takes (and many
    times faster than ``torch.log10`` on the CPU)."""
    mag = x.abs()
    db = 20.0 * (torch.log(mag.clamp_min(LOG10_FLOOR)) * LOG10_E)
    return torch.where(mag < LOG10_FLOOR, DB_FLOOR, db)


def static_gain_curve(x_g: torch.Tensor, threshold, ratio) -> torch.Tensor:
    """Static curve in dB: ratio > 1 compresses above the threshold, ratio < 1
    expands below it, ratio == 1 is the identity."""
    threshold = _f32(threshold, x_g.device)
    ratio = _f32(ratio, x_g.device)
    comp = torch.where(x_g >= threshold, threshold + (x_g - threshold) / ratio, x_g)
    expd = torch.where(x_g <= threshold, threshold + (x_g - threshold) * ratio, x_g)
    return torch.where(ratio > 1.0, comp, torch.where(ratio < 1.0, expd, x_g))


def alphas(attack_ms, release_ms, sample_rate, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-pole coefficients ``exp(-1 / (0.001 * sr * ms))`` of the
    float32 times, taken in float64 and rounded to float32. ``1 - a`` is
    ~1e-4 at long releases, so one ulp of a float32 ``exp`` moves the time
    constant by ~1e-4 of itself; rounding a float64 result gives the card
    and the CPU the same coefficients."""
    def a(ms):
        t = _f32(ms, device).double()
        return torch.exp(-1.0 / (0.001 * sample_rate * t)).float()

    return a(attack_ms), a(release_ms)


def _lanes(p, batch_shape, device) -> torch.Tensor:
    return _f32(p, device).broadcast_to(batch_shape).reshape(-1)


def compressor_process(
    x: torch.Tensor,
    threshold,
    attack_ms,
    release_ms,
    ratio,
    sample_rate: int = 44100,
    rows=None,
    blockwise: bool = False,
    block: int = 4096,
    warmup: int = 8192,
) -> torch.Tensor:
    """Full compressor over the last axis of ``x [..., T]`` (float32).

    Parameters are scalars or arrays broadcastable to ``x.shape[:-1]`` (one
    value per lane). With ``rows`` ([L] int64 on x's device), ``x`` is
    ``[R, T]``, lane l reads row ``rows[l]`` (read once, never copied per
    lane), the parameters broadcast to ``[L]`` and the result is ``[L, T]``.

    ``blockwise=True`` is the JAX package's chunk-parallel approximation
    for augmentation (``_envelope_blockwise``): every ``block`` samples
    start from a zero envelope ``warmup`` samples earlier (the signal
    edge-padded at both ends), so the envelope's memory is cut at
    ``a^warmup``. It is one K2 launch over the blocks as lanes."""
    T = x.shape[-1]
    batch_shape = x.shape[:-1] if rows is None else rows.shape
    dev = x.device
    a_att, a_rel = alphas(attack_ms, release_ms, sample_rate, dev)
    lanes = [_lanes(p, batch_shape, dev) for p in (threshold, ratio, a_att, a_rel)]
    if blockwise:
        if rows is not None:
            raise ValueError("compressor_process: blockwise takes no rows")
        return _blockwise(x.reshape(-1, T), lanes, block, warmup).reshape(*batch_shape, T)
    y, _ = compressor_envelope(
        x.reshape(-1, T).contiguous(), *lanes, torch.zeros_like(lanes[0]), rows=rows
    )
    return y.reshape(*batch_shape, T)


def _blockwise(x2: torch.Tensor, lanes, block: int, warmup: int) -> torch.Tensor:
    """``x2 [R, T]`` compressed block by block with the per-row ``lanes``
    (threshold, ratio, a_att, a_rel, each ``[R]``). The side chain is per
    sample, so edge-padding x equals the JAX package's edge-padding of its
    side chain. The blocks are gathered as ``[R * nb, warmup + block]``
    lanes (at the converter's 64 rows of 2^17 + 4096 samples, ~104 MB), each
    row's parameters repeated over its blocks, and walked in one launch
    from a zero envelope; each lane's first ``warmup`` samples are dropped."""
    R, T = x2.shape
    nb = -(-T // block)
    idx = torch.arange(-warmup, nb * block, device=x2.device).clamp_(0, T - 1)
    blocks = x2[:, idx].unfold(-1, warmup + block, block).reshape(R * nb, warmup + block)
    per_block = [v.repeat_interleave(nb) for v in lanes]
    y, _ = compressor_envelope(blocks.contiguous(), *per_block, torch.zeros_like(per_block[0]))
    return y[:, warmup:].reshape(R, nb * block)[:, :T]


def compress_and_clip(
    x2: torch.Tensor,  # [L, T], or [R, T] with rows
    thresholds,        # [L]
    attacks,           # [L] ms
    releases,          # [L] ms
    ratios,            # [L]
    sample_rate: int = 44100,
    rows=None,
) -> torch.Tensor:
    """Per-lane compressor + the reference's clip rule (clip only if the
    output exceeds full scale, ``utils_data_normalization.py:352-355``).
    ``rows`` as in :func:`compressor_process`."""
    y = compressor_process(x2, thresholds, attacks, releases, ratios, sample_rate, rows=rows)
    return torch.where(y.abs().amax(-1, keepdim=True) >= 1.0, y.clamp(-1.0, 1.0), y)


class CompressorStream:
    """Stateful slab-streaming compressor over ``[L, T]`` lanes.

    Feeding consecutive time slabs through :meth:`process` equals one
    :func:`compressor_process` pass over the concatenated signal: the
    envelope carries across slabs, for any slab lengths (the kernel masks
    ragged tails instead of padding them). The caller never materializes
    ``[L, T]`` for large ``L``, only ``[L, slab]``."""

    def __init__(self, thresholds, attacks, releases, ratios, sample_rate: int = 44100):
        self._th = _f32(thresholds, None).reshape(-1)
        self._ra = _f32(ratios, None).reshape(-1)
        self._a_att, self._a_rel = alphas(
            _f32(attacks, None).reshape(-1), _f32(releases, None).reshape(-1), sample_rate
        )
        self._env = torch.zeros_like(self._th)

    def process(self, x_slab: torch.Tensor, rows=None) -> torch.Tensor:
        """``[L, Ts] -> [L, Ts]`` compressed (no clip), carrying state. With
        ``rows`` ([L] int64), lane l reads row ``rows[l]`` of ``x_slab [R, Ts]``."""
        y, self._env = compressor_envelope(
            x_slab.to(torch.float32).contiguous(), self._th, self._ra, self._a_att,
            self._a_rel, self._env, rows=rows,
        )
        return y


# ---------------------------------------------------------------------------
# sox-style compander (reference ``fx_utils.py:240-263``, libsox compand)
# ---------------------------------------------------------------------------
COMPAND_CHUNK = 512  # the card's chunked scan: ~C + T/C + C whole-tensor steps


def compand_transfer_table(
    tf_points=((-70.0, -70.0), (-0.1, -20.0), (0.0, 0.0)),
    soft_knee_db: float = 1.0,
    db_min: float = DB_FLOOR,
    db_step: float = 0.05,
):
    """Dense (in_db -> out_db) lookup table for a compand transfer curve:
    the JAX package's host code as it is (the same float32 tables).

    The piecewise-linear dB transfer function through ``tf_points`` is
    densified on the host and each interior corner rounded with the
    quadratic soft knee over radius ``min(knee/2, half of each adjacent
    segment)``, as sox shrinks the knee where segments are shorter. Returns
    ``(grid_db, out_db)`` float32 numpy arrays."""
    pts = np.asarray(sorted(tf_points), dtype=np.float64)
    grid = np.arange(db_min, 0.0 + db_step, db_step)
    # piecewise-linear through the points, unity slope below the first point
    first_in, first_out = pts[0]
    out = np.interp(grid, pts[:, 0], pts[:, 1])
    below = grid < first_in
    out[below] = first_out + (grid[below] - first_in)
    if soft_knee_db and soft_knee_db > 0:
        knots = np.concatenate([[grid[0]], pts[:, 0]])
        for j in range(1, len(knots) - 1):
            xk = knots[j]
            r = min(
                soft_knee_db / 2.0,
                (xk - knots[j - 1]) / 2.0,
                (knots[j + 1] - xk) / 2.0,
            )
            if r <= db_step:
                continue
            yk = float(np.interp(xk, pts[:, 0], pts[:, 1])) if xk >= first_in else (
                first_out + (xk - first_in)
            )
            # slopes from the piecewise-linear curve just outside the knee
            i_lo = max(0, int(round((xk - r - db_min) / db_step)))
            i_hi = min(len(grid) - 1, int(round((xk + r - db_min) / db_step)))
            s0 = (yk - out[i_lo]) / max(r, db_step)
            s1 = (out[i_hi] - yk) / max(r, db_step)
            mask = (grid >= xk - r) & (grid <= xk + r)
            xx = grid[mask]
            out[mask] = yk + s0 * (xx - xk) + (s1 - s0) / (4.0 * r) * (xx - xk + r) ** 2
    return grid.astype(np.float32), out.astype(np.float32)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing ``xp``: the segment by
    ``searchsorted`` (right side, clamped to the first and last), the lerp
    ``fp[i-1] + (delta / dx) * df`` in its order, and the ends held at
    ``fp[0]`` and ``fp[-1]`` as numpy holds them."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp_(1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx, df = xp[i] - x0, fp[i] - f0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _pole(sample_rate: int, seconds: float) -> float:
    """``exp(-1 / (sr * seconds))`` of the float32 argument, taken in
    float64 and rounded to float32 on the host: the same number on every
    device, and the JAX package's float32 ``jnp.exp`` at the rates and times
    its tests use."""
    return float(np.float32(np.exp(np.float64(np.float32(-1.0 / (sample_rate * seconds))))))


def compand_envelope(v: torch.Tensor, a_att: float, a_rel: float) -> torch.Tensor:
    """The compander's envelope of ``v [L, T]`` (``a_att <= a_rel``: the max
    of the two candidates) from zero: the serial walk on the CPU (the JAX
    package's ``_envelope_scan`` order), the chunked scan on the card."""
    L = v.shape[0]
    a = torch.full((L,), a_att, dtype=v.dtype, device=v.device)
    c = torch.full((L,), a_rel, dtype=v.dtype, device=v.device)
    if v.device.type == "cpu":
        return serial_scan(v, a, c, torch.zeros_like(a))
    if v.device.type != "cuda":
        raise ValueError(f"compand: unsupported device {v.device}")
    return chunked_scan(v, a, c, torch.zeros_like(a), COMPAND_CHUNK)


def compand(
    x: torch.Tensor,
    attack_s: float = 0.001,
    decay_s: float = 0.01,
    tf_points=((-70.0, -70.0), (-0.1, -20.0), (0.0, 0.0)),
    soft_knee_db: float = 1.0,
    sample_rate: int = 44100,
) -> torch.Tensor:
    """sox-style compander over ``[..., C, T]`` audio (the reference's
    ``soxbindings.Transformer.compand``, ``fx_utils.py:242-250``, as the JAX
    package models it): the linear-domain envelope of the channel-max
    amplitude with attack/decay one-pole smoothing (the max of the two
    candidates, valid since attack <= decay), then the soft-kneed dB
    transfer curve applied as one gain shared by the channels."""
    if attack_s > decay_s:
        raise ValueError("compand requires attack_s <= decay_s")
    grid, table = (torch.as_tensor(t, dtype=x.dtype, device=x.device)
                   for t in compand_transfer_table(tf_points, soft_knee_db))
    v = x.abs().amax(-2, keepdim=True)  # [..., 1, T]
    env = compand_envelope(v.reshape(-1, v.shape[-1]), _pole(sample_rate, attack_s),
                           _pole(sample_rate, decay_s)).reshape(v.shape)
    env_db = amp_to_db(env)
    out_db = interp(env_db, grid, table)
    return x * torch.pow(10.0, (out_db - env_db) / 20.0)
