"""Fused TCN block: dilated conv + BN affine + LeakyReLU + FiLM + grouped
1x1 residual in one pass over device memory.

Counterpart of ``music_mixing_style_transfer_tpu/ops/pallas/tcn_block.py``.
The kernel is hand-written CUDA for Hopper, ``csrc/tcn_block.cu`` (its
header says how it is tiled and what bounds it): TMA and warp-specialised
``wgmma`` on a persistent grid. bfloat16 runs on the tensor cores as it is;
float32 runs as 3xTF32 (``split_tf32``): each operand is split into a tf32
``big`` part and a tf32 ``small`` remainder, and the kernel sums
small*big + big*small + big*big, which keeps float32's accuracy (measured
against float64 in ``PERF.md``). ``tcn_block_reference`` is the plain
PyTorch version in exact float32; the wrapper ``tcn_block`` takes it only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.

``tcn_block.launches`` counts kernel launches (and nothing else), so a run
can show that its path went through the kernel. While tracing, the counter
``ops.cuda.tcn_block`` records ``(B, T, d, bf16)`` of each fused block
computed: on the card one record a launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...utils import profiling

K_TAPS = 15
CHANNELS = 128
LEAKY_SLOPE = 0.01

_DTYPES = {torch.float32: "tcn_block_f32", torch.bfloat16: "tcn_block_bf16"}


def fused_block_applicable(channels: int, d: int) -> bool:
    """The model-level rule for the kernel: 128 channels and dilation >= 8.

    Unlike the TPU kernel there is no rule on ``T``: the CUDA kernel reads
    rows ``t + (k-7)*d`` directly, zero-filled outside ``[0, T)``, so any
    ``T >= 1`` works (including ``T < 7*d`` and ``T`` not a multiple of
    ``d``).
    """
    return channels == CHANNELS and d >= 8


def dilated_conv(x, w, d: int) -> torch.Tensor:
    """The block's conv on ``x [B, T, C]`` with ``w [15, C, C]`` as
    ``w[k][in][out]``: ``F.conv1d`` with zero padding ``7*d`` and dilation
    ``d``, in ``x``'s dtype. Returns ``[B, T, C]``."""
    return F.conv1d(
        x.transpose(1, 2), w.permute(2, 1, 0), padding=(K_TAPS - 1) // 2 * d, dilation=d,
    ).transpose(1, 2)


def block_epilogue(h, x, s, t, r, b, wr) -> torch.Tensor:
    """``lrelu(h*s + t)*r + b + x*wr`` on the conv output ``h [B, T, C]``,
    in ``h``'s dtype."""
    y = F.leaky_relu(h * s.to(h.dtype) + t.to(h.dtype), LEAKY_SLOPE)
    y = y * r.to(h.dtype)[:, None, :] + b.to(h.dtype)[:, None, :]
    return y + x.to(h.dtype) * wr.to(h.dtype)


def tcn_block_reference(x, w, s, t, r, b, wr, d: int) -> torch.Tensor:
    """Plain version: ``lrelu(conv_d(x)*s + t)*r + b + x*wr`` in float32.

    ``x [B, T, C]``; ``w [15, C, C]`` as ``w[k][in][out]``; ``s, t, wr [C]``;
    ``r, b [B, C]``. The conv is ``F.conv1d`` with zero padding ``7*d`` and
    dilation ``d``. Returns ``x.dtype``.
    """
    xf = x.float()
    return block_epilogue(dilated_conv(xf, w.float(), d), xf, s, t, r, b, wr).to(x.dtype)


def converter_plain(model, x: torch.Tensor, cond) -> torch.Tensor:
    """Plain version of a whole MixFXcloner eval forward (``models/tcn.py``),
    block by block, with every fused block through
    :func:`tcn_block_reference` (never the kernel). ``x [B, 2, T]``;
    ``cond`` is one condition ``[B, cond_dim]`` or a list of one a block."""
    conds = cond if isinstance(cond, (list, tuple)) else [cond] * len(model.blocks)
    h = x.transpose(1, 2).contiguous()
    for blk, c in zip(model.blocks, conds):
        if blk.uses_kernel():
            s, t = blk.bn.fold()
            r, b = blk.film.rb(c)
            h = tcn_block_reference(
                h, blk.conv1.weight.permute(2, 1, 0), s, t, r, b, blk.res.weight[:, 0, 0],
                blk.dilation,
            )
        else:
            h = blk(h, c)
    out = h @ model.output.weight[:, :, 0].T + model.output.bias
    return out.transpose(1, 2).clamp(-1.0, 1.0)


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits come out zero."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """``(big, small)`` with ``big = round_tf32(a)`` and ``small = a - big``
    exactly (``big + small == a``). The kernel uses ``round_tf32(small)``,
    which drops ~2^-22 of ``a``."""
    big = round_tf32(a)
    return big, a.float() - big


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    from .build import load

    fn = getattr(load("tcn_block"), _DTYPES[dtype])
    # x, w, s, t, r, b, wr, y; B, T, d; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def tiling(dtype: torch.dtype):
    """``(rows, w_parts)`` of the built kernel for ``dtype``: time rows a
    tile and w boxes a stage, as ``csrc/tcn_block.cu`` reports them. Builds
    the kernel; for figures derived from its tiling."""
    from .build import load

    fn = load("tcn_block").tcn_block_tiling
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    rows, parts = ctypes.c_int(), ctypes.c_int()
    fn(int(dtype == torch.float32), ctypes.byref(rows), ctypes.byref(parts))
    return rows.value, parts.value


def tcn_block(x, w, s, t, r, b, wr, d: int) -> torch.Tensor:
    """Fused block on channels-last ``x [B, T, 128]`` (float32 or bfloat16,
    contiguous). Parameters are cast to what the kernel takes: ``w`` laid
    out K-major in ``x.dtype`` (for float32, split into its two tf32
    parts), the rest to float32. Returns a new ``[B, T, 128]`` tensor of
    ``x.dtype``."""
    if x.device.type == "cpu":
        profiling.count("ops.cuda.tcn_block",
                        (x.shape[0], x.shape[1], d, x.dtype == torch.bfloat16))
        return tcn_block_reference(x, w, s, t, r, b, wr, d)
    if x.device.type != "cuda":
        raise ValueError(f"tcn_block: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"tcn_block: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != CHANNELS or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"tcn_block: x must be [B, T, {CHANNELS}], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            "tcn_block: x must be contiguous (channels-last [B, T, C]) and 16-byte aligned"
        )
    if d < 1:
        raise ValueError(f"tcn_block: dilation must be >= 1, got {d}")
    B, T, C = x.shape
    for name, a, shape in (
        ("w", w, (K_TAPS, C, C)), ("s", s, (C,)), ("t", t, (C,)),
        ("r", r, (B, C)), ("b", b, (B, C)), ("wr", wr, (C,)),
    ):
        if tuple(a.shape) != shape or a.device != x.device:
            raise ValueError(
                f"tcn_block: {name} must be {shape} on {x.device}, "
                f"got {tuple(a.shape)} on {a.device}"
            )
    # w K-major, w_t[k][out][in], as the tensor cores take it; float32 as
    # w_big then w_small, both tf32, for 3xTF32
    w_t = w.permute(0, 2, 1).float()
    if x.dtype == torch.float32:
        big, small = split_tf32(w_t)
        w_t = torch.stack([big, round_tf32(small)])
    # the kernel reads 16-byte vectors: a fresh allocation is always aligned
    args = [
        a if a.is_contiguous() and a.data_ptr() % 16 == 0 else a.clone(
            memory_format=torch.contiguous_format
        )
        for a in [w_t.to(x.dtype)] + [a.to(torch.float32) for a in (s, t, r, b, wr)]
    ]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(
            x.data_ptr(), *(a.data_ptr() for a in args), y.data_ptr(), B, T, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tcn_block: kernel launch failed with CUDA error {err}")
    tcn_block.launches += 1
    profiling.count("ops.cuda.tcn_block", (B, T, d, x.dtype == torch.bfloat16))
    return y


tcn_block.launches = 0
