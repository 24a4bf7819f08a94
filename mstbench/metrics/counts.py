"""The yardstick's arithmetic: the chip's peaks, the models' operations a
sample, and the kernels' least times. Frozen here, beside the readers that
use them, so that a change to the program cannot move them.

Operations count multiply-adds as two, for the convolutions and the
converter's output layer only (batch norm, FiLM, activations and the
residuals are left out, and so is the time axis' zero padding), per input
sample of one stereo segment.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAKS = {
    "bfloat16": 989e12,   # FLOP/s on the tensor cores
    "tf32": 495e12,
    "float32": 67e12,     # outside the tensor cores (TF32 off)
    "hbm_bytes_per_s": 3.35e12,
}


def converter_flops_per_sample(cfg: dict) -> float:
    """MixFXcloner (``cfg``: its sizes as in the configuration file): every
    block's dilated conv over all ``kernel_size`` taps, then the 1x1 output
    conv."""
    width, k = cfg["channel_width"], cfg["kernel_size"]
    flops, c_in = 0, cfg["ninputs"]
    for _ in range(cfg["nblocks"]):
        flops += 2 * c_in * width * k
        c_in = width
    return float(flops + 2 * c_in * cfg["noutputs"])


def encoder_flops_per_sample(cfg: dict) -> float:
    """FXencoder: each residual block's two convs (the first keeps the
    channels at the block's input rate, the second changes them and
    strides), per sample of the encoder's input."""
    chans = [cfg["in_channels"]] + list(cfg["channels"])
    rate, flops = 1.0, 0.0
    for i, (k, s) in enumerate(zip(cfg["kernels"], cfg["strides"])):
        flops += 2 * chans[i] * chans[i] * k * rate
        rate /= s
        flops += 2 * chans[i] * chans[i + 1] * k * rate
    return flops


def k1_bound_s(B: int, T: int, d: int, bf16: bool) -> float:
    """Least time of one K1 launch (the fused TCN block, 128 channels,
    15 taps): the operations of the taps that land inside ``[0, T)`` plus
    the epilogue, over the tensor cores' peak (float32 as three TF32
    passes), against x and y once, w once and the per-channel vectors over
    HBM's rate; the larger of the two."""
    C, K = 128, 15
    valid = sum(max(0, T - abs(k - 7) * d) for k in range(K))
    ops = B * (2 * valid * C * C + 7 * T * C)
    esize = 2 if bf16 else 4
    nbytes = 2 * B * T * C * esize + K * C * C * esize + (3 * C + 2 * B * C) * 4
    t_ops = ops / PEAKS["bfloat16"] if bf16 else 3 * ops / PEAKS["tf32"]
    return max(t_ops, nbytes / PEAKS["hbm_bytes_per_s"])


def k2_bound_s(L: int, T: int, R: int = None) -> float:
    """Least time of one K2 launch (the compressor's envelope over ``L``
    lanes of ``T`` samples, reading ``R`` shared rows when given): x once,
    y once and six per-lane floats over HBM's rate, against 12 float32
    operations a lane-sample over the CUDA cores' peak."""
    t_bytes = ((L if R is None else R) * T + L * T + 6 * L) * 4 / PEAKS["hbm_bytes_per_s"]
    return max(t_bytes, 12 * L * T / PEAKS["float32"])
