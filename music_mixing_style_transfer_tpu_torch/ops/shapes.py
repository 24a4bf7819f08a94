"""Shape utilities for convolutional audio models, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/ops/shapes.py``
(reference ``common_miscellaneous.py:144-219``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_to_length(x: torch.Tensor, length: int) -> torch.Tensor:
    """Right-pad with zeros or right-trim the last dimension to ``length``
    (reference ``pad_to_shape`` :164-177)."""
    T = x.shape[-1]
    if T >= length:
        return x[..., :length]
    return F.pad(x, (0, length - T))


def valid_length(
    input_size: int, kernel_size: int, stride: int = 1, padding: int = 0, dilation: int = 1
) -> int:
    """Nearest upper length leaving no leftover frames in a 1-D conv
    (reference :180-200)."""
    length = math.ceil(
        (input_size + 2 * padding - dilation * (kernel_size - 1) - 1) / stride
    ) + 1
    return int((length - 1) * stride - 2 * padding + dilation * (kernel_size - 1) + 1)


def is_complete_convolution(
    input_size: int, kernel_size: int, stride: int = 1, padding: int = 0, dilation: int = 1
) -> bool:
    """True when no time steps are discarded (reference :144-161)."""
    return float(
        (input_size + 2 * padding - dilation * (kernel_size - 1) - 1) / stride + 1
    ).is_integer()


def td_length_from_fd(fd_length: int, fft_size: int, fft_hop: int) -> int:
    """Time-domain length producing ``fd_length`` STFT frames without padding
    (reference :203-219)."""
    return (fd_length - 1) * fft_hop + fft_size
