"""Building blocks for the mixing-style-transfer networks, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/models/blocks.py``, itself a
re-design of the reference conv stack
(``mixing_style_transfer/networks/network_utils.py:15-182``):

- ``Conv1dLayer``: reflect-pad (asymmetric SAME) -> conv -> batch-norm -> act.
- ``ResConvBlock``: conv1 (channel-preserving) + residual add, then strided
  conv2 (``network_utils.py:96-119``).
- ``FiLM``: feature-wise linear modulation (``network_utils.py:156-182``).

Submodule and parameter names follow the reference state dict
(``encoder.{i}.conv{1,2}.conv1d.conv1d.*``, ``...conv1d.batch_norm.*``,
``film.film_fc.*``), so a published ``.pt`` loads with ``load_state_dict``.
Activations are ``[batch, channels, time]``.

Reflect padding follows numpy (``jnp.pad(mode="reflect")``): a pad that is
as long as the signal or longer reflects again, where ``F.pad`` raises. The
FXencoder reaches that on short inputs, since time shrinks x4096 through it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch.nn.BatchNorm1d default
LEAKY_SLOPE = 0.01  # torch.nn.LeakyReLU default


def reflect_index(length: int, left: int, right: int, device=None) -> torch.Tensor:
    """Source indices of a numpy-style reflect pad of ``length`` samples by
    ``(left, right)``: the signal extended with period ``2*(length-1)``,
    which is what repeated reflection gives for any pad size."""
    i = torch.arange(-left, length + right, device=device)
    if length == 1:
        return torch.zeros_like(i)
    period = 2 * (length - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= length, period - j, j)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis like ``np.pad(mode="reflect")``."""
    if left == 0 and right == 0:
        return x
    return x.index_select(-1, reflect_index(x.shape[-1], left, right, x.device))


def same_reflect_pad(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """Asymmetric SAME reflect padding on the time axis (reference
    ``network_utils.py:30-34,47``): total pad ``(k-1)*d``, left
    ``pad//2``, right the rest."""
    pad = (kernel_size - 1) * dilation
    return reflect_pad(x, pad // 2, pad - pad // 2)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (so reference state dicts load as they are) whose
    eval forward is the folded per-channel affine ``x*s + t``.

    ``fold()`` returns ``(s, t)`` in float32 from the stored parameters,
    whatever their dtype, for the callers that fold BN into a fused kernel.
    Training mode keeps torch's own batch statistics.
    """

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        s, t = self.fold()
        return x * s.to(x.dtype)[:, None] + t.to(x.dtype)[:, None]


class _ConvNorm(nn.Module):
    """The reference's inner ``conv1d`` container: ``conv1d`` + ``batch_norm``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, dilation, bias, norm):
        super().__init__()
        self.conv1d = nn.Conv1d(
            in_channels, out_channels, kernel_size, stride=stride, dilation=dilation, bias=bias
        )
        self.batch_norm = BatchNorm1d(out_channels) if norm == "batch" else None


class Conv1dLayer(nn.Module):
    """conv -> norm -> activation with SAME (reflect) or VALID padding
    (reference ``network_utils.py:15-89``, "conv" mode)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: str = "SAME",
        dilation: int = 1,
        use_bias: bool = True,
        norm: str = "batch",
        activation: str = "relu",
    ):
        super().__init__()
        self.kernel_size, self.dilation, self.padding = kernel_size, dilation, padding
        self.activation = activation
        self.conv1d = _ConvNorm(
            in_channels, out_channels, kernel_size, stride, dilation, use_bias, norm
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            x = same_reflect_pad(x, self.kernel_size, self.dilation)
        x = self.conv1d.conv1d(x)
        if self.conv1d.batch_norm is not None:
            x = self.conv1d.batch_norm(x)
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "lrelu":
            x = F.leaky_relu(x, LEAKY_SLOPE)
        return x


class ResConvBlock(nn.Module):
    """Residual block ``conv2(conv1(x) + x)`` (reference
    ``network_utils.py:96-119``): conv1 keeps the channels, conv2 changes
    them and may stride."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: str = "SAME",
        dilation: int = 1,
        use_bias: bool = True,
        norm: str = "batch",
        activation: str = "relu",
        last_activation: str = "relu",
    ):
        super().__init__()
        self.conv1 = Conv1dLayer(
            in_channels, in_channels, kernel_size, padding=padding, dilation=dilation,
            use_bias=use_bias, norm=norm, activation=activation,
        )
        self.conv2 = Conv1dLayer(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            dilation=dilation, use_bias=use_bias, norm=norm, activation=last_activation,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x) + x)


class FiLM(nn.Module):
    """Feature-wise linear modulation (reference ``network_utils.py:156-182``):
    ``cond [B, cond_dim] -> film_fc -> (r, b)``, each ``[B, features]``."""

    def __init__(self, cond_dim: int, features: int):
        super().__init__()
        self.features = features
        self.film_fc = nn.Linear(cond_dim, 2 * features)

    def rb(self, cond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(r, b)`` in float32 from the stored parameters, for fused
        kernels that apply FiLM in their epilogue."""
        film = cond.float() @ self.film_fc.weight.float().T + self.film_fc.bias.float()
        return film[:, : self.features], film[:, self.features :]

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """``r*x + b`` on ``[B, features, T]``."""
        r, b = self.rb(cond)
        return r.to(x.dtype)[:, :, None] * x + b.to(x.dtype)[:, :, None]
