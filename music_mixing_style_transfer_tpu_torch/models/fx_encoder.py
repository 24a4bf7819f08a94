"""FXencoder: contrastive audio-effects encoder, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/models/fx_encoder.py``
(reference ``mixing_style_transfer/networks/architectures.py:26-70``): 12
residual 1-D conv blocks (channels 2->16->...->2048, time downsampled
x4096), then a global mean over time to a 2048-D style embedding. 81,392,682
parameters with the default config. It runs on cuDNN convolutions: the JAX
package has no Pallas kernel here either.

Input ``[batch, 2, T]``; output ``[batch, 2048]``.

``remat`` (training only) recomputes each block in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``nn.remat``): about one
more forward of operations for one block's activations at a time. The
recomputation puts each block's BN running statistics back as they were, so
they update once per forward, as without it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import FXencoderConfig
from ..utils.profiling import spanned
from .blocks import Conv1dLayer, ResConvBlock


@contextlib.contextmanager
def keep_buffers(module: nn.Module):
    """Put every buffer of ``module`` (BN running statistics and counts)
    back as it was on leaving the block."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


class FXencoder(nn.Module):
    def __init__(self, config: Optional[FXencoderConfig] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        cfg = self.config = config or FXencoderConfig()
        channels = (cfg.in_channels,) + tuple(cfg.channels)
        blocks = []
        for i, (k, s, d) in enumerate(zip(cfg.kernels, cfg.strides, cfg.dilation)):
            kw = dict(
                stride=s, dilation=d, use_bias=cfg.bias, norm=cfg.norm, activation=cfg.activation
            )
            if cfg.conv_block == "res":
                blocks.append(
                    ResConvBlock(
                        channels[i], channels[i + 1], k, padding="SAME",
                        last_activation=cfg.activation, **kw,
                    )
                )
            else:
                blocks.append(Conv1dLayer(channels[i], channels[i + 1], k, padding="VALID", **kw))
        self.encoder = nn.ModuleList(blocks)

    @spanned("models.fx_encoder")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.encoder:
            if remat:
                ctx = (lambda b=block: (contextlib.nullcontext(), keep_buffers(b)))
                x = checkpoint(block, x, use_reentrant=False, context_fn=ctx)
            else:
                x = block(x)
        # global average pool over time (AdaptiveAvgPool1d(1), architectures.py:62-70)
        return x.mean(dim=-1)
