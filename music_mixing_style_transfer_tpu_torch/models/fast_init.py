"""Seeded random initialization, used when a checkpoint path is missing.

Counterpart of ``music_mixing_style_transfer_tpu/models/fast_init.py``. Draws
from one explicit ``torch.Generator`` (never the global RNG), with torch's
default conv/linear bound ``U(+-1/sqrt(fan_in))`` (JAX
``blocks.py:_torch_conv_init``) for weights and biases, and BN scale 1,
bias 0, running mean 0, running variance 1. The numbers differ from the JAX
package's for the same seed; parity tests carry weights across instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fast_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer of ``module`` in place (it may come
    from ``to_empty``); returns ``module``."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def uniform_(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            fan_in = m.weight[0].numel()  # (in/groups) * k, or in_features
            bound = 1.0 / math.sqrt(fan_in)
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module


@torch.no_grad()
def seeded_model(cls, seed: int, device="cpu", dtype=torch.float32,
                 randomize_bn: bool = False) -> nn.Module:
    """``cls()`` at its default (published) widths with :func:`fast_init`
    weights, in eval mode on ``device`` in ``dtype``. With ``randomize_bn``
    the BN running statistics and scales are drawn too (from ``seed``), so
    that a mapping that drops or swaps a BN tensor shows."""
    with torch.device("meta"):
        m = cls()
    m = fast_init(m.to_empty(device="cpu"), seed=seed)
    if randomize_bn:
        g = torch.Generator(device="cpu").manual_seed(seed)
        for mod in m.modules():
            if isinstance(mod, nn.BatchNorm1d):
                mod.running_mean.copy_(0.2 * (torch.rand(mod.running_mean.shape, generator=g) - 0.5))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
                mod.weight.copy_(0.5 + torch.rand(mod.weight.shape, generator=g))
    return m.eval().to(device, dtype)
