"""HTDemucs weights made on the device from a seed (``weights.seeded_state``
draws only convolutions, linear layers and batch norm).

Convolution (1-D, 2-D and transposed), linear and attention projection
weights and biases are uniform in ``+-1/sqrt(fan_in)`` (PyTorch's default
bound: ``weight[0].numel()``, the input width for a projection); the scales
of GroupNorm and LayerNorm and every ``LayerScale`` are uniform in
[0.5, 1.5] and their shifts in +-0.1; the frequency embedding's stored
weight is N(0, 1)/10 (Demucs stores it over its scale of 10). Layer scales
drawn this large, where Demucs starts them at 1e-4 and 1e-3, keep every
layer's contribution far above the comparison's tolerance, so that a layer
left out shows. The layout is read from a module's ``state_dict``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_CONV = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear)


def seeded_state(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict for ``module`` (an HTDemucs) from ``seed``: one
    uniform draw for every tensor but the embedding, one normal draw for
    it."""
    roles, normal = {}, []
    for name, m in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, _CONV):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            roles[prefix + "weight"] = roles[prefix + "bias"] = (-bound, 2 * bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            roles[prefix + "weight"], roles[prefix + "bias"] = (0.5, 1.0), (-0.1, 0.2)
        elif isinstance(m, nn.Embedding):
            normal.append(prefix + "weight")
    state = module.state_dict()
    for k, v in state.items():
        if k.endswith("in_proj_weight") or k.endswith("in_proj_bias"):
            bound = 1.0 / math.sqrt(state[k.replace("_bias", "_weight")].shape[1])
            roles[k] = (-bound, 2 * bound)
        elif k.endswith(".scale"):
            roles[k] = (0.5, 1.0)
    missing = [k for k in state if k not in roles and k not in normal]
    if missing:
        raise ValueError(f"no seeded role for {missing[:4]}")
    uniform = [k for k in state if k in roles]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(state[k].numel() for k in uniform), generator=g, device=device)
    out, ofs = {}, 0
    for k in uniform:
        n = state[k].numel()
        lo, width = roles[k]
        out[k] = (lo + width * u[ofs : ofs + n]).reshape(state[k].shape)
        ofs += n
    for k in normal:
        out[k] = torch.randn(state[k].shape, generator=g, device=device) / 10
    return out
