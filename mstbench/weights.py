"""Model weights made on the device from a seed, in a few large calls.

Convolution and linear weights and biases are uniform in
``+-1/sqrt(fan_in)`` (PyTorch's default bound); batch norm gets scales in
[0.5, 1.5], shifts in +-0.1, running means in +-0.1 and running variances
in [0.5, 1.5], so that a layer whose statistics were dropped or swapped
shows. The benchmark hands the same tensors to the program and to the
reference. The layout is read from a module's ``state_dict`` (names and
shapes), never from the program's initializers.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

# (lower, width) of the uniform draw for each batch-norm tensor
_BN = {"weight": (0.5, 1.0), "bias": (-0.1, 0.2), "running_mean": (-0.1, 0.2),
       "running_var": (0.5, 1.0)}


def seeded_state(module: nn.Module, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` from ``seed``: one uniform draw on
    ``device`` for all tensors, each slice scaled to its role, then rounded
    to ``dtype`` (the type the weights are served in) and returned in
    float32, so that both sides read the same values."""
    roles = {}
    for name, m in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            roles[prefix + "weight"] = (-bound, 2 * bound)
            if m.bias is not None:
                roles[prefix + "bias"] = (-bound, 2 * bound)
        elif isinstance(m, nn.BatchNorm1d):
            for k, r in _BN.items():
                roles[prefix + k] = r
    shapes = {k: v.shape for k, v in module.state_dict().items() if k in roles}
    missing = [k for k, v in module.state_dict().items()
               if k not in roles and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"no seeded role for {missing[:4]}")
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device)
    out, ofs = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        lo, width = roles[k]
        out[k] = (lo + width * u[ofs : ofs + n]).reshape(shape).to(dtype).float()
        ofs += n
    return out


def load(module: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``state`` into ``module`` in place, in the module's own dtypes;
    batch norm's step counters are zeroed."""
    with torch.no_grad():
        for k, v in module.state_dict(keep_vars=True).items():
            if k.endswith("num_batches_tracked"):
                v.zero_()
            else:
                v.copy_(state[k])
    return module
