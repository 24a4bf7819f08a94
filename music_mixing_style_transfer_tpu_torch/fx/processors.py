"""FX processors used by FX normalization, in PyTorch.

Counterpart of part of ``music_mixing_style_transfer_tpu/fx/processors.py``:
``rms_normalize`` and the Haas effect's ``apply``. The JAX package draws the
Haas parameters from a ``jax.random`` key, which torch cannot reproduce;
the imager draws them from ``PRNGKey(0)``, so the port keeps what that draw
gives at 44.1 kHz as constants (``HAAS_PARAMS_44K``, pinned against JAX in
``tests/test_torch_dsp.py``). Not ported yet: the random sampling and the
other processors (the FX engine, ROADMAP).
"""
from __future__ import annotations

from typing import Dict

import torch

# Haas(44100).sample(jax.random.PRNGKey(0)) with the JAX package's bounds
HAAS_PARAMS_44K: Dict[str, object] = {
    "delay": 1281,
    "feedback": 0.3324069678783417,  # float32
    "left": False,
}


def rms_normalize(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Match ``y``'s energy to ``x``'s over their last two axes (reference
    ``AugmentationChain.apply_processor``, ``common_audioeffects.py:142-146``)."""
    ex = (x * x).mean((-2, -1), keepdim=True)
    ey = (y * y).mean((-2, -1), keepdim=True)
    return y * torch.sqrt(ex / ey.clamp_min(eps))


class Haas:
    """Haas stereoization: a feedback-scaled, circularly delayed copy added
    to one channel (reference ``common_audioeffects.py:768-856``)."""

    name = "haas"

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """``x [..., 2, T]`` -> the same with the delayed copy added to the
        left (``params["left"]``) or the right channel."""
        ch = 0 if params["left"] else 1
        add = params["feedback"] * torch.roll(x[..., ch, :], int(params["delay"]), dims=-1)
        return x.index_add(-2, torch.tensor([ch], device=x.device), add.unsqueeze(-2))
