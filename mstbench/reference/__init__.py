"""The plain reference that decides ``correct``: float32 PyTorch (TF32 off)
over the frozen copies in ``plain/``, fed the inputs and weights that the
benchmark made. It imports nothing of the port and takes nothing the port
made; it reads the port's outputs only to judge them.

``lower_precision`` turns a reference into the control: the networks'
weights, every convolution's and linear layer's input and every module's
output rounded to fp8 (e4m3, one scale a tensor) for a bfloat16
configuration, and each normalization stage's output rounded to bfloat16
for its float32 stages.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from .. import weights
from .plain.config import FXencoderConfig, TCNConfig
from .plain.fx_encoder import FXencoder
from .plain.tcn import MixFXcloner

FP8_MAX = 448.0  # largest float8_e4m3fn


def tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _layout(kind: str, sizes: dict) -> torch.nn.Module:
    """The reference's ``FXencoder`` or ``MixFXcloner`` at ``sizes``, on
    the meta device."""
    cls, cfg = (FXencoder, FXencoderConfig) if kind == "encoder" else (MixFXcloner, TCNConfig)
    with torch.device("meta"):
        return cls(cfg(**tuples(sizes)))


def seeded_weights(kind: str, sizes: dict, seed: int, device, dtype=torch.float32):
    """The benchmark's weights of the ``kind`` network from ``seed``
    (``weights.seeded_state``), laid out by the reference's own module."""
    return weights.seeded_state(_layout(kind, sizes), seed, device, dtype)


def build(kind: str, sizes: dict, state: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The reference ``FXencoder`` or ``MixFXcloner`` at ``sizes`` on
    ``device`` in float32, with ``state``'s weights, in eval mode."""
    return weights.load(_layout(kind, sizes).to_empty(device=device), state).eval()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def lower_precision(model: torch.nn.Module) -> torch.nn.Module:
    """The control's networks: weights, layer inputs and every module's
    output in fp8 (a bf16 network rounds every op's output to bf16, so
    fp8 weights and inputs alone, float32 between them, can read closer to
    float32 than bf16 does)."""
    def out_fp8(mod, args, out):
        return fp8(out) if isinstance(out, torch.Tensor) and out.is_floating_point() else out

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
                m.weight.copy_(fp8(m.weight))
                m.register_forward_pre_hook(lambda mod, args: (fp8(args[0]),) + tuple(args[1:]))
            m.register_forward_hook(out_fp8)
    return model


@contextlib.contextmanager
def float32_math(tf32: bool = False):
    """TF32 off in convolutions and matmuls (on for the float32 control)."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def nrmse(got, want) -> float:
    """``||got - want|| / ||want||`` in float64."""
    got = torch.as_tensor(np.asarray(got) if not isinstance(got, torch.Tensor) else got).double()
    want = torch.as_tensor(np.asarray(want) if not isinstance(want, torch.Tensor) else want).double()
    return float((got.cpu() - want.cpu()).norm() / want.cpu().norm().clamp_min(1e-30))
