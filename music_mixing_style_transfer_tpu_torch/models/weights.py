"""Carry weights into the port's modules.

- ``fxencoder_from_jax`` / ``mixfxcloner_from_jax`` take the JAX package's
  ``{"params", "batch_stats"}`` variables (nested dicts of numpy arrays) and
  return the port's state dicts. They invert ``fxencoder_from_torch`` and
  ``mixfxcloner_from_torch`` (JAX ``models/torch_import.py:42-114``); the
  JAX package keeps conv kernels in the torch layout ``[out, in, k]``, so
  this is a renaming, no transposes.
- ``train_state_from_jax`` carries a JAX ``TrainState``'s parameters and
  BN statistics (an FXencoder's or a MixFXcloner's) into a fresh port
  ``TrainState`` (new Adam state), so both packages can train from the
  same weights.
- ``load_torch_state_dict`` reads a published reference checkpoint
  (``FXencoder_ps.pt``, ``MixFXcloner_ps.pt``): a state dict, possibly
  under a ``"model"`` key and with DDP ``module.`` prefixes
  (JAX ``torch_import.py:20-39``); ``save_torch_state_dict`` writes that
  layout.

State dicts carry BN's ``num_batches_tracked`` (0 here), as torch's
``BatchNorm1d`` and the published checkpoints do.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bn(prefix: str, params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _t(params["scale"]),
        f"{prefix}.bias": _t(params["bias"]),
        f"{prefix}.running_mean": _t(stats["mean"]),
        f"{prefix}.running_var": _t(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def fxencoder_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FXencoder variables -> port ``FXencoder`` state dict
    (``encoder.{i}.conv{1,2}.conv1d.{conv1d,batch_norm}.*``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    n_blocks = len([k for k in params if k.startswith("block")])
    for i in range(n_blocks):
        for conv in ("conv1", "conv2"):
            p, s = params[f"block{i}"][conv], stats[f"block{i}"][conv]
            base = f"encoder.{i}.{conv}.conv1d"
            sd[f"{base}.conv1d.weight"] = _t(p["weight"])
            sd[f"{base}.conv1d.bias"] = _t(p["bias"])
            sd.update(_bn(f"{base}.batch_norm", p["bn"], s["bn"]))
    return sd


def mixfxcloner_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MixFXcloner variables -> port ``MixFXcloner`` state dict
    (``blocks.{n}.{conv1,bn,film.film_fc,res}.*``, ``output.*``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    n_blocks = len([k for k in params if k.startswith("block")])
    for n in range(n_blocks):
        p, s = params[f"block{n}"], stats[f"block{n}"]
        base = f"blocks.{n}"
        sd[f"{base}.conv1.weight"] = _t(p["conv1_weight"])
        sd.update(_bn(f"{base}.bn", p["bn"], s["bn"]))
        sd[f"{base}.film.film_fc.weight"] = _t(p["film"]["weight"])
        sd[f"{base}.film.film_fc.bias"] = _t(p["film"]["bias"])
        sd[f"{base}.res.weight"] = _t(p["res_weight"])
    sd["output.weight"] = _t(params["output_weight"])
    sd["output.bias"] = _t(params["output_bias"])
    return sd


def train_state_from_jax(jax_state, config=None, train_cfg=None, device="cpu", model="fxencoder"):
    """A JAX ``train/state.py:TrainState`` (``params``, ``batch_stats``,
    ``step``) -> the port's ``TrainState``: an ``FXencoder`` (``model=
    "fxencoder"``) or a ``MixFXcloner`` (``model="converter"``) of
    ``config`` holding those weights on ``device`` in training mode, with
    ``remat`` from ``train_cfg``, a fresh optimizer (``make_optimizer``) and
    the step carried over."""
    from ..config import TrainConfig
    from ..train.state import TrainState, make_lr_schedule, make_optimizer
    from .fx_encoder import FXencoder
    from .tcn import MixFXcloner

    cls, to_torch = {
        "fxencoder": (FXencoder, fxencoder_from_jax),
        "converter": (MixFXcloner, mixfxcloner_from_jax),
    }[model]
    tcfg = train_cfg or TrainConfig()
    module = cls(config, remat=tcfg.remat)
    module.load_state_dict(to_torch({"params": jax_state.params, "batch_stats": jax_state.batch_stats}))
    module = module.to(device).train()
    opt = make_optimizer(module.parameters(), tcfg.learning_rate, tcfg.weight_decay)
    return TrainState(int(jax_state.step), module, opt, make_lr_schedule(tcfg))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference checkpoint file into a flat CPU state dict, taking
    the ``"model"`` entry when there is one and stripping ``module.``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def save_torch_state_dict(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``state_dict`` in the published checkpoints' layout,
    ``{"model": {"module.<name>": tensor}}`` (reference
    ``modules/training_utils.py:13-29``), which :func:`load_torch_state_dict`
    reads back."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": {f"module.{k}": v for k, v in state_dict.items()}}, path)
