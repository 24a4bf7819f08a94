"""PyTorch state dict -> flax-layout numpy variables.

Counterpart of ``music_mixing_style_transfer_tpu/models/torch_import.py``,
with numpy and torch only. A reference checkpoint (``FXencoder_ps.pt``,
``MixFXcloner_ps.pt``: a state dict under ``"model"`` with DDP ``module.``
prefixes, reference ``inference/style_transfer.py:94-108``) or a state dict
of the port's modules maps onto the JAX package's
``{"params": ..., "batch_stats": ...}`` trees of nested dicts, key for key
and bit for bit as the JAX package maps it. It is the inverse of
``models/weights.py:fxencoder_from_jax`` / ``mixfxcloner_from_jax``.

Conv kernels stay in the torch layout ``[out, in, k]`` in both packages,
so the mapping is a renaming. BN's ``num_batches_tracked`` has no flax
counterpart and is dropped. ``models/checkpoints.py:save_flax_archive``
writes the result as the ``.npz`` archive both packages exchange.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np


def _strip_ddp(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _count(sd: Mapping[str, Any], prefix: str) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith(prefix)})


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference or port checkpoint file as a flat numpy state dict (the
    ``"model"`` entry when there is one, ``module.`` stripped)."""
    from .weights import load_torch_state_dict as load

    return {k: _np(v) for k, v in load(path).items()}


def fxencoder_from_torch(
    state_dict: Mapping[str, Any], n_blocks: Optional[int] = None
) -> Dict[str, Any]:
    """FXencoder state dict (``encoder.{i}.conv{1,2}.conv1d.{conv1d,batch_norm}.*``)
    -> flax variables; ``n_blocks`` defaults to the blocks the dict holds."""
    sd = {k: _np(v) for k, v in _strip_ddp(dict(state_dict)).items()}
    n_blocks = _count(sd, "encoder.") if n_blocks is None else n_blocks
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_blocks):
        pblock: Dict[str, Any] = {}
        sblock: Dict[str, Any] = {}
        for conv in ("conv1", "conv2"):
            base = f"encoder.{i}.{conv}.conv1d"
            pblock[conv] = {
                "weight": sd[f"{base}.conv1d.weight"],
                "bias": sd[f"{base}.conv1d.bias"],
                "bn": {
                    "scale": sd[f"{base}.batch_norm.weight"],
                    "bias": sd[f"{base}.batch_norm.bias"],
                },
            }
            sblock[conv] = {
                "bn": {
                    "mean": sd[f"{base}.batch_norm.running_mean"],
                    "var": sd[f"{base}.batch_norm.running_var"],
                }
            }
        params[f"block{i}"] = pblock
        stats[f"block{i}"] = sblock
    return {"params": params, "batch_stats": stats}


def mixfxcloner_from_torch(
    state_dict: Mapping[str, Any], n_blocks: Optional[int] = None
) -> Dict[str, Any]:
    """MixFXcloner state dict (``blocks.{n}.{conv1,bn,film.film_fc,res}.*``,
    ``output.*``) -> flax variables; ``n_blocks`` defaults to the blocks the
    dict holds."""
    sd = {k: _np(v) for k, v in _strip_ddp(dict(state_dict)).items()}
    n_blocks = _count(sd, "blocks.") if n_blocks is None else n_blocks
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for n in range(n_blocks):
        base = f"blocks.{n}"
        params[f"block{n}"] = {
            "conv1_weight": sd[f"{base}.conv1.weight"],
            "res_weight": sd[f"{base}.res.weight"],
            "bn": {"scale": sd[f"{base}.bn.weight"], "bias": sd[f"{base}.bn.bias"]},
            "film": {
                "weight": sd[f"{base}.film.film_fc.weight"],
                "bias": sd[f"{base}.film.film_fc.bias"],
            },
        }
        stats[f"block{n}"] = {
            "bn": {"mean": sd[f"{base}.bn.running_mean"], "var": sd[f"{base}.bn.running_var"]}
        }
    params["output_weight"] = sd["output.weight"]
    params["output_bias"] = sd["output.bias"]
    return {"params": params, "batch_stats": stats}


def load_fxencoder_variables(path: str) -> Dict[str, Any]:
    return fxencoder_from_torch(load_torch_state_dict(path))


def load_mixfxcloner_variables(path: str) -> Dict[str, Any]:
    return mixfxcloner_from_torch(load_torch_state_dict(path))
