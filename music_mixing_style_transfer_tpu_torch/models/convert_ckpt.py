"""Checkpoint conversion CLI: a flax-variables archive -> a PyTorch ``.pt``.

Counterpart of ``music_mixing_style_transfer_tpu/models/convert_ckpt.py``,
in the other direction: weights that the JAX package trained or converted,
exported as an ``.npz`` of ``/``-joined flax paths
(``models/checkpoints.py:ORBAX_EXPORT_RECIPE``), become a state dict in the
published checkpoints' layout, ``{"model": {"module.<name>": tensor}}``
(reference ``modules/training_utils.py:13-29``). The reference's loader,
``models/weights.py:load_torch_state_dict`` and the JAX package's
``models/torch_import.py`` all read it.

    python -m music_mixing_style_transfer_tpu_torch.models.convert_ckpt \
        --model fxencoder --flax_npz runs/enc.npz --out weights/FXencoder_jax.pt
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from .checkpoints import load_flax_archive
from .weights import fxencoder_from_jax, mixfxcloner_from_jax, save_torch_state_dict

_FROM_JAX = {"fxencoder": fxencoder_from_jax, "mixfxcloner": mixfxcloner_from_jax}


def convert(model: str, flax_npz: str, out: str) -> Dict[str, torch.Tensor]:
    """Write ``flax_npz``'s ``model`` weights to ``out`` as a reference-format
    checkpoint; returns the state dict (without the ``module.`` prefixes)."""
    sd = _FROM_JAX[model](load_flax_archive(flax_npz))
    save_torch_state_dict(sd, out)
    return sd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=sorted(_FROM_JAX), required=True)
    p.add_argument("--flax_npz", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    sd = convert(args.model, args.flax_npz, args.out)
    n = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    print(f"converted {args.model}: {n:,} values (parameters and BN statistics) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
