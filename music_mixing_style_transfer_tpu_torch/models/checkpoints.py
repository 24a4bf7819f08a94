"""Model-checkpoint loading for inference, serving and the converter trainer.

Counterpart of ``music_mixing_style_transfer_tpu/models/checkpoints.py``.
``load_model_state`` sniffs the artifact by its structure, so
``StyleTransferEngine``, ``serve.py``'s ``--ckpt_path_*`` and ``train.cli
converter --encoder_ckpt`` take any of:

- a PyTorch ``.pt`` file: a published reference checkpoint (reference
  README.md:12-16) or a ``step_<n>.pt`` of the port's trainers; the port's
  parameter names follow the reference's;
- a flax-variables archive: an ``.npz`` whose keys are the ``/``-joined
  flax paths (``params/block0/...``, ``batch_stats/...``), mapped through
  ``models/weights.py:fxencoder_from_jax`` or ``mixfxcloner_from_jax`` as
  the module's class says. It is how weights that the JAX package trained
  or converted reach the port (:data:`ORBAX_EXPORT_RECIPE`);
- a directory of the port's trainer checkpoints (``step_<n>.pt``): the
  newest step, as the JAX package takes its newest orbax step.

The JAX package's orbax directories (``convert_ckpt`` output, trainer step
directories) are OCDBT stores with zstd-compressed chunks, which neither the
standard library nor the port's dependencies read: they raise with the
recipe that exports them to the archive.
"""
from __future__ import annotations

import os
import re
import zipfile
from typing import Any, Dict, Mapping

import numpy as np
from torch import nn

from .fx_encoder import FXencoder
from .tcn import MixFXcloner
from .weights import fxencoder_from_jax, load_torch_state_dict, mixfxcloner_from_jax

ORBAX_EXPORT_RECIPE = (
    "export it to a flax-variables archive with the JAX package, then pass the .npz: "
    "python -c \"import sys, numpy as np; from flax.traverse_util import flatten_dict; "
    "from music_mixing_style_transfer_tpu.models.checkpoints import load_model_variables; "
    "np.savez(sys.argv[3], **flatten_dict(load_model_variables(sys.argv[1], sys.argv[2]), "
    "sep='/'))\" <orbax dir> <fxencoder|mixfxcloner> <out.npz>"
)
STEP_FILE = "step_{:08d}.pt"  # a trainer checkpoint's file name (train/checkpoint.py)
_STEP = re.compile(r"^step_(\d+)\.pt$")


def is_orbax_dir(path: str) -> bool:
    """A ``convert_ckpt`` directory (``variables/``) or a JAX trainer
    directory (numeric step directories)."""
    if os.path.isdir(os.path.join(path, "variables")):
        return True
    try:
        return any(n.isdigit() and os.path.isdir(os.path.join(path, n)) for n in os.listdir(path))
    except OSError:
        return False


def step_files(path: str) -> Dict[int, str]:
    """``{n: file}`` for the ``step_<n>.pt`` in directory ``path``."""
    try:
        names = os.listdir(path)
    except OSError:
        return {}
    return {int(m.group(1)): os.path.join(path, m.group(0)) for m in map(_STEP.match, names) if m}


def is_flax_archive(path: str) -> bool:
    """An ``.npz``: a zip of ``.npy`` members only (a ``torch.save`` file is
    a zip too, of ``data.pkl`` and storages)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    return bool(names) and all(n.endswith(".npy") for n in names)


def save_flax_archive(variables: Mapping[str, Any], path: str) -> None:
    """Write nested-dict variables as an ``.npz`` keyed by ``/``-joined paths
    (``flax.traverse_util.flatten_dict(variables, sep="/")``)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(key, v)
            else:
                flat[key] = np.asarray(v)

    walk("", variables)
    with open(path, "wb") as f:  # a file object: np.savez appends no ".npz"
        np.savez(f, **flat)


def load_flax_archive(path: str) -> Dict[str, Any]:
    """An ``.npz`` flax-variables archive as nested dicts of numpy arrays."""
    out: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


def _state_dict_from_flax(variables: Mapping[str, Any], model: nn.Module):
    """Flax variables -> the state dict of ``model``'s class."""
    if isinstance(model, FXencoder):
        return fxencoder_from_jax(variables)
    if isinstance(model, MixFXcloner):
        return mixfxcloner_from_jax(variables)
    raise TypeError(f"no flax mapping for {type(model).__name__}")


def load_model_state(path: str, model: nn.Module) -> nn.Module:
    """Load the checkpoint at ``path`` into ``model`` (strictly); returns
    ``model``."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        steps = step_files(path)
        if steps:
            path = steps[max(steps)]
        elif is_orbax_dir(path):
            raise ValueError(f"{path} is an orbax checkpoint directory of the JAX package: "
                             + ORBAX_EXPORT_RECIPE)
    if os.path.isfile(path):
        if is_flax_archive(path):
            model.load_state_dict(_state_dict_from_flax(load_flax_archive(path), model))
        else:
            model.load_state_dict(load_torch_state_dict(path))
        return model
    raise FileNotFoundError(
        f"{path}: not a torch .pt file, a flax-variables .npz, or a directory of "
        "step_<n>.pt trainer checkpoints"
    )
