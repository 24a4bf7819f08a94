"""Import the reference's own network code for parity checks.

The port's copy of ``music_mixing_style_transfer_tpu/tools/reference_import.py``.
The reference repository (jhtonyKoo/music_mixing_style_transfer) depends
on ``torchaudio`` and ``pytorch_lightning``, which the shipped model
configs do not exercise: torchaudio backs only the unused ``'up'``/``'down'``
conv modes (reference ``networks/network_utils.py:62-71``), and
``pl.LightningModule`` contributes only ``save_hyperparameters``
(``networks/architectures.py:111``). This module stubs both, puts the
reference package root on ``sys.path`` and imports
``networks.architectures``, so ``tools/parity_check.py`` can run the
reference's own ``FXencoder`` / ``TCNModel`` classes. Nothing is imported
or stubbed until a function is called.

The reference checkout is looked for at ``$MST_REFERENCE_ROOT``, else in
the ``reference/`` directory at the root of this repository (gitignored);
every function also takes the root explicitly.
"""
from __future__ import annotations

import copy
import inspect
import os
import sys
import types
from typing import Any, Dict, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_REFERENCE_ROOT = os.environ.get("MST_REFERENCE_ROOT") or os.path.join(_REPO_ROOT, "reference")


def _install_stubs() -> None:
    import torch

    if "torchaudio" not in sys.modules:
        ta = types.ModuleType("torchaudio")
        ta.transforms = types.SimpleNamespace()  # only 'up'/'down' conv modes use it
        sys.modules["torchaudio"] = ta

    if "pytorch_lightning" not in sys.modules:
        pl = types.ModuleType("pytorch_lightning")

        class LightningModule(torch.nn.Module):
            """Minimal stand-in: the reference only uses the base-module
            behaviour plus ``save_hyperparameters`` + ``self.hparams``."""

            def save_hyperparameters(self) -> None:
                frame = inspect.currentframe().f_back
                loc = dict(frame.f_locals)
                kwargs = loc.pop("kwargs", {})
                loc.pop("self", None)
                loc.pop("__class__", None)
                loc.update(kwargs)
                self.hparams = types.SimpleNamespace(**loc)

        pl.LightningModule = LightningModule
        sys.modules["pytorch_lightning"] = pl


def reference_available(ref_root: str = DEFAULT_REFERENCE_ROOT) -> bool:
    return os.path.isfile(
        os.path.join(ref_root, "mixing_style_transfer", "networks", "architectures.py")
    )


def import_reference_networks(ref_root: str = DEFAULT_REFERENCE_ROOT):
    """Return the reference ``networks.architectures`` module (real code)."""
    if not reference_available(ref_root):
        raise ImportError(f"reference repo not found under {ref_root}")
    _install_stubs()
    pkg_root = os.path.join(ref_root, "mixing_style_transfer")
    if pkg_root not in sys.path:
        sys.path.insert(0, pkg_root)
    import importlib

    return importlib.import_module("networks.architectures")


def reference_model_configs(ref_root: str = DEFAULT_REFERENCE_ROOT) -> Dict[str, Any]:
    """The reference's shipped model configs (``inference/configs.yaml``)."""
    import yaml

    with open(os.path.join(ref_root, "inference", "configs.yaml")) as f:
        return yaml.safe_load(f)


def build_reference_fxencoder(
    arch, ref_root: str = DEFAULT_REFERENCE_ROOT, config: Optional[Dict[str, Any]] = None
):
    """Construct the real reference FXencoder with the shipped default config.

    ``FXencoder.__init__`` mutates ``config["channels"]`` in place
    (``architectures.py:29``), so a deep copy is passed.
    """
    cfg = config or reference_model_configs(ref_root)["Effects_Encoder"]["default"]
    return arch.FXencoder(copy.deepcopy(cfg))


def build_reference_tcn(
    arch, ref_root: str = DEFAULT_REFERENCE_ROOT, config: Optional[Dict[str, Any]] = None
):
    """Construct the real reference TCNModel exactly as the inference CLI does
    (reference ``inference/style_transfer.py:47-57``)."""
    cfg = config or reference_model_configs(ref_root)["TCN"]["default"]
    return arch.TCNModel(
        nparams=cfg["condition_dimension"],
        ninputs=2,
        noutputs=2,
        nblocks=cfg["nblocks"],
        dilation_growth=cfg["dilation_growth"],
        kernel_size=cfg["kernel_size"],
        channel_width=cfg["channel_width"],
        stack_size=cfg["stack_size"],
        cond_dim=cfg["condition_dimension"],
        causal=cfg["causal"],
    )


def save_reference_format_checkpoint(model, path: str) -> None:
    """Write a checkpoint byte-layout-identical to the published ones:
    ``{'model': state_dict}`` with DDP ``module.`` prefixes
    (reference ``modules/training_utils.py:13-29``; stripped on load,
    ``inference/style_transfer.py:98-106``)."""
    from ..models.weights import save_torch_state_dict

    save_torch_state_dict(model.state_dict(), path)
