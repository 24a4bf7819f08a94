"""Checkpointing: step-numbered ``torch.save`` files with keep-last-N.

Counterpart of ``music_mixing_style_transfer_tpu/train/checkpoint.py`` (an
orbax manager there; the reference's torch.save utilities,
``modules/training_utils.py:13-123``: numbered files, resume from the
highest, keep the last 2). A checkpoint ``<directory>/step_<n>.pt`` holds
the step, the model's state dict (parameters and BN buffers) under
``"model"``, so ``models/checkpoints.py:load_model_state`` loads it (or
the directory, taking the newest) as an encoder, and the optimizer's state.
A directory of the JAX trainer's orbax steps is refused: optax's state does
not carry over to torch's Adam (the JAX package does not resume a torch run
either), so a run starts afresh from the weights, exported to an ``.npz``
(``models/checkpoints.py:ORBAX_EXPORT_RECIPE``).
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from ..models.checkpoints import ORBAX_EXPORT_RECIPE, STEP_FILE, is_orbax_dir, step_files
from .state import TrainState


class CheckpointManager:
    """Step-numbered checkpoints with retention (the reference keeps 2)."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        if is_orbax_dir(self.directory):
            raise ValueError(
                f"{self.directory} holds the JAX package's orbax step directories or converted "
                "variables, whose optimizer state does not carry over to the port: train into "
                "a fresh --out_dir. To start from their weights, " + ORBAX_EXPORT_RECIPE
            )

    def steps(self) -> List[int]:
        return sorted(step_files(self.directory))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, STEP_FILE.format(step))

    def save(self, step: int, state: TrainState, extra: Optional[dict] = None) -> None:
        """Write ``step``'s checkpoint (to a temporary name, then renamed),
        then drop all but the newest ``keep``."""
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        }
        if extra:
            payload["extra"] = extra
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[: -self.keep] if self.keep > 0 else []:
            os.remove(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the highest step by default) into ``state``'s
        model and optimizer, on their devices; returns ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state
