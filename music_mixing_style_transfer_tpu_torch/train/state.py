"""Training state: the step, the model (parameters and BN buffers) and the
optimizer, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/train/state.py``. The JAX
package keeps the learning-rate schedule inside optax's state as a function
of its step counter; here the schedule is a pure function of
``TrainState.step``, written into the optimizer's param groups before each
update (:meth:`TrainState.set_lr`), so the first update uses ``sched(0)``
as optax does, and a restored step resumes the schedule exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

ADAM_EPS = 1e-8  # optax.adam / optax.adamw default


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Optional[Callable[[int], float]] = None

    def set_lr(self) -> None:
        """Write the schedule's learning rate at ``step`` into the optimizer."""
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.step))
            for group in self.optimizer.param_groups:
                group["lr"] = lr


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    def f(step):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return f


def make_lr_schedule(train_cfg) -> Callable[[int], float]:
    """Learning rate as a pure function of the optimizer step, from
    ``TrainConfig`` fields: optax's ``constant`` (with a linear warmup),
    ``warmup_cosine_decay_schedule`` and ``exponential_decay(staircase)``
    behind a warmup, as the JAX package builds them."""
    lr = train_cfg.learning_rate
    kind = getattr(train_cfg, "lr_schedule", "constant")
    warmup = int(getattr(train_cfg, "lr_warmup_steps", 0))
    if kind == "constant":
        if warmup > 0:
            return _linear(0.0, lr, warmup)
        return lambda step: lr
    if kind == "warmup_cosine":
        decay = max(int(train_cfg.lr_decay_steps), warmup + 1) - warmup
        alpha = 0.0 if lr == 0 else lr * float(train_cfg.lr_end_factor) / lr
        warm = _linear(0.0, lr, warmup)

        def f(step):
            if step < warmup:
                return warm(step)
            count = min(step - warmup, decay)
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
            return lr * ((1.0 - alpha) * cosine + alpha)
        return f
    if kind == "step":
        # reference-style step decay: lr * gamma^(step // step_size)
        size, gamma = int(train_cfg.lr_step_size), float(train_cfg.lr_gamma)
        decay_fn = lambda step: lr * gamma ** math.floor(step / size)
        if warmup > 0:
            warm = _linear(0.0, lr, warmup)
            return lambda step: warm(step) if step < warmup else decay_fn(step - warmup)
        return decay_fn
    raise ValueError(f"unknown lr_schedule {kind!r}")


def current_lr(train_cfg, step) -> float:
    """LR at optimizer step ``step`` (the one the update from ``step`` to
    ``step + 1`` uses), for logging."""
    return float(make_lr_schedule(train_cfg)(int(step)))


def make_optimizer(params, learning_rate: float = 2e-4, weight_decay: float = 0.0):
    """``torch.optim.Adam``, or ``AdamW`` when ``weight_decay > 0``, with
    optax's defaults (betas 0.9/0.999, eps 1e-8; AdamW's decay on every
    parameter, as optax.adamw without a mask)."""
    if weight_decay > 0:
        return torch.optim.AdamW(params, lr=learning_rate, eps=ADAM_EPS, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, eps=ADAM_EPS)
