"""FXencoder contrastive training (SimCLR-style over FX-manipulated pairs),
in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/train/contrastive.py``:
per instrument, two FX-manipulated views (A, B) of different content are
encoded and pulled together with NT-Xent; the other batch entries,
strong negatives (same content, other FX) among them, are pushed apart.
One process; the data-parallel and FSDP variants wait for the port's DDP
item (ROADMAP).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

from ..config import FXencoderConfig, TrainConfig
from ..losses import nt_xent_loss
from ..models import FXencoder
from ..models.fast_init import fast_init
from ..utils.device import full_float32, resolve_device
from .state import TrainState, make_lr_schedule, make_optimizer


def compute_context(compute_dtype, device) -> contextlib.AbstractContextManager:
    """bfloat16 runs the forward (and so the backward) under autocast;
    parameters, optimizer state and BN statistics stay float32."""
    if compute_dtype == "bfloat16":
        return torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16)
    if compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return contextlib.nullcontext()


def contrastive_loss_fn(
    encoder: FXencoder,
    batch_a: torch.Tensor,
    batch_b: torch.Tensor,
    temperature: float,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """NT-Xent over stacked per-instrument views, summed over instruments.

    ``batch_a/b``: ``[n_inst, B, 2, Ta] / [..., Tb]``, the same instruments'
    A and B views. The two views may have different durations (the
    reference collate draws them independently, ``data_loader.py:51``), so
    each gets its own forward, A first: in training mode BN's running
    statistics update twice a step, as in the JAX package. The similarities
    are computed on float32 embeddings."""
    n_inst, B = batch_a.shape[0], batch_a.shape[1]
    xa = batch_a.reshape((n_inst * B,) + tuple(batch_a.shape[2:]))
    xb = batch_b.reshape((n_inst * B,) + tuple(batch_b.shape[2:]))
    with compute_context(compute_dtype, xa.device):
        za = encoder(xa)
        zb = encoder(xb)
    za = za.float().reshape(n_inst, B, -1)
    zb = zb.float().reshape(n_inst, B, -1)
    loss = 0.0
    for i in range(n_inst):
        loss = loss + nt_xent_loss(za[i], zb[i], temperature)
    return loss


def make_contrastive_train_step(
    temperature: float = 0.1,
    compute_dtype: str = "float32",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch_a, batch_b) -> (state, loss)``: one update of
    ``state.model`` (training mode) by ``state.optimizer`` at the
    schedule's learning rate for ``state.step``. The loss is returned
    detached, on the device (no host sync). cuDNN and matmuls run with TF32
    off, so float32 is float32 on the card too, as in the inference engine."""

    def step(state: TrainState, batch_a, batch_b):
        model, opt = state.model, state.optimizer
        model.train()
        state.set_lr()
        opt.zero_grad(set_to_none=True)
        with full_float32():
            loss = contrastive_loss_fn(model, batch_a, batch_b, temperature, compute_dtype)
            loss.backward()
        opt.step()
        state.step += 1
        return state, loss.detach()

    return step


def init_contrastive(
    config: Optional[FXencoderConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[FXencoder, TrainState, torch.optim.Optimizer]:
    """A fresh encoder (seeded random weights, ``models/fast_init.py``) on
    ``device`` in training mode, its optimizer and a ``TrainState`` at step
    0 with the config's learning-rate schedule."""
    device = resolve_device(device)
    cfg = config or FXencoderConfig()
    tcfg = train_cfg or TrainConfig()
    encoder = fast_init(FXencoder(cfg, remat=tcfg.remat), seed=seed).to(device).train()
    opt = make_optimizer(encoder.parameters(), tcfg.learning_rate, tcfg.weight_decay)
    state = TrainState(step=0, model=encoder, optimizer=opt, lr_schedule=make_lr_schedule(tcfg))
    return encoder, state, opt
