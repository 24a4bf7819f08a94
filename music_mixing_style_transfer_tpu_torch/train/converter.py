"""MixFXcloner (converter) training, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/train/converter.py``
(SURVEY.md §3.5): with a frozen pretrained FXencoder, each example is a
triplet ``(A1 input, A2 ground truth, B2 reference)`` in which A2 and B2
got the same random FX; the TCN converts A1 conditioned on
``FXencoder(B2)`` and learns from the multi-scale mid/side spectral loss
plus the RMS gain loss. Data parallel over a process group (JAX
``make_sharded_converter_step``): each rank its share of the triplets,
the converter under DDP, and the gradients, BN's running statistics and
the loss averaged over the ranks; the frozen encoder has no gradients and
is not wrapped.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..config import TCNConfig, TrainConfig
from ..losses import multiscale_spectral_midside, multiscale_spectral_stereo, rms_loss
from ..models import FXencoder, MixFXcloner
from ..models.fast_init import fast_init
from ..parallel.collectives import DataParallel, all_reduce_mean_, average_bn_stats_
from ..utils.device import full_float32, resolve_device
from .contrastive import compute_context
from .state import TrainState, make_lr_schedule, make_optimizer


def frozen(encoder: nn.Module) -> nn.Module:
    """The encoder as the converter trainer uses it: eval mode (BN on its
    running statistics), no gradients; returns ``encoder``."""
    return encoder.eval().requires_grad_(False)


def converter_loss_fn(
    converter: MixFXcloner,
    encoder: FXencoder,
    a1: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    rms_weight: float = 0.1,
    compute_dtype: str = "float32",
    ori_weight: float = 0.0,
) -> torch.Tensor:
    """``a1/a2/b2``: ``[B, 2, T]``, the instruments stacked upstream. The
    encoder (eval mode, see :func:`frozen`) embeds B2 without a graph; the
    converter runs in whatever mode it is in (training: batch statistics,
    its BN buffers updated). bfloat16 runs both forwards under autocast;
    the losses take the float32-cast prediction. ``ori_weight`` adds the
    reference's per-channel L/R term (``mode='ori'``, ``loss.py:154-177``),
    which sees a static channel imbalance that mid/side cannot."""
    with compute_context(compute_dtype, a1.device):
        with torch.no_grad():
            emb = encoder(b2)
        pred = converter(a1, emb)
    pred = pred.float()
    loss = multiscale_spectral_midside(pred, a2) + rms_weight * rms_loss(pred, a2)
    if ori_weight:
        loss = loss + ori_weight * multiscale_spectral_stereo(pred, a2)
    return loss


def make_converter_train_step(
    rms_weight: float = 0.1,
    compute_dtype: str = "float32",
    ori_weight: float = 0.0,
    group: Optional[dist.ProcessGroup] = None,
) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``step(state, encoder, a1, a2, b2) -> (state, loss)``: one update of
    ``state.model`` (training mode) by ``state.optimizer`` at the
    schedule's learning rate for ``state.step``, against the frozen
    ``encoder``. The loss comes back detached, on the device. cuDNN and
    matmuls run with TF32 off, as in the contrastive step.

    With ``group`` (the twin of JAX ``make_sharded_converter_step``): each
    rank passes its own triplets, the converter runs under DDP (its
    gradients averaged over the ranks), and after the update BN's running
    statistics and the returned loss are the means over the ranks (JAX's
    ``pmean`` of grads, ``new_stats`` and loss)."""
    wrap = DataParallel(group)

    def step(state: TrainState, encoder: FXencoder, a1, a2, b2):
        model, opt = state.model, state.optimizer
        model.train()
        state.set_lr()
        opt.zero_grad(set_to_none=True)
        with full_float32():
            loss = converter_loss_fn(wrap(model), encoder, a1, a2, b2, rms_weight, compute_dtype,
                                     ori_weight)
            loss.backward()
        opt.step()
        loss = loss.detach()
        if group is not None:
            average_bn_stats_(model, group)
            all_reduce_mean_([loss], group)
        state.step += 1
        return state, loss

    return step


def init_converter(
    config: Optional[TCNConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[MixFXcloner, TrainState, torch.optim.Optimizer]:
    """A fresh converter (seeded random weights) on ``device`` in training
    mode, its optimizer and a ``TrainState`` at step 0."""
    device = resolve_device(device)
    tcfg = train_cfg or TrainConfig()
    converter = fast_init(MixFXcloner(config or TCNConfig(), remat=tcfg.remat), seed=seed)
    converter = converter.to(device).train()
    opt = make_optimizer(converter.parameters(), tcfg.learning_rate, tcfg.weight_decay)
    state = TrainState(step=0, model=converter, optimizer=opt, lr_schedule=make_lr_schedule(tcfg))
    return converter, state, opt
