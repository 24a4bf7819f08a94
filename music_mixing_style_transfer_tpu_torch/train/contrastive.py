"""FXencoder contrastive training (SimCLR-style over FX-manipulated pairs),
in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/train/contrastive.py``:
per instrument, two FX-manipulated views (A, B) of different content are
encoded and pulled together with NT-Xent; the other batch entries,
strong negatives (same content, other FX) among them, are pushed apart.

Parallelism (JAX ``make_sharded_contrastive_step`` and the FSDP trio): one
process per rank, each with its share of the batch; NT-Xent gathers the
embeddings of every rank with gradients (``losses/nt_xent.py``), the
gradients are averaged over the ranks (DDP, or FSDP2's reduce-scatter) and
so are BN's running statistics after each step (JAX ``pmean(new_stats)``);
batch statistics inside a step stay per rank, as in JAX and the reference.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import FXencoderConfig, TrainConfig
from ..losses import nt_xent_loss
from ..models import FXencoder
from ..models.fast_init import fast_init
from ..parallel.collectives import DataParallel, average_bn_stats_
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
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """NT-Xent over stacked per-instrument views, summed over instruments.

    ``batch_a/b``: ``[n_inst, B, 2, Ta] / [..., Tb]``, the same instruments'
    A and B views. The two views may have different durations (the
    reference collate draws them independently, ``data_loader.py:51``), so
    each gets its own forward, A first: in training mode BN's running
    statistics update twice a step, as in the JAX package. The similarities
    are computed on float32 embeddings. With ``group`` (the JAX
    ``axis_name``), ``batch_a/b`` hold this rank's items and the loss is
    the global one, the same on every rank."""
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
        loss = loss + nt_xent_loss(za[i], zb[i], temperature, group)
    return loss


def _step_fn(temperature, compute_dtype, group, wrap):
    """The train step around ``wrap(model)``: the model, DDP over it, or an
    FSDP-sharded model as it is."""

    def step(state: TrainState, batch_a, batch_b):
        model, opt = state.model, state.optimizer
        model.train()
        state.set_lr()
        opt.zero_grad(set_to_none=True)
        with full_float32():
            loss = contrastive_loss_fn(wrap(model), batch_a, batch_b, temperature, compute_dtype,
                                       group)
            loss.backward()
        opt.step()
        if group is not None:
            average_bn_stats_(model, group)
        state.step += 1
        return state, loss.detach()

    return step


def make_contrastive_train_step(
    temperature: float = 0.1,
    compute_dtype: str = "float32",
    group: Optional[dist.ProcessGroup] = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch_a, batch_b) -> (state, loss)``: one update of
    ``state.model`` (training mode) by ``state.optimizer`` at the
    schedule's learning rate for ``state.step``. The loss is returned
    detached, on the device (no host sync). cuDNN and matmuls run with TF32
    off, so float32 is float32 on the card too, as in the inference engine.

    With ``group``, the data-parallel step (the twin of JAX
    ``make_sharded_contrastive_step``): each rank passes its own items, the
    model runs under DDP over ``group``, NT-Xent's negatives are every
    rank's, and after the update BN's running statistics are averaged over
    the ranks. The gradients left in the parameters (``p.grad``) are the
    averaged ones: without BN, the single-process gradient of the global
    loss (with BN, batch statistics are per rank, as in JAX). The loss is
    the global one on every rank."""
    return _step_fn(temperature, compute_dtype, group, DataParallel(group))


def shard_train_state(state: TrainState, group: dist.ProcessGroup) -> TrainState:
    """FSDP2 (``fully_shard``) over ``group`` on ``state.model``, and the
    optimizer rebuilt over the sharded parameters (its class and settings
    kept), so each rank holds 1/W of every parameter and of its Adam
    moments (JAX ``shard_train_state``). The model must be on this rank's
    device and the optimizer fresh (no step taken).

    Layout: FSDP2 shards every parameter on dim 0, padded to a multiple of
    W, where JAX's ``fsdp_specs`` shards a leaf only when it has at least
    ``min_size`` elements and W divides its dim 0, and replicates the rest;
    the small leaves' padding costs memory, not numbers. BN's buffers stay
    whole on every rank, as JAX replicates ``batch_stats``. Parameters are
    gathered whole for the step (one group, kept whole from the first
    forward to the end of the backward), as JAX's step all-gathers them at
    use."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    opt = state.optimizer
    if opt.state:
        raise ValueError("shard_train_state needs a fresh optimizer (no step taken)")
    dev = next(state.model.parameters()).device
    fully_shard(state.model, mesh=DeviceMesh.from_group(group, dev.type),
                reshard_after_forward=False)
    state.optimizer = type(opt)(state.model.parameters(), **opt.defaults)
    return state


def make_fsdp_contrastive_step(
    group: dist.ProcessGroup,
    temperature: float = 0.1,
    compute_dtype: str = "float32",
):
    """The FSDP step (JAX ``make_fsdp_contrastive_step``) on a state laid
    out by :func:`shard_train_state`: each rank passes its own items; the
    gradients come back reduce-scattered and averaged, each rank's slice
    of the single-process gradient of the global loss, and the optimizer
    updates 1/W of the state on each rank. It equals the replicated step.
    Like JAX's, it is a library path: the training loops use the
    replicated step."""
    return _step_fn(temperature, compute_dtype, group, lambda model: model)


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
