"""Collectives of the data-parallel trainers, over a ``torch.distributed``
process group (NCCL on cards, gloo on the CPU or for ranks sharing a card).

- :func:`gather_with_grad`: the all-gather that carries gradients (the
  reference's NCCL gather for NT-Xent's negatives,
  ``training_utils.py:130-172``; JAX's ``lax.all_gather``);
- :func:`all_reduce_mean_`: the JAX package's ``pmean`` of a loss or of
  BN's running statistics;
- :func:`average_bn_stats_`: the latter over a module's BatchNorm layers.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn


class _GatherWithGrad(torch.autograd.Function):
    """``[*] -> [W, *]``, rank r's tensor at ``[r]``. Backward: the incoming
    cotangent summed over the ranks, this rank's slice returned."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[dist.get_rank(ctx.group)], None


def gather_with_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` stacked, ``[W, *x.shape]``, with gradients.

    When every rank computes the same function of the gathered tensor (the
    global NT-Xent loss), each rank's backward yields the whole cotangent
    of that one function; summing it over the ranks and keeping the local
    slice gives each rank's ``x`` W times its true gradient, and DDP's (or
    FSDP's) mean over the W ranks then gives the parameters exactly the
    single-process gradient of the global loss. This is the port's form of
    the JAX package's "pmean, not psum" rule (JAX
    ``train/contrastive.py:107-116``): without the sum, or with a sum of
    the parameters' gradients in place of the mean, the update is W times
    off, which Adam's scale invariance hides after one step."""
    return _GatherWithGrad.apply(x, group)


def all_reduce_mean_(tensors: Iterable[torch.Tensor],
                     group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each tensor by its mean over the ranks, in place (one
    collective for all of them)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def average_bn_stats_(module: nn.Module, group: Optional[dist.ProcessGroup] = None) -> None:
    """BN's running means and variances averaged over the ranks (JAX
    ``pmean(new_stats)``); ``num_batches_tracked`` is the same on every
    rank and stays. Batch statistics inside a step stay per rank, as the
    reference's per-replica BN (no SyncBatchNorm)."""
    all_reduce_mean_(
        [t for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
         for t in (m.running_mean, m.running_var) if t is not None],
        group,
    )


class DataParallel:
    """``model`` wrapped once in ``DistributedDataParallel`` over ``group``
    (``None``: the model itself), for a train step to call: gradients
    averaged over the ranks in the backward pass, parameters broadcast from
    rank 0 when wrapped. Buffers are not broadcast (``broadcast_buffers=False``:
    DDP's default would copy rank 0's BN statistics over the others'); the
    step averages them (:func:`average_bn_stats_`). ``state_dict`` keys stay
    the bare model's, since checkpoints save the model, not the wrapper."""

    def __init__(self, group: Optional[dist.ProcessGroup]):
        self.group = group
        self._model = self._net = None

    def __call__(self, model: nn.Module) -> nn.Module:
        if self.group is None:
            return model
        if model is not self._model:
            from torch.nn.parallel import DistributedDataParallel

            dev = next(model.parameters()).device
            self._net = DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                process_group=self.group, broadcast_buffers=False,
            )
            self._model = model
        return self._net
