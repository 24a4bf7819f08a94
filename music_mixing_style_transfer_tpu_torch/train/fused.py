"""Fused-augmentation training: FX manipulation runs on the card, between
the raw PCM's upload and the train step.

Counterpart of ``music_mixing_style_transfer_tpu/train/fused.py``. The host
uploads raw int16 segments and the FX plans (and, for the contrastive
step, the crop offsets); the card dequantizes, runs every instrument's
chain (``fx/fastpath.py``: K2 for the compressors), trims the pad, clips
and takes the train step:

- :class:`FusedContrastivePipeline`: the two views of
  ``ContrastivePairDataset``'s batch, cropped to the collate's lengths,
  into the contrastive step;
- :class:`FusedConverterPipeline`: the (A1, A2, B2) triplets of
  ``StyleTransferTripletDataset``'s batch (``fx/fastpath.py:augment_triplets``) into
  the converter step, and its loss-only twin for validation.

Numerics are the generic path's (``fast=False``, one chain per
instrument): the fast path is an evaluation-strategy change
(``tests/test_torch_fastpath.py``). Reference semantics:
``data_loader.py:115-348`` (contrastive pairs), ``:356-539`` (triplets),
``:33-102`` (the variable-length collate).
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..fx.chain import AugmentationChain, plan_to
from ..fx.fastpath import augment_contrastive_views, augment_triplets
from ..models import FXencoder
from ..models.fx_encoder import keep_buffers
from ..utils.device import full_float32, resolve_device
from .contrastive import contrastive_loss_fn, make_contrastive_train_step
from .converter import converter_loss_fn, frozen, make_converter_train_step
from .state import TrainState


def crop_views(views: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """``[n_inst, B, 2, L] -> [n_inst, B, 2, length]``, item j from
    ``starts[j]`` on in every instrument (the collate's contract,
    ``data_loader.py:60-75``); starts are clamped into the signal as
    ``lax.dynamic_slice`` clamps them."""
    L = views.shape[-1]
    starts = torch.as_tensor(starts, dtype=torch.int64, device=views.device).clamp(0, L - length)
    idx = starts[:, None] + torch.arange(length, device=views.device)  # [B, length]
    return torch.gather(views, -1, idx[None, :, None, :].expand(views.shape[:-1] + (length,)))


class _FusedPipeline:
    """Card-resident training on raw batches: ``step`` uploads a batch and
    its plans, augments it (the subclass's ``augment``, with the chains
    of ``set_chains``) and trains on it (its ``_train``); the loss stays on
    the card. With ``sync=True`` it ends each phase in
    ``torch.cuda.synchronize`` (on the card) and leaves the phases' seconds
    in ``last_split``. ``fast``: the batched walk over all instruments
    (``fx/fastpath.py``), else one chain per instrument."""

    def __init__(self, compute_dtype: str, device, fast: bool):
        self.compute_dtype = compute_dtype
        self.fast = fast
        self.device = resolve_device(device)
        self._chains = None
        self.last_split: Dict[str, float] = {}

    def synchronize(self) -> None:
        """Wait for the device's queued work (nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, segs, plans):
        if self._chains is None:
            raise RuntimeError("call set_chains() before step() or loss()")
        segs = torch.as_tensor(np.ascontiguousarray(segs)).to(self.device, non_blocking=True)
        return segs, plan_to(plans, self.device)

    def step(self, state: TrainState, segs, plans, *args,
             sync: bool = False) -> Tuple[TrainState, torch.Tensor]:
        """One training step on a raw batch (``args``: the subclass's)."""
        t0 = time.perf_counter()
        views = self.augment(segs, plans)
        if sync:
            self.synchronize()
            t1 = time.perf_counter()
        state, loss = self._train(state, views, *args)
        if sync:
            self.synchronize()
            t2 = time.perf_counter()
            self.last_split = {"augment_s": t1 - t0, "train_step_s": t2 - t1}
        return state, loss


class FusedContrastivePipeline(_FusedPipeline):
    """Card-resident contrastive training: ``augment -> crop + step``, the
    loss the only value that comes back (and that only when read).

    ``set_chains`` binds the FX chains (the epoch's dataset's; with
    probability scheduling the plans carry the epoch's gates). ``step``
    takes a raw batch from ``ContrastivePairDataset.sample_raw_batch`` and
    the crop plan from ``collate_plan``: ``step(state, segs, plans, sa, sb,
    la, lb)``."""

    def __init__(self, temperature: float = 0.1, compute_dtype: str = "float32", device="cuda",
                 fast: bool = True):
        super().__init__(compute_dtype, device, fast)
        self.temperature = temperature
        self._step = make_contrastive_train_step(temperature, compute_dtype)

    def set_chains(self, manipulators: Dict[str, AugmentationChain], instruments: Sequence[str],
                   pad: int) -> None:
        self._chains = (manipulators, tuple(instruments), pad)

    def augment(self, segs, plans) -> Tuple[torch.Tensor, torch.Tensor]:
        """Upload a raw batch and its plans; the full-length views."""
        segs, plans = self._upload(segs, plans)
        manipulators, instruments, pad = self._chains
        return augment_contrastive_views(manipulators, instruments, segs, plans, pad, self.fast)

    def _train(self, state, views, sa, sb, la: int, lb: int):
        return self._step(state, crop_views(views[0], sa, la), crop_views(views[1], sb, lb))

    @torch.no_grad()
    def loss(self, state: TrainState, segs, plans, sa, sb, la: int, lb: int) -> torch.Tensor:
        """Loss on a (validation) batch: augment, crop, NT-Xent in training
        mode (batch statistics), no update, BN's running statistics left as
        they were."""
        a_full, b_full = self.augment(segs, plans)
        model = state.model.train()
        with keep_buffers(model), full_float32():
            return contrastive_loss_fn(
                model, crop_views(a_full, sa, la), crop_views(b_full, sb, lb),
                self.temperature, self.compute_dtype,
            )


class FusedConverterPipeline(_FusedPipeline):
    """Card-resident converter training against a frozen ``encoder``:
    ``augment_triplets -> converter step``, the counterpart of JAX
    ``make_fused_converter_step`` and its loss-only twin
    ``make_fused_converter_loss`` (JAX ``fused.py:435-493``).

    ``set_chains`` binds the FX chains, the pad and the segment length
    (fixed for a run: the converter keeps its probabilities). ``step(state,
    segs, plans)`` takes a raw batch from
    ``StyleTransferTripletDataset.sample_raw_batch``.
    The encoder moves to the pipeline's device, in eval mode, without
    gradients (``train/converter.py:frozen``)."""

    def __init__(self, encoder: FXencoder, rms_weight: float = 0.1, compute_dtype: str = "float32",
                 ori_weight: float = 0.0, device="cuda", fast: bool = True):
        super().__init__(compute_dtype, device, fast)
        self.encoder = frozen(encoder.to(self.device))
        self.rms_weight, self.ori_weight = rms_weight, ori_weight
        self._step = make_converter_train_step(rms_weight, compute_dtype, ori_weight)

    def set_chains(self, manipulators: Dict[str, AugmentationChain], instruments: Sequence[str],
                   pad: int, seg_len: int) -> None:
        self._chains = (manipulators, tuple(instruments), pad, seg_len)

    def augment(self, segs, plans) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Upload a raw batch and its plans; the (a1, a2, b2) triplets."""
        segs, plans = self._upload(segs, plans)
        manipulators, instruments, pad, seg_len = self._chains
        return augment_triplets(manipulators, instruments, segs, plans, pad, seg_len, self.fast)

    def _train(self, state, views):
        return self._step(state, self.encoder, *views)

    @torch.no_grad()
    def loss(self, state: TrainState, segs, plans) -> torch.Tensor:
        """Loss on a (validation) batch with the converter in training mode,
        as the JAX package computes it (``loop.py:437-441``): BN on the
        batch's statistics, no update, BN's running statistics left as they
        were. (Eval mode would take the running statistics, and K1 in blocks
        3-13: another number.)"""
        a1, a2, b2 = self.augment(segs, plans)
        model = state.model.train()
        with keep_buffers(model), full_float32():
            return converter_loss_fn(model, self.encoder, a1, a2, b2, self.rms_weight,
                                     self.compute_dtype, self.ori_weight)
