"""Full training loops, in PyTorch: the FXencoder (contrastive) and the
MixFXcloner (converter).

Counterpart of ``music_mixing_style_transfer_tpu/train/loop.py``:

- an epoch loop over the MUSDB-layout corpus, FX manipulation on the card
  (``train/fused.py``);
- FX apply-probability scheduling for the encoder (the paper's
  "probability scheduling"; the published encoder is ``FXencoder_ps``):
  per-epoch interpolation from the initial probabilities toward a target,
  the epoch's chains and plans drawn with them; the converter keeps its
  probabilities fixed;
- checkpoints with retention and resume (``train/checkpoint.py``), and a
  deterministic held-out loss.

Data parallel when ``torch.distributed`` is initialized (``torchrun``;
JAX ``loop.py:135-162,367-400``, whose trainers take every local device's
mesh): each rank reads and augments only its block of every global batch
and trains through the data-parallel step; the crop plan is drawn for the
global batch on every rank from the same seed, so a W-rank epoch sees the
items, FX plans and crops of the one-process epoch. Rank 0 alone runs the
held-out loss (on the whole validation batch, as the one-process run does)
and writes ``metrics.jsonl``, the logs' epoch lines and the checkpoints;
the other ranks wait for it at a barrier. Every rank resumes from the
same checkpoint.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import FXencoderConfig, TCNConfig, TrainConfig
from ..data.datasets import ContrastivePairDataset, StyleTransferTripletDataset
from ..data.prefetch import BatchPrefetcher
from ..models import FXencoder
from ..ops.cuda.envelope import compressor_envelope
from ..parallel.mesh import Ranks, rank_device
from ..utils.device import resolve_device
from ..utils.logging import Timer, get_logger
from .checkpoint import CheckpointManager
from .contrastive import init_contrastive
from .converter import init_converter
from .fused import FusedContrastivePipeline, FusedConverterPipeline
from .state import current_lr

log = get_logger("train")

NO_MESH = ("use_mesh=False (--no_mesh) trains on one device, but this process is one of {} "
           "ranks: launch one process (no torchrun) for a single-device run; W ranks never "
           "train W independent models")


def _ranks_and_device(use_mesh: bool, device):
    """This process's ranks and device: with a process group, a bare
    ``"cuda"`` is ``cuda:LOCAL_RANK`` (``parallel/mesh.py:rank_device``)."""
    ranks = Ranks.current()
    if ranks.parallel and not use_mesh:
        raise ValueError(NO_MESH.format(ranks.world_size))
    return ranks, rank_device(device) if ranks.group is not None else resolve_device(device)


def _end_epoch(ranks: Ranks, dev: torch.device, out_dir: str, record: Dict, mgr, epoch: int,
               state, save: bool):
    """Rank 0 appends the epoch's record and saves its checkpoint; every
    rank then meets at a barrier. Under a process group the record also
    holds ``world_size`` and, under ``ranks``, each rank's peak device
    memory (GB since the process started; ``None`` on the CPU) and K2
    launches over the epoch (its steps, and rank 0's validation)."""
    if ranks.group is not None:
        mine = {
            "max_memory_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else None),
            "compressor_envelope": record["launches"]["compressor_envelope"],
        }
        per_rank = [None] * ranks.world_size
        dist.all_gather_object(per_rank, mine, group=ranks.group)
        record["world_size"], record["ranks"] = ranks.world_size, per_rank
    if ranks.is_main:
        _log_metrics(out_dir, record)
        if save:
            mgr.save(epoch + 1, state)
    ranks.barrier()


def _val_mode(data_dir: str) -> Optional[str]:
    """Held-out split directory name ('val' preferred, else 'test')."""
    for mode in ("val", "test"):
        if os.path.isdir(os.path.join(data_dir, mode)):
            return mode
    return None


class _TimedBatches:
    """Wrap ``make_batch`` to add up host batch-production seconds (on the
    prefetch thread; one writer, read at the epoch's end)."""

    def __init__(self, make_batch):
        self._make = make_batch
        self.seconds = 0.0

    def __call__(self, i):
        t0 = time.perf_counter()
        out = self._make(i)
        self.seconds += time.perf_counter() - t0
        return out


def _log_metrics(out_dir: str, record: Dict) -> None:
    """Append one JSON line per epoch to ``<out_dir>/metrics.jsonl``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def schedule_probs(
    initial: Dict[str, float],
    target: Dict[str, float],
    epoch: int,
    total_epochs: int,
) -> Dict[str, float]:
    """Linear probability schedule from ``initial`` to ``target``."""
    t = min(epoch / max(total_epochs - 1, 1), 1.0)
    return {k: (1 - t) * initial[k] + t * target.get(k, initial[k]) for k in initial}


def _run_steps(pipeline, state, make_batch, steps_per_epoch: int):
    """One epoch's steps: batches from ``make_batch`` on the prefetch
    thread, ``pipeline.step(state, *batch, sync=...)`` for each. The
    epoch's second step (its only one if it has one) runs alone on the
    device, synced. Returns ``(state, mean loss, timer, timed batches,
    synced)``, ``synced`` the synced step's seconds and K2 launches."""
    losses, synced = [], None
    timer = Timer()  # per-epoch (not cumulative) wall sections
    timed = _TimedBatches(make_batch)
    synced_at = min(1, steps_per_epoch - 1)  # the second step: past the first's set-up
    for i, batch in enumerate(BatchPrefetcher(timed, steps_per_epoch)):
        if i == synced_at:  # one synced step per epoch, alone on the device
            pipeline.synchronize()
        t0, step_launches0 = time.perf_counter(), compressor_envelope.launches
        with timer.section("step"):
            state, loss = pipeline.step(state, *batch, sync=i == synced_at)
            losses.append(loss)  # on the card: read once at the epoch's end
        if i == synced_at:
            synced = dict(pipeline.last_split, step_s=time.perf_counter() - t0,
                          launches=compressor_envelope.launches - step_launches0)
    return state, float(torch.stack(losses).mean()), timer, timed, synced


def _epoch_record(ranks: Ranks, model: str, epoch: int, loss: float, lr: float, timer, timed,
                  synced, epoch_t0: float, launches0: int, val_launches0: int, val_loss, ds,
                  ds_val) -> Dict:
    """The epoch's ``metrics.jsonl`` record: the JAX package's keys
    (``model``, ``epoch``, ``loss``, ``lr``, ``wall``, ``time``,
    ``val_loss``), the K2 launches under ``launches``, and under ``reader``
    each split's segment reader (``"native"`` or ``"wavio"``; ``val`` is
    ``None`` without a held-out split). Rank 0 alone logs it."""
    wall = {k: round(v, 3) for k, v in timer.totals.items()}
    wall["host"] = round(timed.seconds, 3)
    wall["epoch"] = round(time.perf_counter() - epoch_t0, 3)
    if synced is not None:
        wall["synced_step"] = round(synced["step_s"], 4)
        wall["synced_augment"] = round(synced["augment_s"], 4)
        wall["synced_train_step"] = round(synced["train_step_s"], 4)
    record = {
        "model": model,
        "epoch": epoch,
        "loss": loss,
        "lr": lr,
        "wall": wall,
        "time": time.time(),
        "launches": {
            "compressor_envelope": compressor_envelope.launches - launches0,
            "compressor_envelope_synced_step": None if synced is None else synced["launches"],
            "compressor_envelope_val": compressor_envelope.launches - val_launches0,
        },
        "reader": {"train": ds.files.reader, "val": None if ds_val is None else ds_val.files.reader},
    }
    if val_loss is not None:
        record["val_loss"] = val_loss
    if ranks.is_main:
        log.info(
            "epoch %d  %s loss=%.4f%s  (%s)", epoch, model, loss,
            "" if val_loss is None else f"  val={val_loss:.4f}",
            "  ".join(f"{k}={v}s" for k, v in wall.items()),
        )
    return record


def train_fxencoder(
    data_dir: str,
    out_dir: str,
    encoder_cfg: Optional[FXencoderConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    epochs: int = 10,
    steps_per_epoch: int = 40,
    batch_items: int = 4,
    prob_schedule_target: Optional[Dict[str, float]] = None,
    val_every: int = 1,
    keep_ckpts: int = 2,
    resume: bool = True,
    fused: bool = False,
    instruments=("drums", "bass", "other", "vocals"),
    collate_quantum: int = None,
    save_every: int = 1,
    val_items: int = 2,
    device="cuda",
    use_mesh: bool = True,
):
    """Contrastive FXencoder training on ``device`` (the card unless the
    caller asks for the CPU), data parallel over the process group when
    there is one (the module docstring); ``use_mesh=False`` (the JAX flag)
    raises there. Returns the final ``TrainState``.

    Both ``fused=False`` and ``fused=True`` augment on the device, and give
    the same numbers: ``fused=True`` walks all instruments' chains in one
    batched pass (``fx/fastpath.py``), ``fused=False`` one chain per
    instrument (``AugmentationChain.apply``). The JAX flag chooses between
    host-side and on-device augmentation for the TPU's host link, with the
    same numerics either way (JAX ``train/fused.py:25-28``).

    ``collate_quantum``: bucket size of the random-duration collate
    (default ``max(4096, L//8)``). ``save_every``: checkpoint every N
    epochs; the last epoch always saves. ``val_every``/``val_items``: every
    N epochs, a held-out loss over ``val_items`` items of the corpus' val
    (else test) split at the schedule's end probabilities, fixed seeds,
    full-length views, no update (``val_loss`` in metrics.jsonl).

    Each epoch appends a record to ``<out_dir>/metrics.jsonl`` with the JAX
    package's keys (``model``, ``epoch``, ``loss``, ``lr``, ``probs``,
    ``wall``, ``time``, ``val_loss``), each split's segment reader under
    ``reader``, and the K2 launches under ``launches``:
    the epoch's (``compressor_envelope``), the synced step's and the
    validation's; ``wall`` holds the per-epoch timer sections (``step``:
    the steps' host time, enqueue but for the synced one) and one step's
    synced seconds (``synced_step``, the epoch's second step, or its only
    one, run alone on the device) split into augmentation and train step,
    each ending in a synchronize."""
    ranks, dev = _ranks_and_device(use_mesh, device)
    tcfg = train_cfg or TrainConfig()
    K = tcfg.num_strong_negatives + 1
    _, state, _ = init_contrastive(encoder_cfg, tcfg, seed=tcfg.seed, device=dev)
    pipeline = FusedContrastivePipeline(tcfg.temperature, tcfg.compute_dtype, device=dev,
                                        fast=fused, group=ranks.group)
    pipeline.shard(batch_items, batch_items * K)  # JAX's error before any read

    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), keep=keep_ckpts)
    start_epoch = 0
    if resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        start_epoch = int(mgr.latest_step())
        if ranks.is_main:
            log.info("resumed from epoch %d", start_epoch)

    initial_probs = dict(tcfg.apply_prob)
    final_probs = {k: (prob_schedule_target or {}).get(k, v) for k, v in initial_probs.items()}

    # held-out validation: deterministic seeds + END-of-schedule probs
    val_mode = _val_mode(data_dir) if val_every else None
    ds_val = None
    if val_mode is not None:
        try:
            ds_val = ContrastivePairDataset(
                data_dir, mode=val_mode, instruments=instruments,
                segment_length=tcfg.segment_length,
                num_strong_negatives=tcfg.num_strong_negatives,
                apply_prob_dict=final_probs, reverb_prob=dict(tcfg.reverb_prob), device=dev,
            )
        except FileNotFoundError as e:
            log.warning("no usable %s split for validation (%s)", val_mode, e)

    def compute_val(st) -> float:
        val_pipe = FusedContrastivePipeline(tcfg.temperature, tcfg.compute_dtype, device=dev,
                                            fast=fused)
        val_pipe.set_chains(ds_val.manipulators, ds_val.instruments, ds_val.pad)
        segs, plans = ds_val.sample_raw_batch(list(range(val_items)))
        zero = np.zeros(val_items * K, np.int32)
        L = ds_val.segment_length
        return float(val_pipe.loss(st, segs, plans, zero, zero, L, L))

    for epoch in range(start_epoch, epochs):
        probs = (
            schedule_probs(initial_probs, prob_schedule_target, epoch, epochs)
            if prob_schedule_target
            else initial_probs
        )
        ds = ContrastivePairDataset(
            data_dir, mode="train", instruments=instruments,
            segment_length=tcfg.segment_length,
            num_strong_negatives=tcfg.num_strong_negatives,
            apply_prob_dict=probs, reverb_prob=dict(tcfg.reverb_prob), device=dev,
        )
        pipeline.set_chains(ds.manipulators, ds.instruments, ds.pad)
        rng = np.random.default_rng(tcfg.seed + epoch)
        epoch_t0, launches0 = time.perf_counter(), compressor_envelope.launches

        def make_batch(step):
            # the global batch's crop plan on every rank, then this rank's block
            idxs = list(range(step * batch_items, (step + 1) * batch_items))
            la, lb, sa, sb = ds.collate_plan(len(idxs) * K, rng, collate_quantum)
            items, views = pipeline.shard(len(idxs), len(sa))
            segs, plans = ds.sample_raw_batch(idxs[items], epoch_seed=tcfg.seed + epoch)
            return segs, plans, sa[views], sb[views], la, lb

        state, epoch_loss, timer, timed, synced = _run_steps(pipeline, state, make_batch,
                                                             steps_per_epoch)
        val_launches0 = compressor_envelope.launches
        val_loss = (
            compute_val(state)
            if ranks.is_main and ds_val is not None and (epoch + 1) % max(val_every, 1) == 0
            else None
        )
        record = _epoch_record(ranks, "fxencoder", epoch, epoch_loss, current_lr(tcfg, state.step),
                               timer, timed, synced, epoch_t0, launches0, val_launches0, val_loss,
                               ds, ds_val)
        record["probs"] = {k: round(v, 4) for k, v in probs.items()}
        _end_epoch(ranks, dev, out_dir, record, mgr, epoch, state,
                   (epoch + 1) % max(save_every, 1) == 0 or epoch == epochs - 1)

    return state


def train_converter(
    data_dir: str,
    out_dir: str,
    encoder: FXencoder,
    converter_cfg: Optional[TCNConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    epochs: int = 10,
    steps_per_epoch: int = 40,
    batch_items: int = 2,
    keep_ckpts: int = 2,
    resume: bool = True,
    fused: bool = False,
    instruments=("drums", "bass", "other", "vocals"),
    save_every: int = 1,
    val_every: int = 1,
    val_items: int = 2,
    ori_weight: float = 0.0,
    device="cuda",
    use_mesh: bool = True,
):
    """Converter training on ``device`` (the card unless the caller asks
    for the CPU) against the frozen pretrained ``encoder`` (SURVEY.md §3.5;
    JAX ``train/loop.py:329-540``), data parallel over the process group
    when there is one, as :func:`train_fxencoder`: each rank trains on its
    block of every batch's items, and the epoch's ``loss`` is the mean over
    the ranks. Returns the final ``TrainState``.

    ``encoder``: an ``FXencoder`` holding the pretrained weights (a
    published ``.pt`` or ``train_fxencoder``'s ``<out>/ckpt/step_<n>.pt``,
    through ``models/checkpoints.py:load_model_state``); it moves to
    ``device`` in eval mode. Its embedding width must be the converter's
    ``condition_dimension``.

    ``fused`` as in :func:`train_fxencoder`: both walk the FX chains on the
    device and give the same numbers, ``fused=True`` in one batched pass.
    ``ori_weight`` adds the per-channel L/R spectral term
    (``train/converter.py``). Checkpoints go under ``<out_dir>/ckpt_conv/``;
    ``save_every``/``val_every``/``val_items`` as in
    :func:`train_fxencoder`: the held-out loss runs the converter in
    training mode (batch statistics) with no update and its BN buffers put
    back, as the JAX package computes it. Each epoch appends a record to
    ``<out_dir>/metrics.jsonl``: the JAX keys (``model: "converter"``,
    ``epoch``, ``loss``, ``lr``, ``wall``, ``time``, ``val_loss``) and the
    K2 launches, with the synced step split as in :func:`train_fxencoder`.
    On the card it first empties the allocator's cache."""
    ranks, dev = _ranks_and_device(use_mesh, device)
    if dev.type == "cuda":
        # start from an empty allocator cache, as a new process does, whatever an
        # earlier run in this process left cached (~60 GB after a float32 converter run)
        torch.cuda.empty_cache()
    tcfg = train_cfg or TrainConfig()
    cfg = converter_cfg or TCNConfig()
    if cfg.condition_dimension != encoder.config.embed_dim:
        raise ValueError(
            f"the converter's condition_dimension {cfg.condition_dimension} != the encoder's "
            f"embedding width {encoder.config.embed_dim}"
        )
    _, state, _ = init_converter(cfg, tcfg, seed=tcfg.seed, device=dev)

    mgr = CheckpointManager(os.path.join(out_dir, "ckpt_conv"), keep=keep_ckpts)
    start_epoch = 0
    if resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        start_epoch = int(mgr.latest_step())
        if ranks.is_main:
            log.info("resumed from epoch %d", start_epoch)

    def dataset(mode):  # the converter keeps its FX probabilities fixed
        return StyleTransferTripletDataset(
            data_dir, mode=mode, instruments=instruments, segment_length=tcfg.segment_length,
            apply_prob_dict=dict(tcfg.apply_prob), reverb_prob=dict(tcfg.reverb_prob), device=dev,
        )

    def pipeline_for(ds, group=None):
        pipe = FusedConverterPipeline(encoder, compute_dtype=tcfg.compute_dtype,
                                      ori_weight=ori_weight, device=dev, fast=fused, group=group)
        pipe.set_chains(ds.manipulators, ds.instruments, ds.pad, tcfg.segment_length)
        return pipe

    ds = dataset("train")
    pipeline = pipeline_for(ds, ranks.group)
    pipeline.shard(batch_items, batch_items)  # JAX's error before any read

    # held-out validation: deterministic seeds, the train-mode loss
    val_mode = _val_mode(data_dir) if val_every else None
    ds_val = val_pipe = None
    if val_mode is not None:
        try:
            ds_val = dataset(val_mode)
        except FileNotFoundError as e:
            log.warning("no usable %s split for validation (%s)", val_mode, e)
        else:
            val_pipe = pipeline_for(ds_val)

    def compute_val(st) -> float:
        segs, plans = ds_val.sample_raw_batch(list(range(val_items)))
        return float(val_pipe.loss(st, segs, plans))

    for epoch in range(start_epoch, epochs):
        epoch_t0, launches0 = time.perf_counter(), compressor_envelope.launches

        def make_batch(step):
            idxs = list(range(step * batch_items, (step + 1) * batch_items))
            items, _ = pipeline.shard(len(idxs), len(idxs))
            return ds.sample_raw_batch(idxs[items], epoch_seed=tcfg.seed + epoch)

        state, epoch_loss, timer, timed, synced = _run_steps(pipeline, state, make_batch,
                                                             steps_per_epoch)
        val_launches0 = compressor_envelope.launches
        val_loss = (
            compute_val(state)
            if ranks.is_main and ds_val is not None and (epoch + 1) % max(val_every, 1) == 0
            else None
        )
        record = _epoch_record(
            ranks, "converter", epoch, epoch_loss, current_lr(tcfg, state.step), timer, timed, synced,
            epoch_t0, launches0, val_launches0, val_loss, ds, ds_val,
        )
        _end_epoch(ranks, dev, out_dir, record, mgr, epoch, state,
                   (epoch + 1) % max(save_every, 1) == 0 or epoch == epochs - 1)

    return state
