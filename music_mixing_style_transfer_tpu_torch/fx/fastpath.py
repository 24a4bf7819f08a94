"""Batched multi-draw evaluation of augmentation chains: training's hot path,
in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/fx/fastpath.py``. The
generic :class:`~.chain.AugmentationChain` walk evaluates one chain over
its own draws; the trainer has one chain per instrument. This module
evaluates many draws through structurally identical chains in one pass per
stage:

- all instruments' chains walk as one stage tree, and each processor
  applies once over the whole ``[D, items, 2, T]`` draw batch (per-group
  plans concatenated along the draw axis);
- per-group differences in baked gate probabilities need nothing here: the
  gates are already drawn into each group's plan;
- structurally divergent stages (the drums' dual-band reverb,
  ``audio_effects_chain.py:117-141`` in the reference) split the draw axis
  into contiguous same-signature runs, evaluated separately and
  re-concatenated;
- 2-stage shuffled groups (eq/comp, pan/imager) run as two rounds,
  ``h = where(flag, s0(x), s1(x)); y = where(flag, s1(h), s0(h))``: every
  stage op batched over all draws;
- the compressor's envelope runs on K2 for every CUDA tensor
  (``ops/cuda/envelope.py``) through ``Compressor.apply``: one launch over
  lanes = draws x items x channels, each draw's parameters broadcast over
  its lanes; on the CPU it takes K2's plain version through the same
  wrapper. A ``Compressor(blockwise=True)`` differs in its signature, so it
  never shares a stage with an exact one, and its own ``apply`` takes the
  blockwise launch (the JAX package keeps it off its Pallas fast path).

It consumes the plans of ``AugmentationChain.draw``, one per group, so it
is a pure evaluation-strategy change, held against the generic walk under
the same plans in ``tests/test_torch_fastpath.py``.

:func:`augment_contrastive_views` and :func:`augment_triplets`, the two
trainers' augmentations, live here so that both the datasets and the fused
trainer can call them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .chain import AugmentationChain, Stage, bcast, cat_plans
from .processors import rms_normalize


class UnsupportedTopology(Exception):
    """Raised when a chain shape has no batched evaluation strategy."""


# ---------------------------------------------------------------------------
# structural signatures (decide which draws can share one evaluation)
# ---------------------------------------------------------------------------
def _cfg_value(v):
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, tuple):
        return tuple(_cfg_value(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _cfg_value(x)) for k, x in v.items()))
    # tensors (IR banks etc.): merge only when literally the same object
    return id(v)


def _sig(fx):
    if isinstance(fx, AugmentationChain):
        return (
            "chain",
            fx.shuffle,
            fx.parallel,
            fx.parallel_weight_factor,
            tuple(_stage_sig(s) for s in fx.stages),
        )
    return (type(fx).__name__, _cfg_value(vars(fx)))


def _stage_sig(stage: Stage):
    # the baked `prob` is excluded: the gates are in the plans
    return (stage.prob_name, stage.prob_scale, stage.rms_norm, _sig(stage.fx))


# ---------------------------------------------------------------------------
# grouped evaluation
# ---------------------------------------------------------------------------
def _contiguous_runs(items: Sequence, sig_of) -> List[List[int]]:
    runs: List[List[int]] = [[0]]
    for i in range(1, len(items)):
        if sig_of(items[i]) == sig_of(items[runs[-1][0]]):
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def eval_grouped(
    chains: Sequence[AugmentationChain],
    sizes: Sequence[int],
    plans: Sequence[dict],
    x: torch.Tensor,  # [D, I, C, T]
) -> torch.Tensor:
    """Evaluate per-group chains over their contiguous draw slices.

    ``chains[g]`` serves draws ``sum(sizes[:g]) : sum(sizes[:g+1])`` under
    ``plans[g]`` (its ``draw`` for ``sizes[g]`` draws); all groups go
    through one stage tree wherever their structures align (module
    docstring)."""
    c0 = chains[0]
    same_shape = all(
        isinstance(c, AugmentationChain)
        and len(c.stages) == len(c0.stages)
        and c.shuffle == c0.shuffle
        and c.parallel == c0.parallel
        and c.parallel_weight_factor == c0.parallel_weight_factor
        for c in chains
    )
    full_sig_equal = same_shape and all(_sig(c) == _sig(c0) for c in chains[1:])
    if not same_shape or (c0.shuffle and not full_sig_equal):
        if len(chains) == 1:
            # a single group with an unbatchable shape (e.g. a >2-stage shuffle)
            return c0.apply(plans[0], x)
        return _eval_runs(chains, sizes, plans, x, _sig)

    n = len(c0.stages)
    if c0.shuffle and n == 2:
        flag = bcast(torch.cat([p["perm"] for p in plans]) == 0, x)
        s0 = lambda xx: _eval_stage([c.stages[0] for c in chains], sizes,
                                    [p["stages"][0] for p in plans], xx)
        s1 = lambda xx: _eval_stage([c.stages[1] for c in chains], sizes,
                                    [p["stages"][1] for p in plans], xx)
        h = torch.where(flag, s0(x), s1(x))
        y = torch.where(flag, s1(h), s0(h))
    elif c0.shuffle and n > 1:
        # a >2-stage shuffle has no batched strategy: the generic walk, one
        # distinct chain at a time
        if len(set(map(id, chains))) == 1:
            return c0.apply(cat_plans(plans), x)
        return _eval_runs(chains, sizes, plans, x, id)
    else:
        y = x
        for i in range(n):
            y = _eval_stage([c.stages[i] for c in chains], sizes,
                            [p["stages"][i] for p in plans], y)

    if c0.parallel:
        w = c0.parallel_weight_factor
        if w is None:
            w = bcast(torch.cat([p["w"] for p in plans]), x).to(x.dtype)
        y = w * x + (1.0 - w) * y
    return y


def _eval_runs(nodes, sizes, plans, x, sig_of, stage_level=False):
    """Split groups into contiguous same-signature runs; evaluate each run
    on its draw slice and re-concatenate in order."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    outs = []
    for run in _contiguous_runs(nodes, sig_of):
        lo, hi = int(offsets[run[0]]), int(offsets[run[-1] + 1])
        sub = ([nodes[i] for i in run], [sizes[i] for i in run], [plans[i] for i in run], x[lo:hi])
        outs.append(_eval_stage(*sub) if stage_level else eval_grouped(*sub))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _eval_stage(
    stages: Sequence[Stage],
    sizes: Sequence[int],
    plans: Sequence[dict],  # per group: {"gate", "fx"}
    x: torch.Tensor,        # [D, I, C, T]
) -> torch.Tensor:
    """Batched ``AugmentationChain.apply_stage`` over all groups' draws."""
    s0 = stages[0]
    sig0 = _stage_sig(s0)
    if not all(_stage_sig(s) == sig0 for s in stages[1:]):
        return _eval_runs(stages, sizes, plans, x, _stage_sig, stage_level=True)

    if s0.is_chain:
        wet = eval_grouped([s.fx for s in stages], sizes, [p["fx"] for p in plans], x)
    else:
        wet = s0.fx.apply(cat_plans([p["fx"] for p in plans]), x)
        if s0.rms_norm:
            wet = rms_normalize(x, wet)
    gate = torch.cat([p["gate"] for p in plans])
    return torch.where(bcast(gate, x), wet, x)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def eval_manipulators_batched(
    manipulators: Dict[str, AugmentationChain],
    instruments: Sequence[str],
    plans: Dict[str, dict],  # per instrument: its chain's plan for draws_per_inst draws
    x: torch.Tensor,         # [D, I, C, T] float, instrument-major draws
    draws_per_inst: int,
) -> torch.Tensor:
    """Evaluate per-instrument chains over an instrument-major draw batch:
    the same result as ``manipulators[inst].apply(plans[inst], x_inst)``
    for each instrument, with every stage batched across all instruments'
    draws wherever the chain structures align."""
    chains = [manipulators[i] for i in instruments]
    if x.shape[0] != draws_per_inst * len(chains):
        raise ValueError(f"draw batch {x.shape[0]} != {len(chains)} insts x {draws_per_inst}")
    return eval_grouped(chains, [draws_per_inst] * len(chains), [plans[i] for i in instruments], x)


def dequant(segs: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1); float32 passes through."""
    if segs.dtype == torch.int16:
        return segs.to(torch.float32) * (1.0 / 32768.0)
    return segs


def augment_contrastive_views(
    manipulators: Dict[str, AugmentationChain],
    instruments: Sequence[str],
    segs: torch.Tensor,          # [n_inst, items, 2(content A/B), 2(ch), L_load]
    plans: Dict[str, dict],      # per instrument: its chain's plan for items*K draws
    pad: int,
    fast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmented views of ``ContrastivePairDataset``'s raw batch: per
    (item, k) one FX draw applied to both content segments (the positive
    pair), the pad trimmed, clipped to +-1. Returns full-length views
    ``([n_inst, items*K, 2, L], [same])`` for :func:`crop_views`.

    ``fast=True`` evaluates all instruments' chains in one batched walk
    (``fx/fastpath.py``), the generic walk where it cannot."""
    x = dequant(segs)
    if fast:
        try:
            return _augment_contrastive_fast(manipulators, instruments, x, plans, pad)
        except UnsupportedTopology:
            pass
    batch_a, batch_b = [], []
    for i, inst in enumerate(instruments):
        plan = plans[inst]
        K = plan["stages"][0]["gate"].shape[0] // x.shape[1]
        draws = x[i].repeat_interleave(K, dim=0)  # [items*K, 2, 2, L_load], item-major
        man = manipulators[inst].apply(plan, draws)
        if pad:
            man = man[..., pad:-pad]
        man = man.clamp(-1.0, 1.0)
        batch_a.append(man[:, 0])
        batch_b.append(man[:, 1])
    return torch.stack(batch_a), torch.stack(batch_b)


def _augment_contrastive_fast(manipulators, instruments, x, plans, pad):
    """Batched-draw :func:`augment_contrastive_views`: draw axis = (inst,
    item, k), instrument-major; each content pair repeated per k-draw so one
    walk covers every draw."""
    n_inst, B = x.shape[0], x.shape[1]
    DK = plans[instruments[0]]["stages"][0]["gate"].shape[0]  # items * K
    x_draws = x.repeat_interleave(DK // B, dim=1).reshape((n_inst * DK,) + tuple(x.shape[2:]))
    y = eval_manipulators_batched(manipulators, instruments, plans, x_draws, DK)
    if pad:
        y = y[..., pad:-pad]
    y = y.clamp(-1.0, 1.0).reshape((n_inst, DK) + tuple(y.shape[1:]))
    return y[:, :, 0], y[:, :, 1]


def augment_triplets(
    manipulators: Dict[str, AugmentationChain],
    instruments: Sequence[str],
    segs: torch.Tensor,          # [n_inst, items, 2(content A/B), 2(ch), L_load]
    plans: Dict[str, dict],      # per instrument: its chain's plan for items draws
    pad: int,
    seg_len: int,
    fast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The triplets of ``StyleTransferTripletDataset``'s raw batch: per
    (instrument, item) one FX draw applied to both contents, giving A2
    (ground truth, content A) and B2 (reference, content B); A1 is content
    A as it is. Each is trimmed of the pad and clipped to +-1. Returns
    instrument-major ``[n_inst*items, 2, seg_len]`` stacks (a1, a2, b2).

    ``fast=True`` evaluates all instruments' chains in one batched walk
    (:func:`eval_manipulators_batched`), the generic walk where it cannot."""
    x = dequant(segs)
    n_inst, B = x.shape[0], x.shape[1]
    sl = slice(pad, pad + seg_len)
    x = x.reshape((n_inst * B,) + tuple(x.shape[2:]))  # [n_inst*B, 2, 2, L_load]
    man = None
    if fast:
        try:
            man = eval_manipulators_batched(manipulators, instruments, plans, x, B)
        except UnsupportedTopology:
            pass
    if man is None:
        man = torch.cat([manipulators[inst].apply(plans[inst], x[i * B : (i + 1) * B])
                         for i, inst in enumerate(instruments)])
    return (x[:, 0, :, sl].clamp(-1.0, 1.0), man[:, 0, :, sl].clamp(-1.0, 1.0),
            man[:, 1, :, sl].clamp(-1.0, 1.0))
