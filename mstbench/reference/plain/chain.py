"""Augmentation chains: probability-gated, order-shuffled FX composition, in
PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/fx/chain.py`` (reference
``AugmentationChain``, ``common_audioeffects.py:91-201``), with the same
tree of stages and semantics:

- "apply with probability p": a gate per draw; the wet branch is computed
  for every draw and selected by the gate;
- "shuffle order": one permutation index per draw over
  ``itertools.permutations`` (the system only shuffles pairs);
- "same FX for every element": one parameter set per draw, applied to every
  segment of the draw (the contrastive positive pairs,
  ``common_audioeffects.py:156-192``);
- "parallel": ``w*x + (1-w)*chain(x)`` with ``w ~ U(0, 0.5)`` or fixed
  (``common_audioeffects.py:186-190``);
- every non-gain processor stage is RMS-normalized after it.

Torch cannot reproduce JAX's keys, so drawing and applying are separate:
``chain.draw(gen, n, probs)`` draws everything for ``n`` draws from a
``torch.Generator`` into a plan, a nested dict of ``[n]`` tensors (the
shuffle index, the parallel weight, and per stage the gate and the
parameters or the sub-chain's plan), and ``chain.apply(plan, x)`` is a
deterministic function of the plan and ``x [n, ..., 2, T]``. The batched
fast path (``fx/fastpath.py``) consumes the same plans.

``probs`` drives the gates of named stages (``Stage.prob_name``) at draw
time, the probability schedule's dynamic probabilities; a gate is
``u < p`` with one uniform per draw whatever ``p`` is, so a plan drawn with
``probs`` equals one drawn from chains rebuilt with those probabilities.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .processors import rms_normalize


def bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-draw ``[n]`` tensor on x's device, shaped to broadcast against
    ``x [n, ...]``."""
    return v.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))


def plan_to(plan, device):
    """The plan's tensors on ``device``."""
    if isinstance(plan, dict):
        return {k: plan_to(v, device) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return [plan_to(v, device) for v in plan]
    return plan.to(device, non_blocking=True)


def cat_plans(plans: Sequence) -> dict:
    """Plans of one chain structure concatenated along their draw axis."""
    p0 = plans[0]
    if isinstance(p0, dict):
        return {k: cat_plans([p[k] for p in plans]) for k in p0}
    if isinstance(p0, (list, tuple)):
        return [cat_plans([p[i] for p in plans]) for i in range(len(p0))]
    return torch.cat(list(plans)) if len(plans) > 1 else p0


class Stage:
    """One chain entry: (processor-or-chain, apply probability, rms-normalize).

    ``prob_name``/``prob_scale`` make the stage's probability dynamic: when
    the chain is drawn with a ``probs`` dict holding ``prob_name``, the gate
    uses ``probs[prob_name] * prob_scale`` (clipped to [0, 1]) instead of
    the baked ``prob``."""

    def __init__(
        self,
        fx,
        prob: float = 1.0,
        rms_norm: bool = True,
        prob_name: Optional[str] = None,
        prob_scale: float = 1.0,
    ):
        self.fx = fx
        self.prob = float(prob)
        self.rms_norm = bool(rms_norm)
        self.prob_name = prob_name
        self.prob_scale = float(prob_scale)

    @property
    def is_chain(self) -> bool:
        return isinstance(self.fx, AugmentationChain)

    def gate_prob(self, probs: Optional[Dict] = None):
        """The gate's probability: dynamic (``probs``) over the baked one."""
        if probs is not None and self.prob_name is not None and self.prob_name in probs:
            p = torch.as_tensor(probs[self.prob_name], dtype=torch.float32) * self.prob_scale
            return p.clamp(0.0, 1.0)
        return self.prob


class AugmentationChain:
    """An augmentation chain over batches of draws: ``draw`` then ``apply``
    (module docstring). The same parameters of a draw go to every segment of
    it: ``x [n_draws, n_items, 2, T]``."""

    def __init__(
        self,
        stages: Sequence[Union[Stage, Tuple]],
        shuffle: bool = False,
        parallel: bool = False,
        parallel_weight_factor: Optional[float] = None,
    ):
        self.stages: List[Stage] = [s if isinstance(s, Stage) else Stage(*s) for s in stages]
        self.shuffle = shuffle
        self.parallel = parallel
        self.parallel_weight_factor = parallel_weight_factor
        if shuffle and len(self.stages) > 3:
            raise ValueError(
                "shuffle evaluates every permutation; "
                f"{len(self.stages)}! orders would bloat the walk. "
                "Restructure the chain (the reference only shuffles pairs)."
            )

    @property
    def perms(self) -> List[Tuple[int, ...]]:
        return list(itertools.permutations(range(len(self.stages))))

    # ------------------------------------------------------------------
    def draw(self, gen: torch.Generator, n: int, probs: Optional[Dict] = None) -> dict:
        """Everything random for ``n`` draws, from ``gen`` (CPU tensors)."""
        plan: dict = {}
        if self.shuffle and len(self.stages) > 1:
            plan["perm"] = torch.randint(0, len(self.perms), (n,), generator=gen)
        if self.parallel and self.parallel_weight_factor is None:
            plan["w"] = torch.rand(n, generator=gen) / 2.0
        stages = []
        for stage in self.stages:
            fx = stage.fx.draw(gen, n, probs) if stage.is_chain else stage.fx.sample(gen, n)
            gate = torch.rand(n, generator=gen) < stage.gate_prob(probs)
            stages.append({"gate": gate, "fx": fx})
        plan["stages"] = stages
        return plan

    # ------------------------------------------------------------------
    def apply_stage(self, i: int, plan: dict, x: torch.Tensor) -> torch.Tensor:
        stage, sp = self.stages[i], plan["stages"][i]
        wet = stage.fx.apply(sp["fx"], x)
        if stage.rms_norm and not stage.is_chain:
            wet = rms_normalize(x, wet)
        return torch.where(bcast(sp["gate"], x), wet, x)

    def _apply_ordered(self, order: Sequence[int], plan: dict, x: torch.Tensor) -> torch.Tensor:
        for i in order:
            x = self.apply_stage(i, plan, x)
        return x

    def apply(self, plan: dict, x: torch.Tensor) -> torch.Tensor:
        """The chain under ``plan`` on ``x [n, ..., 2, T]``. A shuffled chain
        evaluates every order for every draw and selects each draw's."""
        if self.shuffle and len(self.stages) > 1:
            y = None
            for j, order in enumerate(self.perms):
                yj = self._apply_ordered(order, plan, x)
                y = yj if y is None else torch.where(bcast(plan["perm"] == j, x), yj, y)
        else:
            y = self._apply_ordered(range(len(self.stages)), plan, x)
        if self.parallel:
            w = self.parallel_weight_factor
            if w is None:
                w = bcast(plan["w"], x).to(x.dtype)
            y = w * x + (1.0 - w) * y
        return y
