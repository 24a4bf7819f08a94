"""SeFa-style editing of the MixFXcloner's FiLM conditions.

Counterpart of ``music_mixing_style_transfer_tpu/models/sefa.py`` (the
FiLM ``sefa`` branch, reference ``network_utils.py:163-178``): the
eigenvectors of a FiLM layer's column-normalized weight Gram matrix are
edit directions in the condition space; adding ``alpha * eigvec`` to the
condition steers that block's modulation.

The weight is the port's ``blocks.{n}.film.film_fc.weight`` ``[2F,
cond_dim]``, the same array as the JAX package's flax ``film.weight``; the
directions are computed on the host in numpy, as JAX computes them.
``MixFXcloner.forward`` takes a list of per-block conditions (the
reference's per-block ``cond`` list, ``architectures.py:139-140``), and on
the card its fused blocks (K1) take each block's own condition.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Cond = Union[np.ndarray, torch.Tensor]


def _film_weight(film) -> np.ndarray:
    """``[2F, cond_dim]`` float32 on the host from a ``FiLM`` module, its
    ``nn.Linear``, or the weight itself."""
    if isinstance(film, nn.Module):
        film = getattr(film, "film_fc", film).weight
    if isinstance(film, torch.Tensor):
        film = film.detach().float().cpu().numpy()
    return np.asarray(film, dtype=np.float32)


def film_edit_directions(film) -> Tuple[np.ndarray, np.ndarray]:
    """Eigen-directions of a FiLM layer (a ``FiLM`` module or its weight).

    Returns (eigenvalues ``[cond_dim]`` descending, eigenvectors
    ``[cond_dim, cond_dim]``, one direction a row as the reference indexes
    them)."""
    w = _film_weight(film).T  # [cond_dim, 2F]
    w = w / (np.linalg.norm(w + 1e-7, axis=0, keepdims=True))
    eigvals, eigvecs = np.linalg.eigh(w @ w.T)
    order = np.argsort(eigvals)[::-1]
    return eigvals[order], eigvecs[:, order].T


def sefa_edit_condition(cond: Cond, film, eig_idx: int, strength: float) -> Cond:
    """``cond + eigval[idx] * strength * eigvec[idx]`` (the reference's
    edit), in ``cond``'s kind: a tensor stays on its device and dtype."""
    eigvals, eigvecs = film_edit_directions(film)
    shift = eigvals[eig_idx] * strength * eigvecs[eig_idx]
    if isinstance(cond, torch.Tensor):
        return cond + torch.as_tensor(shift, device=cond.device).to(cond.dtype)
    return cond + shift


def sefa_per_block_conditions(
    cond: Cond,
    converter: nn.Module,
    edits: Dict[int, Tuple[int, float]],
    n_blocks: Optional[int] = None,
) -> List[Cond]:
    """The per-block condition list for ``converter`` (the port's
    ``MixFXcloner``) with the blocks in ``edits`` (``block -> (eig_idx,
    strength)``) edited along their own FiLM's directions."""
    n_blocks = len(converter.blocks) if n_blocks is None else n_blocks
    conds = []
    for n in range(n_blocks):
        c = cond
        if n in edits:
            eig_idx, strength = edits[n]
            c = sefa_edit_condition(cond, converter.blocks[n].film, eig_idx, strength)
        conds.append(c)
    return conds
