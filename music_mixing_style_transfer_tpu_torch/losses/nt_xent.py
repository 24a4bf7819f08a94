"""NT-Xent contrastive loss, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/losses/nt_xent.py`` (the
reference NT_Xent, ``modules/loss.py:24-71``, SimCLR formulation). With a
process group, every rank's embeddings form the negatives: ``[z_i; z_j]``
is gathered with gradients (``parallel/collectives.py:gather_with_grad``,
the reference's NCCL gather, ``training_utils.py:130-172``; JAX's
``all_gather`` over ``axis_name``) and reordered to (all i, all j), so the
positive of row i is row ``i + N_total/2`` and every rank computes the same
global loss.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import gather_with_grad


def _cosine_sim_matrix(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity with ``torch.nn.CosineSimilarity``'s
    denominator ``max(||a||*||b||, eps)`` (JAX ``nt_xent.py:21-27``), not
    ``F.cosine_similarity``'s, which clamps each norm on its own."""
    norms = torch.linalg.vector_norm(z, dim=-1)
    dots = z @ z.T
    return dots / torch.clamp_min(norms[:, None] * norms[None, :], eps)


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor, temperature: float,
                 group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """NT-Xent over a batch of positive pairs ``z_i, z_j [B, D]``: the sum
    of the cross entropies of the 2B rows over 2B, each row's positive its
    pair ``(i, i + B)`` and its negatives every other row but itself.

    With ``group`` (the JAX ``axis_name``), ``z_i, z_j`` are this rank's
    rows and the loss is the one over all ranks' rows, in rank order: the
    same value on every rank, equal to the single-process loss on the
    concatenated batch. Gradients flow back through the gather (see
    :func:`~..parallel.collectives.gather_with_grad` for how they add up
    under DDP's mean)."""
    z = torch.cat([z_i, z_j], dim=0)
    n_half = z_i.shape[0]
    if group is not None:
        zg = gather_with_grad(z, group)  # [W, 2B, D], each rank's (i then j)
        W = zg.shape[0]
        z = torch.cat([zg[:, :n_half].reshape(W * n_half, -1), zg[:, n_half:].reshape(W * n_half, -1)])
        n_half = W * n_half
    n = 2 * n_half
    sim = _cosine_sim_matrix(z) / temperature

    pos = torch.cat([torch.diagonal(sim, offset=n_half), torch.diagonal(sim, offset=-n_half)])
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    pos_mask = eye | eye.roll(n_half, dims=1)  # self and the pair (i, i +- B mod 2B)
    neg = sim.masked_fill(pos_mask, float("-inf"))

    # cross entropy with the positive as class 0: -pos + logsumexp([pos, negatives])
    logits_max = torch.maximum(pos, neg.amax(dim=1))
    lse = logits_max + torch.log(
        torch.exp(pos - logits_max)
        + torch.where(pos_mask, 0.0, torch.exp(sim - logits_max[:, None])).sum(dim=1)
    )
    return (lse - pos).sum() / n
