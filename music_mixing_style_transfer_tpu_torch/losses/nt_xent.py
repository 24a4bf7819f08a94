"""NT-Xent contrastive loss, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/losses/nt_xent.py`` (the
reference NT_Xent, ``modules/loss.py:24-71``, SimCLR formulation) for one
process. The cross-process negatives (the JAX package's ``all_gather``
over ``axis_name``; the reference's gradient-carrying NCCL gather) wait for
the port's DDP item (ROADMAP).
"""
from __future__ import annotations

import torch


def _cosine_sim_matrix(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity with ``torch.nn.CosineSimilarity``'s
    denominator ``max(||a||*||b||, eps)`` (JAX ``nt_xent.py:21-27``), not
    ``F.cosine_similarity``'s, which clamps each norm on its own."""
    norms = torch.linalg.vector_norm(z, dim=-1)
    dots = z @ z.T
    return dots / torch.clamp_min(norms[:, None] * norms[None, :], eps)


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor, temperature: float) -> torch.Tensor:
    """NT-Xent over a batch of positive pairs ``z_i, z_j [B, D]``: the sum
    of the cross entropies of the 2B rows over 2B, each row's positive its
    pair ``(i, i + B)`` and its negatives every other row but itself."""
    z = torch.cat([z_i, z_j], dim=0)
    n_half = z_i.shape[0]
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
