"""The plain reference of converter training: the first steps replayed from
the benchmark's initial weights and raw batches, in float32 with TF32 off
(or the control's TF32, or a planted fault, in the program's place).

Each step: the raw int16 batch dequantized, each instrument's FX chain
applied under its plan (the generic walk, one chain an instrument), the
pad trimmed and the triplets clipped; the frozen encoder embeds B2; the
converter (batch-statistics BN) converts A1; the mid/side multi-scale
spectral loss plus the weighted RMS loss; backward; Adam.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import build, float32_math
from .plain.chain import plan_to
from .plain.factory import make_instrument_manipulators
from .plain.spectral import multiscale_spectral_midside, rms_loss


def manipulators(tc: dict):
    """The reference's FX chains, one an instrument (they draw the plans
    that both sides get)."""
    return make_instrument_manipulators(tc["instruments"], tc["apply_prob"], tc["reverb_prob"],
                                        None, tc["sample_rate"])


def augment(chains, tc: dict, segs: np.ndarray, plans: dict, device):
    """``(a1, a2, b2)``, each ``[n_inst * items, 2, segment_length]``,
    instrument-major, from a raw batch ``[n_inst, items, 2, 2, L + 2 pad]``."""
    x = torch.from_numpy(np.ascontiguousarray(segs)).to(device)
    x = x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x.float()
    n_inst, B = x.shape[:2]
    x = x.reshape((n_inst * B,) + tuple(x.shape[2:]))
    man = torch.cat([chains[inst].apply(plan_to(plans[inst], device), x[i * B:(i + 1) * B])
                     for i, inst in enumerate(tc["instruments"])])
    sl = slice(tc["pad"], tc["pad"] + tc["segment_length"])
    return (x[:, 0, :, sl].clamp(-1.0, 1.0), man[:, 0, :, sl].clamp(-1.0, 1.0),
            man[:, 1, :, sl].clamp(-1.0, 1.0))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def replay(sizes: dict, enc_state, conv_state, batches, chains, device,
           tf32: bool = False, fault: Optional[str] = None) -> dict:
    """The first ``len(batches)`` steps: each step's loss, each leaf's
    first gradient norm, each leaf's change after the last step, and the
    first step's triplets and embeddings."""
    tc = sizes["train"]
    encoder = build("encoder", sizes["encoder"], enc_state, device).requires_grad_(False)
    converter = build("converter", sizes["converter"], conv_state, device).train()
    opt = torch.optim.Adam(converter.parameters(), lr=tc["learning_rate"], eps=1e-8)
    start = {k: p.detach().clone() for k, p in converter.named_parameters()}
    losses: List[float] = []
    out = {}
    with float32_math(tf32):
        for k, (segs, plans) in enumerate(batches):
            with torch.no_grad():
                a1, a2, b2 = augment(chains, tc, segs, plans, device)
                if fault == "half_batch":  # half the triplets left out
                    a1, a2, b2 = (t[: t.shape[0] // 2] for t in (a1, a2, b2))
                emb = encoder(b2)
            pred = converter(a1, emb)
            loss = multiscale_spectral_midside(pred, a2) + tc["rms_weight"] * rms_loss(pred, a2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if k == 0:
                out["grad"] = norms({n: p.grad for n, p in converter.named_parameters()})
                out["views"] = [t.cpu() for t in (a1, a2, b2)]
                out["embedding"] = emb.cpu()
            opt.step()
            losses.append(float(loss.detach()))
            del a1, a2, b2, emb, pred, loss
    out["losses"] = losses
    out["change"] = norms({n: p.detach() - start[n] for n, p in converter.named_parameters()})
    return out


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The largest gap between the two sides' norms of a leaf, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)
