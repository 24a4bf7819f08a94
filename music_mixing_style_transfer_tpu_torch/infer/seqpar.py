"""Sequence-parallel whole-stem conversion: the time axis split over a mesh.

Counterpart of ``music_mixing_style_transfer_tpu/infer/seqpar.py``. The
reference cuts songs into independent 2^19-sample segments
(``style_transfer.py:274-301``), so its 5.2 s receptive field sees zeros at
every cut. Here one waveform of any length is converted as one forward
would convert it, with no segment boundary: its time axis is split into
one chunk a shard, and before each block every chunk takes its neighbours'
edge frames:

- before block ``n`` (kernel 15, dilation d), each shard gets ``7*d``
  frames from each neighbour (``Tensor.to(device, non_blocking=True)``;
  PyTorch orders a copy between devices after the work that wrote its
  source) and the chunks at the song's edges get zeros, the zero padding of
  the single forward;
- the unmodified ``TCNBlock`` runs on each extended chunk
  ``[B, T_loc + 14*d, C]``: blocks 3-13 through K1 on a card (its plain
  version on the CPU), which takes any T; the block's own zero padding only
  reaches the outer ``7*d`` frames, which are cropped;
- the pointwise output layer and its clamp need no exchange.

The halos are the only work done twice: ``sum_blocks 14*d / (nblocks *
T_loc)``. Shards that share a device (a mesh of repeated entries) run one
after the other on it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TCNConfig
from ..models import MixFXcloner
from ..utils.device import full_float32


def _block_plan(cfg: TCNConfig) -> Tuple[List[Tuple[int, int, int]], int]:
    """Per block (in_ch, out_ch, dilation), and the last block's width."""
    plan = []
    in_ch = cfg.ninputs
    for n in range(cfg.nblocks):
        out_ch = in_ch * cfg.channel_growth if cfg.channel_growth > 1 else cfg.channel_width
        plan.append((in_ch, out_ch, cfg.dilation_growth ** (n % cfg.stack_size)))
        in_ch = out_ch
    return plan, in_ch


def max_halo(cfg: TCNConfig) -> int:
    """The widest block's halo, ``(k-1)/2 * d``: a shard's chunk must be at
    least this long."""
    plan, _ = _block_plan(cfg)
    return max((cfg.kernel_size - 1) // 2 * d for _, _, d in plan)


def seq_parallel_forward(converters: Sequence[MixFXcloner], x: torch.Tensor,
                         cond: torch.Tensor) -> torch.Tensor:
    """``x [B, T, ninputs]`` (channels-last, T a multiple of the shard
    count), ``cond [B, D]`` -> ``[B, T, noutputs]`` float32, equal to one
    eval-mode forward of the converter over the whole ``T``. Shard i runs
    ``converters[i]`` (eval mode, on its device; replicas of one model) on
    the i-th chunk of T; the result is gathered on shard 0's device."""
    cfg = converters[0].config
    if cfg.causal:
        raise NotImplementedError("sequence-parallel path assumes non-causal TCN")
    n_sh = len(converters)
    devs = [next(c.parameters()).device for c in converters]
    dtype = next(converters[0].parameters()).dtype
    B, T, _ = x.shape
    if T % n_sh:
        raise ValueError(f"time axis {T} does not split into {n_sh} equal chunks")
    T_loc = T // n_sh
    hs = [x[:, i * T_loc:(i + 1) * T_loc].to(devs[i], dtype, non_blocking=True) for i in range(n_sh)]
    conds = [cond.to(dev, dtype, non_blocking=True) for dev in devs]
    plan, _ = _block_plan(cfg)
    for n, (_, _, d) in enumerate(plan):
        halo = (cfg.kernel_size - 1) // 2 * d
        if n_sh == 1:
            hs = [converters[0].blocks[n](hs[0], conds[0])]
            continue
        if halo > T_loc:
            raise ValueError(
                f"local chunk {T_loc} shorter than block {n} halo {halo}; "
                "use fewer shards or longer input"
            )
        # every shard's halos come from the chunks before this block runs anywhere
        zeros = [hs[i].new_zeros(B, halo, hs[i].shape[2]) for i in (0, n_sh - 1)]
        lefts = [zeros[0]] + [hs[i - 1][:, -halo:].to(devs[i], non_blocking=True)
                              for i in range(1, n_sh)]
        rights = [hs[i + 1][:, :halo].to(devs[i], non_blocking=True)
                  for i in range(n_sh - 1)] + [zeros[1]]
        hs = [
            conv.blocks[n](torch.cat([left, h, right], dim=1), c)[:, halo:halo + T_loc]
            for conv, left, h, right, c in zip(converters, lefts, hs, rights, conds)
        ]
    # the pointwise output 1x1 and the clamp (models/tcn.py:MixFXcloner.forward)
    outs = [
        (h @ conv.output.weight[:, :, 0].T + conv.output.bias).clamp(-1.0, 1.0).float()
        for conv, h in zip(converters, hs)
    ]
    return torch.cat([o.to(devs[0], non_blocking=True) for o in outs], dim=1)


def make_seq_parallel_converter(converter: MixFXcloner, mesh):
    """``fn(x [B, T, ninputs], cond [B, D]) -> [B, T, noutputs]`` with T
    split over ``mesh`` (``parallel/mesh.py``): ``converter`` replicated
    once on each distinct device of the mesh (eval mode), its result
    equal to one forward over T (JAX ``make_seq_parallel_converter``)."""
    import copy

    converter = converter.eval()
    replicas = {}
    for dev in mesh.distinct:
        replicas[dev] = copy.deepcopy(converter).to(dev)
    convs = [replicas[dev] for dev in mesh.devices]

    @torch.inference_mode()
    def fn(x, cond):
        with full_float32():
            return seq_parallel_forward(convs, x, cond)

    return fn


@torch.inference_mode()
def seq_parallel_convert_device(engine, y_in: torch.Tensor, embs: torch.Tensor) -> torch.Tensor:
    """Batch on the engine's device: ``y_in [S, 2, T]`` float32 with one
    conditioning row each, ``embs [S, D]`` -> ``[S, 2, T]`` float32, T
    padded with zeros to ``T_loc * n_shards`` (``T_loc = max(ceil(T /
    n_shards), max_halo)``) for the forward and cut back. The PCM path's
    ``sequence_parallel`` branch."""
    if engine.mesh is None:
        raise ValueError("sequence-parallel conversion needs a mesh engine")
    cfg = engine.converter_cfg
    n_sh = engine.mesh.size
    T = y_in.shape[-1]
    T_loc = max(-(-T // n_sh), max_halo(cfg))
    x = F.pad(y_in, (0, T_loc * n_sh - T)).transpose(1, 2)  # [S, Tb, 2]
    convs = [engine.replica(dev)[1] for dev in engine.mesh.devices]
    with full_float32():
        out = seq_parallel_forward(convs, x, embs)
    return out.transpose(1, 2)[:, :, :T]


def convert_seq_parallel(engine, audio: np.ndarray, embedding: np.ndarray) -> np.ndarray:
    """Convert a whole ``[2, T]`` waveform in one time-sharded forward.

    Unlike :meth:`StyleTransferEngine.convert_song` (independent segments,
    the reference's semantics), the output is the single-pass conversion
    with the full receptive field: no segment boundaries at all."""
    out = seq_parallel_convert_device(
        engine,
        torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(engine.device),
        torch.from_numpy(np.ascontiguousarray(embedding, np.float32))[None].to(engine.device),
    )
    return out[0].cpu().numpy()
