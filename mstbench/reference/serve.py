"""The plain reference of the serving path (``transfer_song_pcm``): FX
normalization, the reference stems' mean embeddings, the converter over
every segment (or a sample of them), and the stems' sum. Whole songs in
float32, the networks a few segments at a time so that they fit beside
nothing else on the card.
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import build, float32_math, lower_precision
from .plain.batch import BatchedAudioEffectsNormalizer
from .plain.config import NormalizationConfig
from .plain.features import load_fx_features

SEGMENTS_A_PASS = 4  # segments of 2^19 a network pass takes at a time


def segments(x: torch.Tensor, L: int) -> torch.Tensor:
    """``[S, 2, T] -> [S, n, 2, L]``, the last segment zero-padded."""
    S, C, T = x.shape
    n = max(1, -(-T // L))
    return F.pad(x, (0, n * L - T)).reshape(S, C, n, L).permute(0, 2, 1, 3)


def mean_embedding(encoder, segs: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The mean embedding ``[D]`` (float32) of ``segs [n, 2, L]``, the
    encoder's input in ``dtype``."""
    return torch.cat([encoder(segs[i : i + SEGMENTS_A_PASS].to(dtype)).float()
                      for i in range(0, segs.shape[0], SEGMENTS_A_PASS)]).mean(0)


class SongReference:
    """The reference for one configuration: ``sizes`` is its file's
    ``encoder`` / ``converter`` / ``inference`` groups, ``enc_state`` and
    ``conv_state`` the weights the benchmark made (``None`` for no
    converter), ``features_path`` the normalizer's features (``None`` for
    no normalizer)."""

    def __init__(self, sizes: dict, enc_state, conv_state, features_path: str, device,
                 control: bool = False):
        self.device = device
        self.inference = sizes["inference"]
        self.encoder = build("encoder", sizes["encoder"], enc_state, device)
        self.converter = None if conv_state is None else build(
            "converter", sizes["converter"], conv_state, device)
        self.norm_cfg = NormalizationConfig()
        self.normalizer = None if features_path is None else BatchedAudioEffectsNormalizer(
            load_fx_features(features_path, stems=self.norm_cfg.stems), self.norm_cfg, device)
        if control:
            for net in (self.encoder, self.converter):
                if net is not None:
                    lower_precision(net)
            if self.normalizer is not None:
                self.normalizer.stage_dtype = torch.bfloat16
        # the same networks in the served dtype: what that dtype's rounding
        # alone costs, the yardstick of the mixture's error
        self.served = torch.bfloat16 if sizes["inference"]["dtype"] == "bfloat16" else torch.float32
        self.nets = {torch.float32: (self.encoder, self.converter)}
        if self.served != torch.float32 and not control:
            self.nets[self.served] = tuple(
                None if n is None else copy.deepcopy(n).to(self.served)
                for n in (self.encoder, self.converter))

    def pcm(self, pcm: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(pcm)).to(self.device)
        return x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x.float()

    @torch.no_grad()
    def normalize(self, input_pcm: np.ndarray, insts: Sequence[str], sweep_limit=None):
        """``(normalize_device's output [S, 2, fft + Tb + fft], the
        converter's input [S, 2, Tb], the compression choices)``;
        ``sweep_limit``: each channel's candidates to sweep (all by default)."""
        S, _, T = input_pcm.shape
        L = self.inference["segment_length"]
        fft = self.norm_cfg.fft_size
        Tb = -(-max(T, 1) // L) * L
        x = F.pad(self.pcm(input_pcm), (fft, fft + Tb - T))
        self.normalizer.sweep_limit = sweep_limit
        with float32_math():
            out = self.normalizer.normalize_device(x, list(insts), [T] * S)
        y_in = out[:, :, fft : fft + Tb].clamp(-1.0, 1.0)
        y_in = y_in * (torch.arange(Tb, device=self.device) < T)
        return out, y_in, self.normalizer.last_compression

    def grid_index(self, insts, ratios, thresholds) -> np.ndarray:
        return self.normalizer.grid_index(list(insts), ratios, thresholds)

    @torch.no_grad()
    def embed_stems(self, ref_pcm: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        """Each reference stem's mean embedding ``[S, D]``: stems longer than
        two segments in segments of ``segment_length_ref``, shorter ones
        whole, padded to a multiple of 4096 samples; the encoder in
        ``dtype``."""
        x = self.pcm(ref_pcm)
        Lr = self.inference["segment_length_ref"]
        T = x.shape[-1]
        if T <= 2 * Lr:
            segs = F.pad(x, (0, max(-(-T // 4096) * 4096, 4096) - T))[:, None]
        else:
            segs = segments(x, Lr)
        with float32_math():
            return torch.stack([mean_embedding(self.nets[dtype][0], s, dtype) for s in segs])

    @torch.no_grad()
    def convert(self, y_in: torch.Tensor, embs: torch.Tensor, T: int, dtype=torch.float32,
                rows=None):
        """The mixture ``[2, T]`` (float32): each stem's segments converted
        under its embedding by the converter in ``dtype``, reassembled and
        summed; with ``rows``, only those segments (zeros elsewhere)."""
        L = self.inference["segment_length"]
        segs = segments(y_in, L)  # [S, n, 2, L]
        S, n = segs.shape[:2]
        rows = torch.arange(n) if rows is None else torch.as_tensor(list(rows))
        mix = torch.zeros(2, n, L, device=self.device)
        net = self.nets[dtype][1]
        with float32_math():
            for s in range(S):
                for i in range(0, len(rows), SEGMENTS_A_PASS):
                    at = rows[i : i + SEGMENTS_A_PASS].to(self.device)
                    part = segs[s, at].to(dtype)
                    cond = embs[s].expand(part.shape[0], -1).to(dtype)
                    mix[:, at] += net(part, cond).float().permute(1, 0, 2)  # [2, k, L]
        return mix.reshape(2, n * L)[:, :T].cpu().numpy()


def choice_mismatches(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> int:
    """Channels whose compression choice differs: active or not, and the
    active ones' (ratio, threshold)."""
    pa, ra = np.asarray(prog["active"], bool), np.asarray(ref["active"], bool)
    same = (pa == ra) & (~pa | ((np.asarray(prog["ratio"]) == np.asarray(ref["ratio"]))
                                & (np.asarray(prog["threshold"]) == np.asarray(ref["threshold"]))))
    return int((~same).sum())
