"""Audio-effects-chain normalizer: the inference-side FX normalization, in
PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/normalize/normalizer.py``
(reference ``mixing_manipulator/data_normalization.py:19-172``): input stems
are normalized, in order, for loudness / EQ / compression / stereo image
toward precomputed MUSDB18 average features, so the converter sees a
"style-less" input. Two paths: the batched one (:mod:`.batch`, every stage
once for all stems, what the pipeline runs) and the reference's own
per-channel one (``normalize_audio``), which the batched path is held to.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import NormalizationConfig
from ..ops.loudness import lufs_normalize
from ..utils.device import resolve_device
from .features import load_fx_features
from .imager import normalize_imager
from .matching import amp_to_db, comp_match, eq_match, panning_match


class AudioEffectsNormalizer:
    """FX normalization toward precomputed average features, on ``device``
    (the card unless the caller asks for ``"cpu"``).

    The effects order matters; inference uses
    ``['loudness','eq','compression','imager','loudness']``
    (reference ``style_transfer.py:372``).
    """

    def __init__(
        self,
        precomputed_feature_path: str,
        config: Optional[NormalizationConfig] = None,
        device="cuda",
    ):
        self.cfg = config or NormalizationConfig()
        self.device = resolve_device(device)
        self.features = load_fx_features(precomputed_feature_path, stems=self.cfg.stems)
        self._batched = None

    def batched(self):
        """The (cached) batched, device-resident implementation."""
        if self._batched is None:
            from .batch import BatchedAudioEffectsNormalizer

            self._batched = BatchedAudioEffectsNormalizer(self.features, self.cfg, self.device)
        return self._batched

    def normalize_stems(self, stems) -> dict:
        """Batched multi-stem normalization: every stage runs once for all
        stems' channels (see :mod:`.batch`)."""
        return self.batched().normalize_stems(stems)

    @torch.inference_mode()
    def normalize_audio(self, audio: np.ndarray, src: str) -> np.ndarray:
        """The configured chain of per-effect normalizations on one ``[2, T]``
        float32 stem named ``src`` (one of ``cfg.stems``)."""
        if src not in self.cfg.stems:
            raise ValueError(f"unknown stem {src!r}; expected one of {self.cfg.stems}")
        out = np.asarray(audio, np.float32)
        for effect in self.cfg.effects:
            out = self.normalize_audio_per_effect(out, src, effect)
        return out

    @torch.inference_mode()
    def normalize_audio_per_effect(self, audio: np.ndarray, src: str, effect: str) -> np.ndarray:
        """One normalization stage (reference ``data_normalization.py:87-155``)
        on ``[2, T]``: the signal is zero-padded by ``fft_size`` on both sides
        while it is processed and trimmed back, and the stage is skipped when
        the stem peaks at or below ``min_db``.

        The compression stage matches each channel. A channel's matching
        failure (an ``ArithmeticError``, such as :class:`.matching.MatchingError`)
        leaves the stem unchanged, as the reference swallows its matching's
        failures; anything else (the envelope kernel's wrapper, its build,
        CUDA) propagates."""
        cfg = self.cfg
        T = audio.shape[-1]
        x = np.pad(np.asarray(audio, np.float32), ((0, 0), (cfg.fft_size, cfg.fft_size)))
        if amp_to_db(np.max(np.abs(x))) <= cfg.min_db:
            return audio
        xd = torch.from_numpy(x).to(self.device)
        if effect == "eq":
            y = torch.stack([
                eq_match(
                    xd[ch], self.features["eq"][src], sr=cfg.sample_rate, n_fft=cfg.fft_size,
                    hop_length=cfg.hop_length, min_db=cfg.min_db, ntaps=cfg.ntaps, lufs=cfg.lufs,
                )
                for ch in range(x.shape[0])
            ])
        elif effect == "compression":
            ref_peak, ref_std = self.features["compression"][src]
            attack, release, ratio, _n_mels = cfg.comp_settings[src]
            try:
                y = torch.stack([
                    comp_match(
                        xd[ch], float(ref_peak), float(ref_std), ratio, attack, release,
                        sr=cfg.sample_rate, min_db=cfg.min_db, comp_peak_norm=cfg.comp_peak_norm,
                        min_th=cfg.comp_min_th, max_ratio=cfg.comp_max_ratio,
                        percentile=cfg.comp_percentile, expander=cfg.comp_use_expander,
                    )
                    for ch in range(x.shape[0])
                ])
            except ArithmeticError:
                y = xd
        elif effect == "loudness":
            target = float(np.asarray(self.features["loudness"][src]).reshape(-1)[0])
            y = lufs_normalize(xd.T, cfg.sample_rate, target).T  # BS.1770 takes [T, C]
        elif effect == "imager":
            y = normalize_imager(
                xd, target_side_mid_bal=float(self.features["imager"][src]),
                mono_threshold=0.99 if src == "bass" else 0.975, sr=cfg.sample_rate,
            )
        elif effect == "panning":
            # dataset-prep panning normalization (the inference feature file
            # carries no panning targets; needs features['panning'][src])
            y = panning_match(xd, np.asarray(self.features["panning"][src]), sr=cfg.sample_rate)
        else:
            raise ValueError(f"unknown effect: {effect}")
        return y[:, cfg.fft_size : cfg.fft_size + T].cpu().numpy()
