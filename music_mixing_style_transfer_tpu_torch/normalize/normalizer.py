"""Audio-effects-chain normalizer: the inference-side FX normalization, in
PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/normalize/normalizer.py``
(reference ``mixing_manipulator/data_normalization.py:19-172``): input stems
are normalized, in order, for loudness / EQ / compression / stereo image
toward precomputed MUSDB18 average features, so the converter sees a
"style-less" input. The port runs the batched path
(:mod:`.batch`); the per-channel path is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NormalizationConfig
from ..utils.device import resolve_device
from .features import load_fx_features

PER_CHANNEL_NOT_PORTED = (
    "the per-channel normalizer path (normalize_audio, normalize_audio_per_effect: "
    "eq_match, comp_match, panning_match) is not yet ported to the PyTorch "
    "package (ROADMAP); use normalize_stems, the batched path"
)


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

    def normalize_audio(self, audio: np.ndarray, src: str) -> np.ndarray:
        raise NotImplementedError(PER_CHANNEL_NOT_PORTED)

    def normalize_audio_per_effect(self, audio: np.ndarray, src: str, effect: str) -> np.ndarray:
        raise NotImplementedError(PER_CHANNEL_NOT_PORTED)
