"""Precomputed FX-feature loading (MUSDB18 averages).

The port's own copy of ``music_mixing_style_transfer_tpu/normalize/features.py``
(numpy and scipy only). Loads the reference's feature file
(``weights/musdb18_fxfeatures_eqcompimagegain.npy``, of which the port keeps
its own copy: per-stem average EQ magnitude spectrum [32769], compression
[peak_dB, std], imager mid/side balance scalar, loudness LUFS) and applies
the same Savitzky-Golay smoothing to the EQ curves (reference
``data_normalization.py:158-172``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import scipy.signal


def load_fx_features(
    path: str,
    stems: Sequence[str] = ("drums", "bass", "other", "vocals"),
    effects: Sequence[str] = ("eq", "compression", "imager", "loudness"),
) -> Dict[str, Dict[str, np.ndarray]]:
    raw = np.load(path, allow_pickle=True)[()]
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for effect in raw:
        out[effect] = {}
        for stem in raw[effect]:
            out[effect][stem] = np.asarray(raw[effect][stem])
    return smooth_features(out, stems=stems, effects=effects)


def smooth_features(
    features: Dict[str, Dict[str, np.ndarray]],
    stems: Sequence[str] = ("drums", "bass", "other", "vocals"),
    effects: Sequence[str] = ("eq", "compression", "imager", "loudness"),
) -> Dict[str, Dict[str, np.ndarray]]:
    """Savitzky-Golay smooth the eq (and panning) target curves.

    Window 401 for other/vocals, 151 for drums/bass; order 1; mirror mode
    (reference ``data_normalization.py:158-172``).
    """
    for effect in effects:
        if effect not in features:
            continue
        for stem in stems:
            if stem not in features[effect]:
                continue
            if effect == "eq":
                f = 401 if stem in ("other", "vocals") else 151
                features[effect][stem] = scipy.signal.savgol_filter(
                    features[effect][stem], f, 1, mode="mirror"
                )
            elif effect == "panning":
                features[effect][stem] = scipy.signal.savgol_filter(
                    features[effect][stem], 501, 1, mode="mirror"
                )
    return features
