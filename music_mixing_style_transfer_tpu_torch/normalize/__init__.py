from .features import load_fx_features, smooth_features
from .imager import lr_to_ms, ms_to_lr, normalize_imager, process_balance
from .matching import hfc_onset_mask, mean_peak_db, measure_mean_peak
from .normalizer import AudioEffectsNormalizer

__all__ = [
    "AudioEffectsNormalizer",
    "load_fx_features",
    "smooth_features",
    "normalize_imager",
    "process_balance",
    "lr_to_ms",
    "ms_to_lr",
    "hfc_onset_mask",
    "mean_peak_db",
    "measure_mean_peak",
]
