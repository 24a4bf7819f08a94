from .stft import frame, hann_window, istft, magnitude, sqrt_hann_window
from .biquad import (
    rbj_poles,
    biquad_apply,
    biquad_apply_scan,
    biquad_cascade,
    filtfilt_biquad,
    filtfilt_fir,
    fir_filter,
    rbj_coeffs,
)
from .compressor import amp_to_db, compand, compand_transfer_table, compressor_process, static_gain_curve
from .fftconv import fft_convolve_full, convolve_wet
from .loudness import (
    integrated_loudness,
    k_weight,
    loudness_normalize,
    lufs_normalize,
    lufs_normalize_compand,
    peak_normalize,
)
from .resample import (
    phase_vocoder,
    pitch_shift,
    playback_speed,
    sinc_resample,
    time_stretch,
)
