"""The port's DSP ops. As in the JAX package's ``ops/__init__``, minus the
``stft`` function: here ``ops.stft`` stays the module (import the function
from ``ops.stft``).
"""
from .stft import (
    compute_istft,
    compute_stft,
    frame,
    hann_window,
    hamming_window,
    istft,
    magnitude,
    overlap,
    slicing,
    sqrt_hann_window,
)
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
from .shapes import (
    is_complete_convolution,
    pad_to_length,
    td_length_from_fd,
    valid_length,
)
