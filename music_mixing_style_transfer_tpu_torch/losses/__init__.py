from .nt_xent import nt_xent_loss
from .spectral import (
    frontend_mag,
    multiscale_spectral_midside,
    multiscale_spectral_stereo,
    rms_loss,
)

__all__ = [
    "nt_xent_loss",
    "frontend_mag",
    "multiscale_spectral_midside",
    "multiscale_spectral_stereo",
    "rms_loss",
]
