from .processors import HAAS_PARAMS_44K, Haas, rms_normalize

__all__ = ["Haas", "HAAS_PARAMS_44K", "rms_normalize"]
