from .nt_xent import nt_xent_loss

__all__ = ["nt_xent_loss"]
