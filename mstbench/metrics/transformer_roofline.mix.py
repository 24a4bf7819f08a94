"""The separator's transformer against its roofline: the least time of its
dispatches (float32 peak, TF32 off; HBM bytes) over its span's device
time."""
from mstbench.metrics.separation import transformer_roofline as read  # noqa: F401
