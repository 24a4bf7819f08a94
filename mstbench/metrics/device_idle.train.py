"""Share of the traced window in which no operation ran on the device."""
from mstbench.metrics.idle import idle_share as read  # noqa: F401
