"""Milliseconds inside the program's span ``normalize.batch`` in which the
device ran nothing, per minute of input song sent, in ``serve_mixes``: as
``normalize_idle_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("normalize_idle_ms_per_min")
