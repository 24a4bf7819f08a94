"""Device milliseconds inside the program's span ``normalize.eq``, per minute
of input song sent, in ``serve_mixes``: as
``normalize_eq_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("normalize_eq_ms_per_min")
