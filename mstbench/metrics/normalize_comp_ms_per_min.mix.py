"""Device milliseconds inside the program's span ``normalize.compression``, per
minute of input song sent, in ``serve_mixes``: as
``normalize_comp_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("normalize_comp_ms_per_min")
