"""Device milliseconds inside the program's span ``models.tcn.plain`` (the
converter's blocks off K1), per minute of input song sent, in ``serve_mixes``:
as ``converter_plain_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("converter_plain_ms_per_min")
