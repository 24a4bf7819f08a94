"""Device milliseconds inside the ``mst.encoder`` span (the FXencoder on the
separated reference stems), per minute of input song sent, in ``serve_mixes``:
as ``encoder_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("encoder_ms_per_min")
