"""Device milliseconds inside the ``mst.converter`` span (the MixFXcloner), per
minute of input song sent, in ``serve_mixes``: as
``converter_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("converter_ms_per_min")
