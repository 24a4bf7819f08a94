"""Device milliseconds inside the ``mst.normalize`` span (the normalizer on the
separated input stems), per minute of input song sent, in ``serve_mixes``: as
``normalize_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("normalize_ms_per_min")
