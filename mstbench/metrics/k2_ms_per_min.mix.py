"""Device milliseconds of K2 (``envelope_scan_kernel``, the normalizer's
compressor envelope) per minute of input song sent, in ``serve_mixes``: as
``k2_ms_per_min.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("k2_ms_per_min")
