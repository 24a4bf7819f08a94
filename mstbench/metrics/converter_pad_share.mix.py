"""Share of the converter's dispatched segments that are bucket padding, over
the requests that completed, in ``serve_mixes``: as
``converter_pad_share.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("converter_pad_share")
