"""K1's share of its roofline: the least time of every launch the converter's
block hooks saw, over ``tcn_block_kernel``'s device time, in ``serve_mixes``:
as ``k1_roofline.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("k1_roofline")
