"""K2's share of its roofline, from the program's ``ops.cuda.envelope`` records
and ``envelope_scan_kernel``'s time, in ``serve_mixes``: as
``k2_roofline.serve``."""
from mstbench.metrics.separation import serve_reader

read = serve_reader("k2_roofline")
