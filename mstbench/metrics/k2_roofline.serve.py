"""K2's share of its roofline (``program.k2_roofline``), from the
program's ``ops.cuda.envelope`` records and ``envelope_scan_kernel``'s
time in the window."""
from mstbench.metrics.program import k2_roofline as read  # noqa: F401
