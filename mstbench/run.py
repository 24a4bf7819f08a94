"""Run one cell of the benchmark once, on the machine it starts on.

    python3 -m mstbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the JSON
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared with the plain reference beside its limit); the same checks are
the last lines of standard error. Exits non-zero, printing no result, when
the cell's CUDA devices are missing or the port cannot be imported.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every compiler cache inside the checkout, at fixed paths, so that
    only a checkout's first run builds (the port's own kernels build into
    its package's ``_build/``)."""
    base = os.path.join(ROOT, ".mstbench", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    _caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from mstbench import harness

    return harness.main(args, _T0)


if __name__ == "__main__":
    sys.exit(main())
