"""The readings that a cell's limits are set from: the numbers compared
with the reference, for several seeds in one process, from the program and
from the control (the reference in a lower precision, or a planted fault,
in the program's place).

    python3 -m mstbench.readings --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control control|<fault>]

Prints one JSON line a seed: ``{"seed", "control", "checks", "correct"}``.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)
    from mstbench.run import _caches

    _caches()
    import torch

    from mstbench import harness

    bench = harness.load_json(harness.ROOT + "/BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter(), control=args.control)
        res = harness.execute(run)
        print(json.dumps({"seed": seed, "control": args.control, "checks": res["checks"],
                          "correct": res["correct"], "metrics": res["metrics"],
                          "failed": res["failed"], "attempted": res["attempted"]}), flush=True)
        del run, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
