"""The benchmark's general part: finds a cell's configuration, traffic,
driver and metric readers by the names in ``BENCHMARK.json``, times the
window, and prints the result.

A cell is ``workloads[i]`` of ``BENCHMARK.json``. Its configuration is the
JSON file that ``configs[j].file`` names; its traffic is
``mstbench/traffic/<traffic>.json``, whose ``driver`` key names the driver
``mstbench/drivers/<driver>.py``; each per-layer metric is the reader
``mstbench/metrics/<name>.py``. A driver's ``run(ctx)`` does the set-up,
calls :meth:`Run.window` around the measured work, checks the outputs
against the plain reference and returns an :class:`Outcome`. A reader's
``read(ctx)`` returns the metric's value from the traced window, or
``None`` when the cell gave it nothing to read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "mstbench")
JAX_NAMES = ("jax", "jaxlib", "flax", "music_mixing_style_transfer_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """Import the Python file ``path`` (file names may hold dots)."""
    name = name or "mstbench._loaded." + os.path.relpath(path, HERE).replace(os.sep, "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (``tags`` name the use)."""
    h = hashlib.sha256("/".join(str(t) for t in (seed,) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def jax_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


@dataclasses.dataclass
class Check:
    """One number compared against its limit (``value <= limit`` passes)."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]            # end-to-end metrics, by name
    attempted: int
    failed: int
    checks: Dict[str, Check]
    memory_peak_bytes: int


class Run:
    """Everything a driver and a metric reader see of one run."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device, t0: float, control: Optional[str] = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        self.bench = bench
        self.cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(ROOT, configs[self.cell["config"]]["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", self.cell["traffic"] + ".json"))
        # the limits of the numbers compared with the reference, set from
        # the program's and the control's readings (PERF.md)
        self.limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
        self.seed, self.seconds, self.trace_on = int(seed), float(seconds), bool(trace)
        self.device, self.t0 = device, t0
        # "control" or a planted fault: the reference (or a broken step) in
        # the program's place, for the readings the limits are set from
        self.control = control
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.window_peak_bytes = 0
        self.setup_peak_bytes = 0
        self._trace = None          # tracing.Trace of a traced window
        self._trace_reader: Optional[threading.Thread] = None
        self.counters: Dict[str, Any] = {}   # what drivers count for the readers
        self.phases: Dict[str, float] = {}   # set-up's and the trace's parts, in seconds
        self._mark = t0

    def mark(self, phase: str) -> None:
        """Close the part ``phase`` of the run (its seconds since the last
        mark), for the timing line on standard error."""
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._mark
        self._mark = now

    @property
    def trace(self):
        """The traced window's :class:`tracing.Trace`, or ``None``: read on a
        thread while the driver checks its outputs, and waited for here."""
        if self._trace_reader is not None:
            self._trace_reader.join()
            self._trace_reader = None
            if isinstance(self._trace, BaseException):
                raise self._trace
        return self._trace

    def sub_seed(self, *tags) -> int:
        return sub_seed(self.seed, *tags)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends when it opens; the peak memory is
        reset at its start and read at its end; with tracing, the profiler
        records it."""
        import torch

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            self.setup_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t0
        self.mark("warm_up")
        path = os.path.join(ROOT, ".mstbench", "trace_" + self.cell["name"] + ".json")
        prof = None
        if self.trace_on:
            from . import tracing

            prof = tracing.profiled(path, cuda, self.mark)
            prof.__enter__()
            self.mark("trace_start")
        start = time.perf_counter()
        try:
            yield
            if cuda:
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - start
            self.mark("window")
        finally:
            if prof is not None:
                prof.__exit__(*sys.exc_info())
        if cuda:
            self.window_peak_bytes = torch.cuda.max_memory_allocated()
        if prof is not None:
            from . import tracing

            def read():
                try:
                    self._trace = tracing.Trace(path)
                    os.remove(path)
                except BaseException as e:  # raised where the trace is asked for
                    self._trace = e

            self._trace_reader = threading.Thread(target=read, daemon=True)
            self._trace_reader.start()

    def peak_bytes(self) -> int:
        return max(self.setup_peak_bytes, self.window_peak_bytes)


def metric_applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, any cell (a per-layer metric: any cell that reports
    the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moved = metric.get("moves")
    if moved is None:
        return True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return metric_applies(e2e[moved], cell, bench)


def read_metrics(run: Run) -> Dict[str, Dict[str, Any]]:
    """The traced run's per-layer metrics, each from its reader."""
    out = {}
    for m in run.bench["per_layer"]:
        if not metric_applies(m, run.cell, run.bench):
            continue
        value = load_module(os.path.join(HERE, "metrics", m["name"] + ".py")).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(run: Run) -> dict:
    """Drive the cell once and return the result line's object."""
    driver = load_module(os.path.join(HERE, "drivers", run.traffic["driver"] + ".py"))
    outcome: Outcome = driver.run(run)
    run.mark("check")
    if run.trace_on:
        run.trace  # noqa: B018 (waits for the trace's reading)
        run.mark("trace_read")
        metrics = read_metrics(run)
        run.mark("readers")
    else:
        metrics = {}
        for m in run.bench["end_to_end"]:
            if not metric_applies(m, run.cell, run.bench):
                continue
            value = run.setup_s if m["name"] == "setup_s" else outcome.metrics.get(m["name"])
            if value is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    import torch

    dev = run.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(run.cell.get("chips", 1)),
        "memory_peak_bytes": int(outcome.memory_peak_bytes),
    }
    result = {
        "correct": all(c.ok for c in outcome.checks.values()) and bool(outcome.checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": device,
    }
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = {k: {"value": c.value if math.isfinite(c.value) else None, "limit": c.limit}
                        for k, c in outcome.checks.items()}
    return result


def main(args, t0: float) -> int:
    import torch

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.get("chips", 1)):
        print(f"{args.workload} needs {cell.get('chips', 1)} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = Run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t0)
    run.mark("imports")
    torch.zeros(1, device=run.device)  # the CUDA context
    run.mark("cuda_init")
    result = execute(run)
    found = jax_modules()
    if found:
        print(f"JAX modules loaded in the benchmark's process: {found}", file=sys.stderr)
        return 4
    print("timing " + " ".join(f"{k} {v:.2f}" for k, v in run.phases.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        ok = c["value"] is not None and Check(**c).ok
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
