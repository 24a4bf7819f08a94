"""Tiny cells for the CPU tests: a checkout in a temporary directory with
a copy of the benchmark, small configurations and short traffic, driven
through the harness on the CPU in a subprocess (the card check skipped),
optionally with a fault planted in the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
PORT = "music_mixing_style_transfer_tpu_torch"
TINY_ENCODER = {"channels": [8, 16], "kernels": [25, 15], "strides": [4, 4], "dilation": [1, 1]}


def _tiny_config(name, normalize=False):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    c["encoder"].update(TINY_ENCODER)
    if "inference" in c:
        c["converter"].update(condition_dimension=16, nblocks=4)
        c["inference"].update(segment_length=2**13, segment_length_ref=2**13,
                              normalize_input=normalize)
    else:
        c["converter"].update(condition_dimension=16, nblocks=3, channel_width=16, kernel_size=7)
        c["train"].update(segment_length=8192, batch_size_per_device=2)
    return c


# limits at the tiny sizes (the cells' own are set from full-size readings)
TINY_LIMITS = {
    "songs": {"choices": 0, "norm_nrmse": 1e-4, "emb_err": 2e-2, "mix_err": 3.0, "unchecked": 0},
    "train": {"loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 5e-2},
}
TINY_TRAFFIC = {
    "songs": {"driver": "songs", "lengths_s": [0.4, 0.6, 0.9], "min_passes": 2,
              "orders": [[2, 0, 1], [1, 2, 0]], "checked_songs": 2, "checked_segments": 2},
    "train": {"driver": "train", "bank_songs": 2, "bank_seconds": 2.0, "checked_steps": 3},
}


def checkout(tmp, extra_cells=()) -> str:
    """A checkout under ``tmp``: the benchmark's files and ``BENCHMARK.json``,
    the port linked in, and tiny cells ``tiny_<driver>`` (``extra_cells``:
    ``(cell, config, traffic)`` entries whose files the caller adds)."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(HERE, os.path.join(root, "mstbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, PORT), os.path.join(root, PORT))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for driver, base, cell_of in (("songs", "mst_serve_bf16", "serve_songs"),
                                  ("train", "mst_train_f32", "train_converter")):
        add(root, bench, f"tiny_{driver}", _tiny_config(base), TINY_TRAFFIC[driver], cell_of,
            TINY_LIMITS[driver])
    for cell in extra_cells:
        add(root, bench, *cell)
    return root


def add(root, bench, cell, config, traffic, like, limits=None):
    """Cell ``cell`` from new files alone: its configuration, traffic and
    limits (``like``'s unless given), reporting what cell ``like``
    reports."""
    d = os.path.join(root, "mstbench")
    driver = traffic["driver"]
    for sub, obj in (("configs", config), ("traffic", traffic),
                     ("limits", limits or TINY_LIMITS[driver])):
        with open(os.path.join(d, sub, f"{cell}.json"), "w") as f:
            json.dump(obj, f)
    bench["configs"].append({"name": cell, "source": "test", "file": f"mstbench/configs/{cell}.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": cell, "config": cell, "traffic": cell, "chips": 1,
                               "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def drive(root, cell, fault=None, control=None, seed=2**35 + 11, timeout=900,
          device="cpu") -> dict:
    """One run of ``cell`` (on the CPU unless ``device`` says otherwise):
    the result line's object."""
    code = (
        "import json, sys, time, torch\n"
        "from mstbench.tests import faults\n"
        f"faults.plant({fault!r})\n"
        "from mstbench import harness\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        f"run = harness.Run(bench, {cell!r}, {seed}, 0.5, False, torch.device({device!r}),"
        f" time.perf_counter(), control={control!r})\n"
        "res = harness.execute(run)\n"
        "res['jax'] = harness.jax_modules()\n"
        "print(json.dumps(res))\n"
    )
    env = dict(os.environ, PYTHONPATH=root)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(p.stderr[-4000:])
    return json.loads(p.stdout.strip().splitlines()[-1])
