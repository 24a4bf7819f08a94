"""Cells driven end to end on the CPU at tiny sizes: a cell made of new
files alone is found and run, every driver's run is correct, and nothing
the benchmark runs loads JAX or the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from mstbench.tests import tiny

NEW_METRIC = '''"""Songs attempted in the window (a test's reader)."""


def read(ctx):
    return len(ctx.counters.get("attempts", [])) or None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


def test_a_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer metric,
    each a new file, make a cell that the harness finds by name and runs,
    traced."""
    config = tiny._tiny_config("mst_serve_bf16")
    traffic = {"driver": "songs", "lengths_s": [0.5, 0.8], "min_passes": 2, "orders": [[1, 0]],
               "checked_songs": 1, "checked_segments": 2}
    root = tiny.checkout(tmp_path, extra_cells=[("new_cell", config, traffic, "serve_songs")])
    with open(os.path.join(root, "mstbench", "metrics", "songs_sent.new_cell.py"), "w") as f:
        f.write(NEW_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "songs_sent.new_cell", "unit": "songs", "better": "higher",
                               "source": "program_counter", "layer": "infer.pipeline",
                               "moves": "song_audio_s_per_s", "workloads": ["new_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code = ("import json, time, torch\nfrom mstbench import harness\n"
            "bench = harness.load_json('BENCHMARK.json')\n"
            "run = harness.Run(bench, 'new_cell', 99, 0.2, True, torch.device('cpu'), time.perf_counter())\n"
            "print(json.dumps(harness.execute(run)))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=root), timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["songs_sent.new_cell"]["value"] >= 4  # two passes of two songs
    assert list(res)[-1] == "checks"


def test_songs_through_the_normalizer(tmp_path):
    """The serving path with FX normalization, checked against the
    reference's normalizer (its compression choices and output)."""
    config = tiny._tiny_config("mst_serve_bf16", normalize=True)
    traffic = {"driver": "songs", "lengths_s": [0.6, 0.9], "min_passes": 2, "orders": [[0, 1]],
               "checked_songs": 2, "checked_segments": 2}
    root = tiny.checkout(tmp_path, extra_cells=[("normalized", config, traffic, "serve_songs")])
    res = tiny.drive(root, "normalized")
    assert res["correct"], res["checks"]
    assert res["checks"]["choices"]["value"] == 0 and res["checks"]["norm_nrmse"]["value"] < 1e-4


@pytest.mark.parametrize("cell,metric", [("tiny_songs", "song_audio_s_per_s"),
                                         ("tiny_train", "converter_step_s")])
def test_each_driver_runs_correct(root, cell, metric):
    res = tiny.drive(root, cell)
    assert res["correct"], res["checks"]
    assert res["metrics"][metric]["value"] > 0 and "setup_s" in res["metrics"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["jax"] == []


def test_nothing_the_benchmark_runs_imports_jax():
    """Every module of the benchmark and every port module its drivers
    import, in a fresh process: no top-level ``jax``, ``jaxlib``, ``flax`` or
    ``music_mixing_style_transfer_tpu`` (compared whole: the port's name
    begins with the JAX package's)."""
    code = (
        "import importlib, pkgutil, sys, mstbench\n"
        "from mstbench import harness\n"
        "for m in pkgutil.walk_packages(mstbench.__path__, 'mstbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "import glob, os\n"
        "for d in ('drivers', 'metrics'):\n"
        "    for f in glob.glob(os.path.join(harness.HERE, d, '*.py')): harness.load_module(f)\n"
        "import music_mixing_style_transfer_tpu_torch.infer.pipeline, "
        "music_mixing_style_transfer_tpu_torch.normalize, "
        "music_mixing_style_transfer_tpu_torch.train.fused, "
        "music_mixing_style_transfer_tpu_torch.fx.factory\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=tiny.ROOT), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "music_mixing_style_transfer_tpu_torch" in top and "mstbench" in top
    assert not top & {"jax", "jaxlib", "flax", "music_mixing_style_transfer_tpu"}
