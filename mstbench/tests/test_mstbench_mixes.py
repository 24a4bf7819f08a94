"""The ``serve_mixes`` cell (driver ``mixes``) on the CPU at tiny sizes: the
harness runs it from its new files, ``correct`` holds for the program and
comes out false for each fault planted in the separator and for the bf16
separation control. The TF32 control exists only on a card."""
import json
import os
import subprocess
import sys

import pytest

from mstbench.tests import tiny

SEPARATOR = dict(nfft=2048, channels=8, bottom_channels=16, t_heads=2, segment=0.5, batch=2)
TRAFFIC = {"driver": "mixes", "lengths_s": [0.5, 0.8, 1.1], "min_passes": 2,
           "orders": [[2, 0, 1], [1, 2, 0]], "checked_songs": 2, "checked_segments": 2}
LIMITS = dict(tiny.TINY_LIMITS["songs"], sep_err=2e-5)  # serve_mixes's own
METRICS = ("separate_ms_per_min.mix", "separate_transformer_ms_per_min.mix",
           "separate_unet_ms_per_min.mix", "transformer_roofline.mix", "mfu.mix",
           "device_idle.mix", "oom_share.mix", "converter_pad_share.mix",
           "normalize_ms_per_min.mix", "encoder_ms_per_min.mix", "converter_ms_per_min.mix",
           "k1_roofline.mix", "k2_ms_per_min.mix", "k2_roofline.mix",
           "normalize_comp_ms_per_min.mix", "normalize_eq_ms_per_min.mix",
           "normalize_idle_ms_per_min.mix", "converter_plain_ms_per_min.mix")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the tiny cell ``tiny_mixes``: the new configuration
    at tiny sizes, reporting what ``serve_mixes`` reports."""
    root = tiny.checkout(tmp_path_factory.mktemp("bench"))
    with open(os.path.join(tiny.HERE, "configs", "mst_serve_htdemucs_bf16.json")) as f:
        config = json.load(f)
    small = tiny._tiny_config("mst_serve_bf16")
    for k in ("encoder", "converter"):
        config[k] = small[k]
    config["inference"].update(segment_length=2**13, segment_length_ref=2**13,
                               normalize_input=False)
    config["separator"].update(SEPARATOR)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    tiny.add(root, bench, "tiny_mixes", config, TRAFFIC, "serve_mixes", LIMITS)
    return root


def drive(root, fault=None, control=None, seed=2**35 + 17, device="cpu") -> dict:
    code = (
        "import json, time, torch\n"
        "from mstbench.tests import faults_htdemucs\n"
        f"faults_htdemucs.plant({fault!r})\n"
        "from mstbench import harness\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        f"run = harness.Run(bench, 'tiny_mixes', {seed}, 0.5, False, torch.device({device!r}),"
        f" time.perf_counter(), control={control!r})\n"
        "res = harness.execute(run)\n"
        "res['jax'] = harness.jax_modules()\n"
        "print(json.dumps(res))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=root), timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_mixes_cell_runs_correct(root):
    res = drive(root)
    assert res["correct"], res["checks"]
    assert res["checks"]["sep_err"]["value"] < 1e-6
    assert res["metrics"]["song_audio_s_per_s"]["value"] > 0 and "setup_s" in res["metrics"]
    assert res["attempted"] == 6 and res["failed"] == 0 and res["jax"] == []


def test_a_traced_run_reads_what_it_can_on_the_cpu(root):
    """The harness finds the cell's readers (the separator's and those of the
    stages it shares with ``serve_songs``); on the CPU the trace has no
    device operation, so those of the device give nothing, and the run
    still ends correct."""
    code = ("import json, time, torch\nfrom mstbench import harness\n"
            "bench = harness.load_json('BENCHMARK.json')\n"
            "run = harness.Run(bench, 'tiny_mixes', 5, 0.5, True, torch.device('cpu'), time.perf_counter())\n"
            "print(json.dumps(harness.execute(run)))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=root), timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) <= set(METRICS)


@pytest.mark.parametrize("fault", ["cross_layers_skipped", "time_branch_dropped",
                                   "frequency_embedding_dropped", "outputs_in_bf16"])
def test_a_broken_separator_is_not_correct(root, fault):
    res = drive(root, fault=fault)
    assert not res["correct"]
    c = res["checks"]["sep_err"]
    assert c["value"] > c["limit"], res["checks"]


def test_the_bf16_separation_control_is_not_correct(root):
    res = drive(root, control="sep_bf16")
    c = res["checks"]["sep_err"]
    assert not res["correct"] and c["value"] > c["limit"], res["checks"]


@pytest.mark.cuda
def test_the_tf32_separation_control_is_not_correct_on_the_card(root, cuda_device):
    res = drive(root, control="sep_tf32", device="cuda")
    c = res["checks"]["sep_err"]
    assert not res["correct"] and c["value"] > c["limit"], res["checks"]


def test_the_separators_yardstick():
    """``counts_htdemucs`` at the configuration's sizes: the transformer's
    tokens agree with the program's counter, and a chunk's operations agree
    with torch's own count (``FlopCounterMode``: convolutions, linears and
    attention's products) of the program's forward on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from music_mixing_style_transfer_tpu_torch.models.htdemucs import (
        HTDemucs,
        HTDemucsConfig,
        tokens,
    )

    from mstbench.metrics import counts_htdemucs as counts

    with open(os.path.join(tiny.HERE, "configs", "mst_serve_htdemucs_bf16.json")) as f:
        cfg = json.load(f)["separator"]
    sep_cfg = HTDemucsConfig(**dict(cfg, sources=tuple(cfg["sources"])))
    assert counts.tokens(cfg) == tokens(sep_cfg) == (2688, 1344)
    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        HTDemucs(sep_cfg)(torch.empty(1, 2, sep_cfg.segment_length))
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    nf, nt = tokens(sep_cfg)
    samplers = 2 * 2 * (nf + nt) * 384 * 512
    assert by_op["aten.convolution"] == counts.unet_flops_per_chunk(cfg) + samplers
    assert fc.get_total_flops() == counts.flops_per_chunk(cfg)
    assert counts.unet_flops_per_chunk(cfg) == 113_884_018_560
    assert counts.transformer_flops_per_chunk(cfg) == 215_092_297_728
    assert counts.transformer_bound_s(cfg, 16, 2688, 1344) == pytest.approx(
        16 * 215_092_297_728 / 67e12)
