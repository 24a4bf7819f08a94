"""PyTorch port: no JAX, and no quiet fall back to the CPU.

Importing every module of the port (and ``chip_smoke.py``) in a fresh
interpreter must leave JAX and the JAX package out of ``sys.modules``; the
entry points' default device is the card and they raise where there is none.
"""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import music_mixing_style_transfer_tpu_torch as port
from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import music_mixing_style_transfer_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "music_mixing_style_transfer_tpu")
)
print(len(mods), bad)
"""


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    n_modules = len(list(pkgutil.walk_packages(port.__path__, port.__name__ + ".")))
    assert out == [str(n_modules), "[]"]
    assert n_modules >= 20


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        StyleTransferEngine()
    from music_mixing_style_transfer_tpu_torch.infer.style_transfer import main

    with pytest.raises(RuntimeError, match="inference_device cpu"):
        main(["--target_dir", "/nonexistent/", "--normalize_input", "false"])
    # the server (its engine), feature extraction and the profiler
    from music_mixing_style_transfer_tpu_torch import serve
    from music_mixing_style_transfer_tpu_torch.infer import feature_extraction
    from music_mixing_style_transfer_tpu_torch.tools import infer_prof

    for entry, argv in ((serve.main, ["--port", "0"]),
                        (feature_extraction.main, ["--target_dir", "/nonexistent/"]),
                        (infer_prof.main, ["--seconds", "0.1"])):
        with pytest.raises(RuntimeError, match="inference_device cpu"):
            entry(argv)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block

    x = torch.zeros(1, 8, 128, device="meta")
    args = [torch.zeros(15, 128, 128), torch.ones(128), torch.zeros(128),
            torch.ones(1, 128), torch.zeros(1, 128), torch.zeros(128)]
    with pytest.raises(ValueError, match="unsupported device"):
        tcn_block(x, *args, d=8)


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.tools import train_bench
    from music_mixing_style_transfer_tpu_torch.train import cli
    from music_mixing_style_transfer_tpu_torch.train.contrastive import init_contrastive
    from music_mixing_style_transfer_tpu_torch.train.converter import init_converter
    from music_mixing_style_transfer_tpu_torch.train.fused import (
        FusedContrastivePipeline,
        FusedConverterPipeline,
    )
    from music_mixing_style_transfer_tpu_torch.train.loop import train_converter, train_fxencoder

    run = ["--data_dir", str(tmp_path), "--out_dir", str(tmp_path)]
    encoder = FXencoder()
    for entry in (lambda: cli.main(["fxencoder", *run]),
                  lambda: cli.main(["converter", *run, "--encoder_ckpt", str(tmp_path / "enc.pt")]),
                  lambda: train_fxencoder(str(tmp_path), str(tmp_path / "run")),
                  lambda: train_converter(str(tmp_path), str(tmp_path / "run"), encoder),
                  lambda: FusedConverterPipeline(encoder), lambda: train_bench.main([]),
                  FusedContrastivePipeline, init_contrastive, init_converter):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            entry()
