"""Training-step throughput of the PyTorch port: the two training steps at
the reference shapes, as one JSON line.

Counterpart of ``music_mixing_style_transfer_tpu/tools/train_bench.py``,
with the same JSON keys plus ``device`` (SURVEY.md §3.4/§3.5; the
reference never shipped a trainer, so these are the numbers its training
loop would be bounded by):

- **contrastive** (FXencoder, NT-Xent): per-instrument A/B views
  ``[n_inst, B, 2, T]``, ``B = batch * (1 + strong negatives)``,
  ``T = length`` (2^17 at 44.1 kHz, ~3 s);
- **converter** (MixFXcloner against a frozen FXencoder): (A1, A2, B2)
  triplets ``[2 * batch, 2, T]``.

Steps/s and training audio-seconds/s (every waveform sample a step
consumes). Timing: one step to warm up, then ``--steps`` steps with one
wait for the card at the end. Inputs are seeded noise; the train steps
are the trainers' own (``train/contrastive.py``, ``train/converter.py``:
TF32 off, bf16 by autocast).

``--trace DIR`` profiles one more step of each (``utils/profiling.py``:
``DIR/<step>/trace.json``) and adds its 12 largest operations by self
time on the device (on the CPU: host time) to the line.

Run: ``python -m music_mixing_style_transfer_tpu_torch.tools.train_bench
[--steps 10] [--dtype float32|bfloat16] [--batch 4] [--length 131072]
[--remat] [--tiny] [--device cpu] [--trace DIR]`` (the card unless
``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import sync, trace

SR = 44100
TOP_OPS = 12  # operations listed from each profile


def _model_cfgs(args):
    """The published configs, or small ones under ``--tiny`` (the full
    encoder's backward is impractical on a CPU)."""
    from ..config import FXencoderConfig, TCNConfig

    if not args.tiny:
        return FXencoderConfig(), TCNConfig()
    enc = FXencoderConfig(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
    tcn = TCNConfig(condition_dimension=enc.embed_dim, nblocks=2, channel_width=8, kernel_size=7)
    return enc, tcn


def _time_steps(name: str, step, state, args, *batch) -> dict:
    """``<name>_step_s``: seconds per step over ``args.steps`` steps after
    one warm-up step (the loss must be finite); with ``args.trace``, one
    more step profiled, its top operations under ``<name>_top_ops``."""
    state, loss = step(state, *batch)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss {float(loss)}")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, *batch)
    sync(loss)
    out = {f"{name}_step_s": (time.perf_counter() - t0) / args.steps}
    if args.trace:
        with trace(os.path.join(args.trace, name)) as prof:
            sync(step(state, *batch)[1])
        attr = "self_device_time_total" if loss.is_cuda else "self_cpu_time_total"
        ops = sorted(prof.key_averages(), key=lambda e: getattr(e, attr), reverse=True)[:TOP_OPS]
        out[f"{name}_top_ops"] = [
            {"op": e.key, "ms": round(getattr(e, attr) / 1e3, 3), "calls": e.count} for e in ops
        ]
    return out


def _noise(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(dev)


def bench_contrastive(args, dev) -> dict:
    from ..config import TrainConfig
    from ..train import init_contrastive, make_contrastive_train_step

    tcfg = TrainConfig(batch_size_per_device=args.batch, compute_dtype=args.dtype, remat=args.remat)
    B, T, n_inst = args.batch * (1 + tcfg.num_strong_negatives), args.length, 4
    _, state, _ = init_contrastive(_model_cfgs(args)[0], tcfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    a, b = _noise(rng, (n_inst, B, 2, T), dev), _noise(rng, (n_inst, B, 2, T), dev)
    out = _time_steps("contrastive", make_contrastive_train_step(tcfg.temperature, args.dtype),
                      state, args, a, b)
    dt = out["contrastive_step_s"]
    return {
        **out,
        "contrastive_step_s": round(dt, 4),
        "contrastive_steps_per_s": round(1.0 / dt, 2),
        "contrastive_audio_s_per_s": round(n_inst * B * 2 * T / SR / dt, 1),
    }


def bench_converter(args, dev) -> dict:
    from ..config import TrainConfig
    from ..models import FXencoder
    from ..models.fast_init import fast_init
    from ..train import init_converter, make_converter_train_step
    from ..train.converter import frozen

    tcfg = TrainConfig(batch_size_per_device=args.batch, compute_dtype=args.dtype, remat=args.remat)
    B, T = args.batch * 2, args.length
    enc_cfg, tcn_cfg = _model_cfgs(args)
    encoder = frozen(fast_init(FXencoder(enc_cfg), seed=1).to(dev))
    _, state, _ = init_converter(tcn_cfg, tcfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    a1, a2, b2 = (_noise(rng, (B, 2, T), dev) for _ in range(3))
    step = make_converter_train_step(compute_dtype=args.dtype)
    out = _time_steps("converter", step, state, args, encoder, a1, a2, b2)
    dt = out["converter_step_s"]
    return {
        **out,
        "converter_step_s": round(dt, 4),
        "converter_steps_per_s": round(1.0 / dt, 2),
        "converter_audio_s_per_s": round(3 * B * T / SR / dt, 1),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4, help="batch_size_per_device")
    p.add_argument("--length", type=int, default=2**17, help="segment length (samples)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--skip_contrastive", action="store_true")
    p.add_argument("--skip_converter", action="store_true")
    p.add_argument("--remat", action="store_true", help="recompute blocks in the backward pass")
    p.add_argument("--tiny", action="store_true", help="small model configs (CPU smoke runs)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--trace", type=str, default=None,
                   help="directory for a profile of one more step of each")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": args.dtype, "batch": args.batch, "length": args.length,
    }
    if not args.skip_contrastive:
        out.update(bench_contrastive(args, dev))
    if not args.skip_converter:
        out.update(bench_converter(args, dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
