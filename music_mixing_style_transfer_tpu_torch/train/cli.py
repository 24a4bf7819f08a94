"""Training CLI of the PyTorch port, flag-compatible with
``music_mixing_style_transfer_tpu/train/cli.py``:

    python -m music_mixing_style_transfer_tpu_torch.train.cli fxencoder \
        --data_dir /data/musdb_normalized --out_dir runs/enc --epochs 100 --fused
    python -m music_mixing_style_transfer_tpu_torch.train.cli converter \
        --data_dir /data/musdb_normalized --out_dir runs/conv --fused \
        --encoder_ckpt runs/enc/ckpt/step_00000100.pt

Trains on the card (``--device cuda``, the default) unless ``--device cpu``
is given. On N cards, one process a card under ``torchrun``:

    torchrun --nproc_per_node N -m music_mixing_style_transfer_tpu_torch.train.cli \
        fxencoder --data_dir ... --out_dir ... --fused

Each rank reads and trains on its block of every batch (``--batch_items``
is the global batch; N must divide it and, for the encoder, ``batch_items
* (num_strong_negatives + 1)``), gradients averaged over the ranks; rank 0
writes the metrics, logs and checkpoints (``train/loop.py``). The group is
NCCL on cards and gloo on the CPU (``--dist_backend`` overrides it: gloo
lets several ranks share one card, which NCCL refuses); ``--device cuda``
is ``cuda:LOCAL_RANK``, and an explicit ``--device cuda:K`` wins over it.

``--data_dir`` holds ``train/`` (and ``val/`` or ``test/``) with the MUSDB
layout's ``{inst}_normalized_eqcompimagegain_silence_trimmed*.wav``.
The converter needs the frozen encoder's checkpoint, ``--encoder_ckpt``: a
published ``FXencoder_ps.pt`` or a ``step_<n>.pt`` that the ``fxencoder``
model wrote under ``<out_dir>/ckpt/``; the converter's own go under
``<out_dir>/ckpt_conv/``.

Differences from the JAX CLI: ``--device`` and ``--dist_backend``;
``--encoder_config`` and ``--converter_config``, JSON objects of
``FXencoderConfig`` and ``TCNConfig`` fields (the defaults are the
published architectures; smaller ones serve tests and cut-depth runs; the
converter's ``condition_dimension`` must be the encoder's embedding
width); an orbax ``--encoder_ckpt`` directory raises (ROADMAP: "Orbax
checkpoints"). ``--no_mesh`` keeps the JAX meaning (no mesh: one device):
a one-process run trains on one device whatever it is given, and under
``torchrun`` with more than one rank it raises rather than train N
independent models. ``--retries`` is accepted and changes nothing: the JAX
CLI re-executes on a TPU runtime's transient failures (a dropped compile
service, a preemption), and a CUDA launch failure is no such thing (it
leaves the process's context unusable and repeats on a rerun); resume from
the checkpoints with a second run instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch.distributed as dist

from ..config import FXencoderConfig, TCNConfig, TrainConfig
from ..parallel.mesh import init_process_group_from_env
from .loop import train_converter, train_fxencoder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=["fxencoder", "converter"])
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=40)
    p.add_argument("--batch_items", type=int, default=4)
    p.add_argument("--segment_length", type=int, default=2**17)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "warmup_cosine", "step"],
                   help="LR schedule, a function of the optimizer step: a resumed run "
                        "continues mid-schedule")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_decay_steps", type=int, default=10_000,
                   help="(warmup_cosine) total decay horizon in steps")
    p.add_argument("--lr_end_factor", type=float, default=0.0,
                   help="(warmup_cosine) final LR as a fraction of peak")
    p.add_argument("--lr_step_size", type=int, default=1_000, help="(step) steps between decays")
    p.add_argument("--lr_gamma", type=float, default=0.5, help="(step) decay factor")
    p.add_argument("--collate_quantum", type=int, default=None,
                   help="(fxencoder) random-duration collate bucket size "
                        "(default max(4096, segment_length // 8))")
    p.add_argument("--num_strong_negatives", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_mesh", action="store_true",
                   help="train on one device: raises under torchrun with more than one rank")
    p.add_argument("--fused", action="store_true",
                   help="walk all instruments' FX chains as one batched pass (fx/fastpath.py); "
                        "without it, one chain per instrument. Both on the device, same numbers")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype (parameters, optimizer and losses stay float32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the trained model's blocks in the backward pass "
                        "(torch.utils.checkpoint): one block's activations at a time")
    p.add_argument("--encoder_ckpt", type=str, default=None,
                   help="(converter) the frozen encoder's torch .pt: a published one, or "
                        "<out_dir>/ckpt/step_<n>.pt of the fxencoder model")
    p.add_argument("--prob_schedule", type=str, default=None,
                   help="(fxencoder) target probs, e.g. 'eq=0.5,comp=0.5'")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs; the final epoch always saves")
    p.add_argument("--val_every", type=int, default=1,
                   help="held-out val loss every N epochs (0 disables); deterministic seeds + "
                        "end-of-schedule probs, logged as val_loss in metrics.jsonl")
    p.add_argument("--val_items", type=int, default=2, help="items per held-out validation batch")
    p.add_argument("--ori_weight", type=float, default=0.0,
                   help="(converter) weight of the per-channel L/R spectral term")
    p.add_argument("--retries", type=int, default=0,
                   help="accepted for the JAX CLI's sake; no effect (see the module docstring)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: cuda (under torchrun cuda:LOCAL_RANK), cuda:K, or cpu "
                        "(tests)")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="torchrun's process group: nccl on cards, gloo on the CPU by default; "
                        "gloo lets ranks share one card")
    p.add_argument("--encoder_config", type=str, default=None,
                   help="JSON object of FXencoderConfig fields, e.g. "
                        "'{\"channels\": [8, 16], \"kernels\": [25, 15], \"strides\": [4, 4], "
                        "\"dilation\": [1, 1]}'")
    p.add_argument("--converter_config", type=str, default=None,
                   help="(converter) JSON object of TCNConfig fields, e.g. "
                        "'{\"condition_dimension\": 16, \"nblocks\": 2, \"channel_width\": 8, "
                        "\"kernel_size\": 7}'")
    return p


def _config(cls, text: str):
    """A ``cls`` dataclass from a JSON object of its fields (lists become
    tuples), or the default."""
    if not text:
        return cls()
    fields = json.loads(text)
    return dataclasses.replace(
        cls(), **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    )


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    # fail fast: a missing corpus must not cost a full-size model build
    if not os.path.isdir(args.data_dir):
        p.error(f"--data_dir {args.data_dir}: not a directory")
    if args.model == "converter" and args.encoder_ckpt is None:
        p.error("converter training requires --encoder_ckpt")
    if not (args.device in ("cuda", "cpu") or args.device.startswith("cuda:")):
        p.error(f"--device {args.device}: cuda, cuda:K or cpu")
    # no card: raise before reading any checkpoint
    started = not dist.is_initialized()
    device = init_process_group_from_env(args.device, args.dist_backend)
    try:
        return _train(args, device)
    finally:
        if started and dist.is_initialized():  # the group this call started
            dist.destroy_process_group()


def _train(args, device) -> int:
    """Build the configs from ``args`` and run the model's trainer."""
    enc_cfg = _config(FXencoderConfig, args.encoder_config)
    tcfg = TrainConfig(
        segment_length=args.segment_length,
        learning_rate=args.learning_rate,
        lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_decay_steps=args.lr_decay_steps,
        lr_end_factor=args.lr_end_factor,
        lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma,
        num_strong_negatives=args.num_strong_negatives,
        temperature=args.temperature,
        seed=args.seed,
        compute_dtype=args.dtype,
        remat=args.remat,
    )
    common = dict(
        train_cfg=tcfg,
        epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        batch_items=args.batch_items,
        fused=args.fused,
        save_every=args.save_every,
        val_every=args.val_every,
        val_items=args.val_items,
        device=device,
        use_mesh=not args.no_mesh,
    )
    if args.model == "converter":
        from ..models import FXencoder
        from ..models.checkpoints import load_model_state

        encoder = load_model_state(args.encoder_ckpt, FXencoder(enc_cfg))
        train_converter(args.data_dir, args.out_dir, encoder,
                        converter_cfg=_config(TCNConfig, args.converter_config),
                        ori_weight=args.ori_weight, **common)
        return 0
    target = None
    if args.prob_schedule:
        target = {k: float(v) for k, v in (kv.split("=") for kv in args.prob_schedule.split(","))}
    train_fxencoder(args.data_dir, args.out_dir, encoder_cfg=enc_cfg, prob_schedule_target=target,
                    collate_quantum=args.collate_quantum, **common)
    return 0


if __name__ == "__main__":
    sys.exit(main())
