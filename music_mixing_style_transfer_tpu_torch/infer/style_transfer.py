"""Style-transfer CLI of the PyTorch port, flag-compatible with
``music_mixing_style_transfer_tpu/infer/style_transfer.py`` (and so with the
reference ``inference/style_transfer.py:344-397``):

    python -m music_mixing_style_transfer_tpu_torch.infer.style_transfer \
        --target_dir samples/style_transfer/ --do_not_separate true

Runs on the card (``--inference_device cuda``, the default) unless
``--inference_device cpu`` is given. ``--normalize_input true`` (the
default) FX-normalizes the input stems toward the MUSDB18 features of
``--precomputed_normalization_feature`` (by default the port's own copy in
``weights/``) before the transfer. Expects pre-separated stems with
``--do_not_separate true``. Otherwise (the default) it reads the mixtures
``<song>/<input|reference>.wav``: ``--separation_model htdemucs`` separates
them in-process on the inference device (``models/htdemucs.py``, weights
from ``--ckpt_path_sep``, seeded random ones when that file is missing);
any other model shells out to the ``demucs`` CLI on PATH, as the reference
does, and reads the stems it writes.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from ..config import InferenceConfig, NormalizationConfig
from ..infer.pipeline import MixingStyleTransfer, StyleTransferEngine, separate_with_demucs
from ..normalize import AudioEffectsNormalizer
from ..utils.logging import get_logger

log = get_logger("style_transfer")


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default_enc = os.path.join(here, "weights", "FXencoder_ps.pt")
    default_conv = os.path.join(here, "weights", "MixFXcloner_ps.pt")
    default_sep = os.path.join(here, "weights", "htdemucs.pt")
    default_feat = os.path.join(here, "weights", "musdb18_fxfeatures_eqcompimagegain.npy")

    p = argparse.ArgumentParser(description=__doc__)
    d = p.add_argument_group("Directory args")
    d.add_argument("--target_dir", type=str, default="./samples/style_transfer/")
    d.add_argument("--output_dir", type=str, default=None)
    d.add_argument("--input_file_name", type=str, default="input")
    d.add_argument("--reference_file_name", type=str, default="reference")
    d.add_argument("--reference_file_name_2interpolate", type=str, default="reference_B")
    d.add_argument("--ckpt_path_enc", type=str, default=default_enc)
    d.add_argument("--ckpt_path_conv", type=str, default=default_conv)
    d.add_argument("--ckpt_path_sep", type=str, default=default_sep,
                   help="HTDemucs state dict (Demucs's names) for --separation_model htdemucs")
    d.add_argument("--precomputed_normalization_feature", type=str, default=default_feat)

    i = p.add_argument_group("Inference args")
    i.add_argument("--sample_rate", type=int, default=44100)
    i.add_argument("--segment_length", type=int, default=2**19)
    i.add_argument("--segment_length_ref", type=int, default=2**19)
    i.add_argument("--instruments", type=str, nargs="+", default=["drums", "bass", "other", "vocals"])
    i.add_argument("--stem_level_directory_name", type=str, default="separated")
    i.add_argument("--save_each_inst", type=str2bool, default=False)
    i.add_argument("--do_not_separate", type=str2bool, default=False)
    i.add_argument("--separation_model", type=str, default="mdx_extra")
    i.add_argument("--normalize_input", type=str2bool, default=True,
                   help="FX-normalize the input stems before the transfer")
    i.add_argument(
        "--normalization_order", type=str, nargs="+",
        default=["loudness", "eq", "compression", "imager", "loudness"],
    )
    i.add_argument("--interpolation", type=str2bool, default=False)
    i.add_argument("--interpolate_segments", type=int, default=30)
    i.add_argument("--segment_halo", type=int, default=0,
                   help="context samples per segment edge (0 = reference behaviour)")
    i.add_argument("--pcm_fast_path", type=str2bool, default=True,
                   help="device-resident whole-song path (upload int16 PCM "
                        "once, convert/sum on device); false forces the "
                        "per-stage host path")

    dev = p.add_argument_group("Device args")
    dev.add_argument("--workers", type=int, default=1,
                     help="accepted for reference-CLI compatibility (stems load "
                          "on one reader thread)")
    dev.add_argument("--inference_device", type=str, default="cuda",
                     help="torch device for the networks: cuda (default) or cpu")
    dev.add_argument("--batch_size", type=int, default=1)
    dev.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    dev.add_argument("--separation_device", type=str, default="cpu")
    return p


def save_run_config(args, output_dir: str) -> None:
    """Record the full argument namespace (reference ``save_args``,
    ``style_transfer.py:304-321``)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "style_transfer_inference_configurations.txt")
    with open(path, "w") as f:
        f.write("[args]\n")
        for k, v in sorted(vars(args).items()):
            f.write(f"  - {k:28s}: {v}\n")


def config_from_args(args) -> InferenceConfig:
    return InferenceConfig(
        sample_rate=args.sample_rate,
        segment_length=args.segment_length,
        segment_length_ref=args.segment_length_ref,
        batch_size=args.batch_size,
        instruments=tuple(args.instruments),
        stem_level_directory_name=args.stem_level_directory_name,
        separation_model=args.separation_model,
        save_each_inst=args.save_each_inst,
        do_not_separate=args.do_not_separate,
        normalize_input=args.normalize_input,
        interpolation=args.interpolation,
        interpolate_segments=args.interpolate_segments,
        input_file_name=args.input_file_name,
        reference_file_name=args.reference_file_name,
        reference_file_name_2interpolate=args.reference_file_name_2interpolate,
        dtype=args.dtype,
        segment_halo=args.segment_halo,
        pcm_fast_path=args.pcm_fast_path,
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    engine = StyleTransferEngine(
        ckpt_path_enc=args.ckpt_path_enc,
        ckpt_path_conv=args.ckpt_path_conv,
        dtype=args.dtype,
        device=args.inference_device,
    )

    output_dir = args.output_dir or args.target_dir
    save_run_config(args, output_dir)

    separator = None
    if not args.do_not_separate and args.separation_model == "htdemucs":
        from ..models.htdemucs import HTDemucsSeparator

        separator = HTDemucsSeparator(ckpt=args.ckpt_path_sep, device=engine.device)
    elif not args.do_not_separate:
        names = [args.input_file_name, args.reference_file_name]
        if args.interpolation:
            names.append(args.reference_file_name_2interpolate)
        for song_dir in sorted(glob.glob(os.path.join(args.target_dir, "*/"))):
            for name in names:
                target = os.path.join(
                    song_dir, args.stem_level_directory_name, args.separation_model,
                    name, "drums.wav",
                )
                if os.path.exists(target):
                    log.info("already separated: %s", name)
                    continue
                separate_with_demucs(
                    os.path.join(song_dir, name + ".wav"),
                    os.path.join(song_dir, args.stem_level_directory_name),
                    model=args.separation_model,
                    device=args.separation_device,
                )

    normalizer = None
    if args.normalize_input:
        normalizer = AudioEffectsNormalizer(
            args.precomputed_normalization_feature,
            NormalizationConfig(
                effects=tuple(args.normalization_order), stems=tuple(args.instruments)
            ),
            device=args.inference_device,
        )

    pipeline = MixingStyleTransfer(engine, cfg, normalizer=normalizer, separator=separator)
    written = pipeline.run_directory(args.target_dir, args.output_dir)
    log.info("wrote %d mixtures", len(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
