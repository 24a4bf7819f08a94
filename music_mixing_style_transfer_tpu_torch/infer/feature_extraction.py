"""FXencoder feature-extraction CLI of the PyTorch port, flag-compatible with
``music_mixing_style_transfer_tpu/infer/feature_extraction.py`` (and so with
the reference ``inference/feature_extraction.py:164-192``):

    python -m music_mixing_style_transfer_tpu_torch.infer.feature_extraction \
        --target_dir samples/ [--inference_device cpu]

Extracts the averaged 2048-D FX embedding of every ``.wav`` under
``--target_dir`` and saves ``<name>_fx_embedding.npy`` beside it (under
``--output_dir`` when given). Runs on the card unless
``--inference_device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..data.wavio import read_wav_stereo_ct, read_wav_stereo_ct_i16
from ..infer.pipeline import StyleTransferEngine
from ..utils.logging import RTFMeter, get_logger

log = get_logger("feature_extraction")


def build_parser() -> argparse.ArgumentParser:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default_enc = os.path.join(here, "weights", "FXencoder_ps.pt")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target_dir", type=str, default="./samples/")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--ckpt_path_enc", type=str, default=default_enc)
    p.add_argument("--segment_length", type=int, default=44100 * 10)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--inference_device", type=str, default="cuda",
                   help="torch device for the FXencoder: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    output_dir = args.output_dir or args.target_dir

    engine = StyleTransferEngine(
        ckpt_path_enc=args.ckpt_path_enc, dtype=args.dtype, device=args.inference_device
    )
    meter = RTFMeter()
    paths = sorted(glob.glob(os.path.join(args.target_dir, "**", "*.wav"), recursive=True))
    for step, path in enumerate(paths):
        log.info("[%d/%d] %s", step + 1, len(paths), path)
        try:
            # 16-bit PCM uploads int16 and is dequantized on the device:
            # half the host-to-device bytes, the same embedding
            audio = read_wav_stereo_ct_i16(path)
        except ValueError:
            audio = read_wav_stereo_ct(path)
        with meter.measure(audio.shape[-1]):
            emb = engine.embed_song(audio, args.segment_length)
        rel = os.path.relpath(path, args.target_dir)
        out_path = os.path.join(output_dir, os.path.splitext(rel)[0] + "_fx_embedding.npy")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        np.save(out_path, emb)
    log.info("done; RTF=%.1fx", meter.rtf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
