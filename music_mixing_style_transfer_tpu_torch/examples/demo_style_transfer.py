"""Self-contained demo: synthesize stems, run the whole style-transfer stack.

The port's twin of the repository's ``examples/demo_style_transfer.py``.
It writes two synthetic songs' stems (input and reference) in the
reference's directory layout, FX-normalizes the input stems toward the
port's MUSDB18 features (``weights/musdb18_fxfeatures_eqcompimagegain.npy``),
transfers the reference's mixing style with randomly initialized models at
the published widths (real checkpoints give musical output), and writes
the converted mixture and each converted stem. It runs on ``--device`` (the
card by default).

    python -m music_mixing_style_transfer_tpu_torch.examples.demo_style_transfer \
        [--out DIR] [--seconds 15] [--dtype bfloat16] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List

import numpy as np

SR = 44100
SEGMENT = 2**17  # the segment length of the repository's root demo
INSTRUMENTS = ("drums", "bass", "other", "vocals")


def synth_stem(rng, seconds: float, kind: str) -> np.ndarray:
    """``[2, T]`` float32 in [-1, 1]: clicks of noise, a bass tone, a vibrato
    voice, or a tone in noise."""
    t = np.arange(int(SR * seconds)) / SR
    if kind == "drums":
        env = (np.sin(2 * np.pi * 2.0 * t) > 0.9).astype(np.float32)
        x = env * rng.standard_normal(len(t)).astype(np.float32) * 0.5
    elif kind == "bass":
        x = 0.3 * np.sin(2 * np.pi * 55 * t) * (1 + 0.3 * np.sin(2 * np.pi * 0.5 * t))
    elif kind == "vocals":
        x = 0.2 * np.sin(2 * np.pi * (440 + 30 * np.sin(2 * np.pi * 3 * t)) * t)
    else:
        x = 0.15 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t))
    stereo = np.stack([x, np.roll(x, 7) * 0.9]).astype(np.float32)
    return np.clip(stereo, -1, 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mst_demo"))
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def run(args) -> List[str]:
    """Synthesize, normalize and transfer; returns the written WAV paths."""
    from ..config import InferenceConfig
    from ..data.wavio import write_wav
    from ..infer.pipeline import MixingStyleTransfer, StyleTransferEngine
    from ..normalize import AudioEffectsNormalizer
    from ..utils.device import resolve_device

    resolve_device(args.device)  # raise before writing anything when there is no card
    song = os.path.join(args.out, "song1")
    for name, seed in (("input", 0), ("reference", 1)):
        r = np.random.default_rng(seed)
        for inst in INSTRUMENTS:
            write_wav(os.path.join(song, "separated", name, inst + ".wav"),
                      synth_stem(r, args.seconds, inst).T, SR)
    print(f"synthesized stems under {song}")

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    feat = os.path.join(here, "weights", "musdb18_fxfeatures_eqcompimagegain.npy")
    cfg = InferenceConfig(
        segment_length=SEGMENT, segment_length_ref=SEGMENT,
        do_not_separate=True, save_each_inst=True, dtype=args.dtype,
    )
    engine = StyleTransferEngine(dtype=args.dtype, device=args.device)
    normalizer = AudioEffectsNormalizer(feat, device=args.device)
    pipeline = MixingStyleTransfer(engine, cfg, normalizer=normalizer)
    written = pipeline.run_directory(os.path.join(args.out, ""))
    print("wrote:", written)
    return written


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
