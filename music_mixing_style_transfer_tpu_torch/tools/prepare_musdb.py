"""Prepare a MUSDB-style corpus for training.

The port's counterpart of ``music_mixing_style_transfer_tpu/tools/prepare_musdb.py``.
It writes the file layout the training datasets read
(``data/datasets.py:_MUSDBFiles``):

    <out>/<split>/<inst>_normalized_<order>_silence_trimmed<i>.wav
    <out>/<split>/<inst>_silence_trimmed<i>.wav        (--no_normalize)

from a decoded MUSDB directory ``<root>/<split>/<song>/{drums,bass,other,
vocals}.wav``. Per song, the stems are FX-normalized toward the precomputed
average features by the batched normalizer the inference pipeline uses
(``normalize/batch.py``; on the card, its compression matching through K2),
then silence-trimmed (an RMS gate) and written as 16-bit PCM. Without
normalization the output equals the JAX package's byte for byte.

    python -m music_mixing_style_transfer_tpu_torch.tools.prepare_musdb \
        --musdb_root <decoded musdb> --output_dir <prepared> [--device cpu]

Each song's log record carries its seconds and the K2 launches it made
(``extra={"song_stats": {...}}``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from ..config import NormalizationConfig
from ..data.prep import trim_silence
from ..data.wavio import read_wav, write_wav
from ..ops.cuda.envelope import compressor_envelope
from ..utils.logging import get_logger

log = get_logger("prepare_musdb")

INSTRUMENTS = ("drums", "bass", "other", "vocals")
DEFAULT_FEATURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "musdb18_fxfeatures_eqcompimagegain.npy",
)


def prepare_song(
    song_dir: str,
    out_dir: str,
    index: int,
    normalizer=None,
    order: str = "eqcompimagegain",
    instruments: Sequence[str] = INSTRUMENTS,
    silence_db: float = -60.0,
    sample_rate: int = 44100,
) -> int:
    """Normalize and silence-trim one song's stems; returns the samples
    written (0 when a stem is missing)."""
    stems = {}
    for inst in instruments:
        path = os.path.join(song_dir, f"{inst}.wav")
        if not os.path.exists(path):
            log.warning("missing stem %s: skipping song %s", path, song_dir)
            return 0
        audio, _ = read_wav(path, expected_rate=sample_rate)
        x = audio.T[:2] if audio.shape[1] >= 2 else np.repeat(audio.T, 2, 0)
        stems[inst] = np.asarray(x, np.float32)

    if normalizer is not None:
        stems = normalizer.normalize_stems(stems)
        suffix = f"normalized_{order}_silence_trimmed"
    else:
        suffix = "silence_trimmed"

    written = 0
    for inst in instruments:
        trimmed = trim_silence(np.clip(stems[inst], -1, 1), threshold_db=silence_db)
        if trimmed.shape[-1] == 0:
            log.warning("%s of %s is fully silent: skipped", inst, song_dir)
            continue
        write_wav(os.path.join(out_dir, f"{inst}_{suffix}{index}.wav"), trimmed.T, sample_rate)
        written += trimmed.shape[-1]
    return written


def prepare_corpus(
    musdb_root: str,
    output_dir: str,
    splits: Sequence[str] = ("train", "test"),
    normalize: bool = True,
    feature_path: Optional[str] = None,
    order: str = "eqcompimagegain",
    instruments: Sequence[str] = INSTRUMENTS,
    silence_db: float = -60.0,
    sample_rate: int = 44100,
    device="cuda",
) -> int:
    """Prepare every song of ``splits``; returns the songs written. The
    normalizer runs on ``device`` (the card unless the caller asks for the
    CPU)."""
    normalizer = None
    if normalize:
        from ..normalize import AudioEffectsNormalizer

        normalizer = AudioEffectsNormalizer(
            feature_path or DEFAULT_FEATURES, NormalizationConfig(stems=tuple(instruments)),
            device=device,
        )

    n_songs = 0
    for split in splits:
        split_dir = os.path.join(musdb_root, split)
        if not os.path.isdir(split_dir):
            log.warning("split %s not found under %s", split, musdb_root)
            continue
        out_dir = os.path.join(output_dir, split)
        os.makedirs(out_dir, exist_ok=True)
        songs = sorted(d for d in os.listdir(split_dir) if os.path.isdir(os.path.join(split_dir, d)))
        for i, song in enumerate(songs):
            t0, launches0 = time.perf_counter(), compressor_envelope.launches
            n = prepare_song(os.path.join(split_dir, song), out_dir, i, normalizer, order,
                             instruments, silence_db, sample_rate)
            if n:
                n_songs += 1
                stats = {"split": split, "song": song, "samples": n,
                         "seconds": time.perf_counter() - t0,
                         "launches": compressor_envelope.launches - launches0}
                log.info("[%s] %s -> %d samples/stem, %.2f s, %d K2 launches", split, song, n,
                         stats["seconds"], stats["launches"], extra={"song_stats": stats})
    return n_songs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--musdb_root", type=str, required=True,
                   help="decoded MUSDB: <root>/<split>/<song>/<inst>.wav")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--splits", type=str, nargs="+", default=["train", "test"])
    p.add_argument("--normalize", dest="normalize", action="store_true", default=True)
    p.add_argument("--no_normalize", dest="normalize", action="store_false")
    p.add_argument("--precomputed_normalization_feature", type=str, default=None,
                   help="default: the port's weights/musdb18_fxfeatures_eqcompimagegain.npy")
    p.add_argument("--normalization_order", type=str, default="eqcompimagegain")
    p.add_argument("--instruments", type=str, nargs="+", default=list(INSTRUMENTS))
    p.add_argument("--silence_db", type=float, default=-60.0)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the normalizer runs (cuda, or cpu)")
    args = p.parse_args(argv)
    n = prepare_corpus(
        args.musdb_root, args.output_dir, args.splits, args.normalize,
        args.precomputed_normalization_feature, args.normalization_order,
        args.instruments, args.silence_db, args.sample_rate, args.device,
    )
    log.info("prepared %d songs", n)
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
