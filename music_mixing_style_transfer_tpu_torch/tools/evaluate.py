"""Objective style-transfer evaluation CLI of the PyTorch port (counterpart
of ``music_mixing_style_transfer_tpu/tools/evaluate.py``, same CLI and
JSON report).

The reference ships its paper-evaluation metric *functions*
(``mixing_manipulator/utils_data_normalization.py:483-905``,
``fx_utils.py:276-313``) but no command-line tool; this CLI closes that loop: it
compares converted outputs against their style references with the full
metric set — loudness (LUFS/peak MAPE), spectral (centroid/bandwidth/
contrast/rolloff/flatness MAPE), panning (per-band RMS MAPE), dynamics
(RMS/spread/crest MAPE) and MFCC distances — and emits one JSON report.

Usage:
    # one pair
    python -m music_mixing_style_transfer_tpu_torch.tools.evaluate \
        --out_file converted.wav --ref_file reference.wav

    # a style-transfer output tree: <target_dir>/<song>/mixture_output.wav
    # scored against <target_dir>/<song>/reference.wav
    python -m music_mixing_style_transfer_tpu_torch.tools.evaluate \
        --target_dir results/ --json scores.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from ..data.wavio import read_wav
from ..metrics import (
    compute_dynamic_features,
    compute_loudness_features,
    compute_panning_features,
    compute_spectral_features,
    mfcc_distances,
)


def evaluate_pair(
    out_path: str, ref_path: str, sr: int = 44100, max_seconds: Optional[float] = None
) -> Dict[str, float]:
    """All objective metrics for one (output, reference) WAV pair.

    Audio is trimmed to the shorter of the two (the reference evaluation
    compares equal-length renders). Returns a flat {metric: value} dict —
    lower is better for every entry.
    """
    out, _ = read_wav(out_path, expected_rate=sr)
    ref, _ = read_wav(ref_path, expected_rate=sr)
    T = min(len(out), len(ref))
    if max_seconds is not None:
        T = min(T, int(max_seconds * sr))
    out, ref = out[:T], ref[:T]
    if out.shape[1] == 1:
        out = np.repeat(out, 2, axis=1)
    if ref.shape[1] == 1:
        ref = np.repeat(ref, 2, axis=1)

    scores: Dict[str, float] = {}
    for fn in (
        compute_loudness_features,
        compute_spectral_features,
        compute_panning_features,
        compute_dynamic_features,
    ):
        for k, v in fn(out, ref, sr).items():
            val = float(np.mean(v))
            # undefined features (e.g. panning of a dead-center signal, where
            # every frame gates out) become None rather than NaN-poisoning
            # the report
            scores[k] = val if np.isfinite(val) else None
    mono_out, mono_ref = out.mean(axis=1), ref.mean(axis=1)
    for k, v in mfcc_distances(mono_ref, mono_out, sr).items():
        scores[f"mfcc_{k}"] = float(v) if np.isfinite(v) else None
    return scores


def evaluate_directory(
    target_dir: str,
    output_name: str = "mixture_output.wav",
    reference_name: str = "reference.wav",
    sr: int = 44100,
    max_seconds: Optional[float] = None,
) -> Dict[str, Dict[str, float]]:
    """Score every song dir under ``target_dir`` that has both files.

    Returns {song: {metric: value}} plus a "mean" row averaging songs.
    """
    report: Dict[str, Dict[str, float]] = {}
    for out_path in sorted(
        glob.glob(os.path.join(target_dir, "**", output_name), recursive=True)
    ):
        song_dir = os.path.dirname(out_path)
        ref_path = os.path.join(song_dir, reference_name)
        if not os.path.exists(ref_path):
            continue
        name = os.path.relpath(song_dir, target_dir)
        report[name] = evaluate_pair(out_path, ref_path, sr, max_seconds)
    if report:
        keys = next(iter(report.values())).keys()
        mean_row = {}
        for k in keys:
            vals = [r[k] for r in report.values() if r.get(k) is not None]
            mean_row[k] = float(np.mean(vals)) if vals else None
        report["mean"] = mean_row
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_file", type=str, default=None)
    p.add_argument("--ref_file", type=str, default=None)
    p.add_argument("--target_dir", type=str, default=None)
    p.add_argument("--output_name", type=str, default="mixture_output.wav")
    p.add_argument("--reference_name", type=str, default="reference.wav")
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--max_seconds", type=float, default=None,
                   help="evaluate only the first N seconds")
    p.add_argument("--json", type=str, default=None, help="write report here")
    args = p.parse_args(argv)

    if args.out_file and args.ref_file:
        report = {
            "pair": evaluate_pair(
                args.out_file, args.ref_file, args.sample_rate, args.max_seconds
            )
        }
    elif args.target_dir:
        report = evaluate_directory(
            args.target_dir, args.output_name, args.reference_name,
            args.sample_rate, args.max_seconds,
        )
        if not report:
            print(
                f"no ({args.output_name}, {args.reference_name}) pairs under "
                f"{args.target_dir}", file=sys.stderr,
            )
            return 1
    else:
        p.error("pass --out_file + --ref_file, or --target_dir")

    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
