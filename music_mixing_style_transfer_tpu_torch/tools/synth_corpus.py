"""Procedural multitrack song generator (a training corpus without MUSDB18).

The port's copy of ``music_mixing_style_transfer_tpu/tools/synth_corpus.py``:
the same numpy code, so for the same seed it writes the same WAV bytes. The
reference trains on MUSDB18 (86 train songs, README.md:83-90), which is not
in the repository. This tool synthesizes aligned 4-stem songs: drums
(kick/snare/hat patterns), bass (scale note lines), other (chord pads and
arpeggios), vocals (vibrato formant phrases), in the MUSDB layout
``<out>/<split>/<song>/{drums,bass,other,vocals}.wav``, so
``tools/prepare_musdb.py`` and the training datasets run end to end on a
multi-song corpus. The FX style is applied at train time; these stems give
musically structured content with a distinct spectral and transient
character per instrument.

    python -m music_mixing_style_transfer_tpu_torch.tools.synth_corpus \
        --output_dir <dir>/corpus_raw --n_songs 12 --seconds 30
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.wavio import write_wav
from ..utils.logging import get_logger

log = get_logger("synth_corpus")

SR = 44100
# natural-minor scale intervals (semitones from root)
SCALE = np.array([0, 2, 3, 5, 7, 8, 10])


def _note_hz(root_hz: float, degree: int) -> float:
    octave, step = divmod(int(degree), len(SCALE))
    return root_hz * 2.0 ** (octave + SCALE[step] / 12.0)


def _env(n: int, attack: float, decay: float) -> np.ndarray:
    """Attack/decay envelope, ``attack``/``decay`` in seconds."""
    t = np.arange(n) / SR
    a = np.minimum(t / max(attack, 1e-4), 1.0)
    return (a * np.exp(-np.maximum(t - attack, 0.0) / max(decay, 1e-3))).astype(
        np.float32
    )


def _place(track: np.ndarray, start: int, burst: np.ndarray, pan: float) -> None:
    """Add a mono burst into stereo ``track [2, T]`` with constant-power pan."""
    end = min(start + burst.shape[0], track.shape[1])
    if end <= start:
        return
    seg = burst[: end - start]
    track[0, start:end] += seg * np.cos(pan * np.pi / 2).astype(np.float32)
    track[1, start:end] += seg * np.sin(pan * np.pi / 2).astype(np.float32)


def synth_drums(rng: np.random.Generator, n: int, beat: int) -> np.ndarray:
    out = np.zeros((2, n), np.float32)
    kick_len = int(0.12 * SR)
    t = np.arange(kick_len) / SR
    # pitch-sweep sine kick 120 -> 45 Hz
    kick = np.sin(2 * np.pi * (45 + 75 * np.exp(-t * 30)) * t) * _env(
        kick_len, 0.002, 0.05
    )
    snare_len = int(0.15 * SR)
    hat_len = int(0.05 * SR)
    pattern = rng.integers(0, 2, size=16).astype(bool)
    pattern[0] = True
    for bar_start in range(0, n, 4 * beat):
        for step in range(16):
            pos = bar_start + step * beat // 4
            if pos >= n:
                break
            if step % 4 == 0 and pattern[step]:  # kick on (some) quarter notes
                _place(out, pos, 0.8 * kick, 0.5)
            if step % 8 == 4:  # snare backbeat
                noise = rng.standard_normal(snare_len).astype(np.float32)
                body = np.sin(2 * np.pi * 180 * np.arange(snare_len) / SR)
                _place(
                    out, pos,
                    0.45 * (0.6 * noise + 0.4 * body) * _env(snare_len, 0.001, 0.04),
                    0.5,
                )
            if step % 2 == 0:  # hats on eighths, alternating pan
                noise = rng.standard_normal(hat_len).astype(np.float32)
                noise -= np.concatenate([[0.0], noise[:-1]]) * 0.95  # HF tilt
                _place(
                    out, pos,
                    0.18 * noise * _env(hat_len, 0.0005, 0.012),
                    0.3 if (step // 2) % 2 else 0.7,
                )
    return out


def synth_bass(rng: np.random.Generator, n: int, beat: int, root: float) -> np.ndarray:
    out = np.zeros((2, n), np.float32)
    degrees = rng.integers(-3, 5, size=64)
    note_len = beat
    t = np.arange(note_len) / SR
    for i, pos in enumerate(range(0, n, note_len)):
        hz = _note_hz(root / 2, int(degrees[i % len(degrees)]))
        # saw-ish: first 5 harmonics at 1/k
        wave = sum(np.sin(2 * np.pi * hz * k * t) / k for k in range(1, 6))
        burst = (0.35 * wave * _env(note_len, 0.01, 0.4)).astype(np.float32)
        _place(out, pos, burst, 0.5)
    return out


def synth_other(rng: np.random.Generator, n: int, beat: int, root: float) -> np.ndarray:
    out = np.zeros((2, n), np.float32)
    chord_len = 4 * beat
    t = np.arange(chord_len) / SR
    prog = rng.integers(0, 7, size=16)
    for i, pos in enumerate(range(0, n, chord_len)):
        base = int(prog[i % len(prog)])
        pad = np.zeros(chord_len, np.float32)
        for j, step in enumerate((0, 2, 4)):  # triad
            hz = _note_hz(root, base + step)
            detune = 1.0 + rng.normal(0, 0.001)
            pad += np.sin(2 * np.pi * hz * detune * t + rng.uniform(0, 2 * np.pi))
            _place(
                out, pos + j * beat // 2,  # arpeggiated attack
                (0.10 * np.sin(2 * np.pi * hz * 2 * t[: beat * 2])
                 * _env(beat * 2, 0.005, 0.2)).astype(np.float32),
                rng.uniform(0.2, 0.8),
            )
        _place(out, pos, (0.12 * pad * _env(chord_len, 0.3, 3.0)), 0.5)
    return out


def synth_vocals(rng: np.random.Generator, n: int, beat: int, root: float) -> np.ndarray:
    out = np.zeros((2, n), np.float32)
    phrase_len = 2 * beat
    t = np.arange(phrase_len) / SR
    formants = [(1.0, 1.0), (2.4, 0.5), (3.1, 0.3)]  # vowel-ish partials
    for pos in range(0, n, 4 * beat):
        if rng.random() < 0.25:  # rests between phrases
            continue
        hz = _note_hz(root * 2, int(rng.integers(0, 7)))
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.5 * t)
        phase = np.cumsum(2 * np.pi * hz * vib / SR)
        tone = sum(a * np.sin(phase * m) for m, a in formants)
        _place(
            out, pos,
            (0.28 * tone * _env(phrase_len, 0.08, 0.8)).astype(np.float32),
            rng.uniform(0.35, 0.65),
        )
    return out


def synth_song(seed: int, seconds: float = 30.0) -> dict:
    """One aligned 4-stem song, peak-normalized jointly to 0.7."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    tempo = float(rng.uniform(80, 140))
    beat = int(SR * 60 / tempo)
    root = float(rng.uniform(110.0, 220.0))  # A2..A3
    stems = {
        "drums": synth_drums(rng, n, beat),
        "bass": synth_bass(rng, n, beat, root),
        "other": synth_other(rng, n, beat, root),
        "vocals": synth_vocals(rng, n, beat, root),
    }
    peak = max(np.abs(x).max() for x in stems.values())
    scale = 0.7 / max(peak, 1e-6)
    return {k: v * scale for k, v in stems.items()}


def generate(output_dir: str, n_songs: int, seconds: float, split: str, seed0: int) -> int:
    for i in range(n_songs):
        song_dir = os.path.join(output_dir, split, f"synth{i:03d}")
        os.makedirs(song_dir, exist_ok=True)
        stems = synth_song(seed0 + i, seconds)
        for inst, x in stems.items():
            write_wav(os.path.join(song_dir, f"{inst}.wav"), x.T, SR)
        log.info("[%s] synth%03d (%.0fs)", split, i, seconds)
    return n_songs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--n_songs", type=int, default=12)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    generate(args.output_dir, args.n_songs, args.seconds, args.split, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
