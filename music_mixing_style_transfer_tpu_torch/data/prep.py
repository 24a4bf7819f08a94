"""Dataset preparation: directory loading, IR banks, fades, trims and
silence trimming, in numpy.

The port's copy of ``music_mixing_style_transfer_tpu/data/prep.py`` (the
reference's data-prep surface, ``mixing_manipulator/common_dataprocessing.py:110-315``,
and the IR loading in ``audio_effects_chain.py:66-86``); the same numpy code,
so its arrays equal the JAX package's byte for byte. Impulse responses pack
into one padded array ``[n, 2, max_len]`` with RT60 bucket offsets, so the
two-level random choice (bucket, then IR) is two integer draws.
"""
from __future__ import annotations

import glob as globlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .wavio import read_wav


def load_wav_dir(path: str, expected_rate: Optional[int] = 44100) -> Dict[str, np.ndarray]:
    """Load every .wav under ``path`` into memory: name -> [T, C] float32
    (reference ``create_dataset`` with load_to_memory=True)."""
    out = {}
    for p in sorted(globlib.glob(os.path.join(path, "**", "*.wav"), recursive=True)):
        audio, _ = read_wav(p, expected_rate=expected_rate)
        out[os.path.relpath(p, path)] = audio
    return out


def load_ir_bank(
    ir_dir_path: str,
    sample_rate: int = 44100,
    long_rt60_ms: int = 3000,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load an RT60-organized IR directory into a padded bank.

    Directory layout (reference ``audio_effects_chain.py:66-86``):
    ``<ir_dir>/*/RT60_avg/<rt60-range>/*.wav`` — IRs are grouped per RT60
    range; ranges under ``long_rt60_ms`` each form a bucket, longer ones are
    merged into one final bucket.

    Returns ``(bank [n, 2, max_len] float32 zero-padded,
    bucket_bounds [n_buckets+1] int32 offsets into the bank)``.
    """
    rt_dirs = sorted(globlib.glob(os.path.join(ir_dir_path, "*", "RT60_avg", "[!0-]*")))
    groups: Dict[str, List[np.ndarray]] = {}
    for d in rt_dirs:
        rt = os.path.basename(d)
        irs = groups.setdefault(rt, [])
        for p in sorted(globlib.glob(os.path.join(d, "*.wav"))):
            audio, _ = read_wav(p, expected_rate=sample_rate)
            ir = audio.T  # [C, L]
            if ir.shape[0] == 1:
                ir = np.repeat(ir, 2, axis=0)
            irs.append(ir[:2].astype(np.float32))

    buckets: List[List[np.ndarray]] = []
    long_bucket: List[np.ndarray] = []
    for rt, irs in sorted(groups.items()):
        try:
            rt_len = int(rt.split("-")[0])
        except ValueError:
            rt_len = long_rt60_ms
        if rt_len < long_rt60_ms:
            buckets.append(irs)
        else:
            long_bucket.extend(irs)
    if long_bucket:
        buckets.append(long_bucket)
    if not buckets:
        raise FileNotFoundError(f"no IRs found under {ir_dir_path}")

    flat = [ir for b in buckets for ir in b]
    L = max_len or max(ir.shape[1] for ir in flat)
    bank = np.zeros((len(flat), 2, L), np.float32)
    for i, ir in enumerate(flat):
        bank[i, :, : min(ir.shape[1], L)] = ir[:, :L]
    bounds = np.cumsum([0] + [len(b) for b in buckets]).astype(np.int32)
    return bank, bounds


def fade_in(x: np.ndarray, length: int = 128) -> np.ndarray:
    """Half-hann fade-in on the last axis (reference ``fx_utils.fadeIn``)."""
    w = np.hanning(2 * length)[:length]
    env = np.concatenate([w, np.ones(x.shape[-1] - length)])
    return x * env


def fade_out(x: np.ndarray, length: int = 128) -> np.ndarray:
    """Half-hann fade-out on the last axis (reference ``fx_utils.fadeOut``)."""
    w = np.hanning(2 * length)[length:]
    env = np.concatenate([np.ones(x.shape[-1] - length), w])
    return x * env


def random_trim(
    x: np.ndarray, length: int, rng: Optional[np.random.Generator] = None,
    start: Optional[int] = None,
) -> np.ndarray:
    """Random fixed-length crop with wraparound for short inputs
    (reference ``fx_utils.getRandomTrim``). Operates on the last axis."""
    rng = rng or np.random.default_rng()
    T = x.shape[-1]
    while T <= length:
        x = np.concatenate([x, x], axis=-1)
        T = x.shape[-1]
    if start is None:
        start = int(rng.integers(0, T - length))
    end = start + length
    if end > T:
        return np.concatenate([x[..., start:], x[..., : end - T]], axis=-1)
    return x[..., start:end]


def trim_silence(
    audio: np.ndarray, threshold_db: float = -60.0, frame: int = 4096
) -> np.ndarray:
    """Remove frames whose RMS is below threshold (dataset prep used to
    produce the ``*_silence_trimmed`` training files)."""
    C, T = audio.shape
    n = T // frame
    frames = audio[:, : n * frame].reshape(C, n, frame)
    rms_db = 20 * np.log10(np.sqrt(np.mean(frames**2, axis=(0, 2))) + 1e-12)
    keep = rms_db > threshold_db
    if not keep.any():
        return audio[:, :0]
    return frames[:, keep].reshape(C, -1)
