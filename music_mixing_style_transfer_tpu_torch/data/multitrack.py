"""Aligned multitrack mixing datasets, in numpy.

The port's copy of ``music_mixing_style_transfer_tpu/data/multitrack.py``:
the same numpy code, so for the same seed and augmenter its batches equal
the JAX package's byte for byte.

Re-design of the reference's mixing-task data layer
(``mixing_manipulator/common_dataprocessing.py:205-534``):

- :func:`scan_mixing_dataset` — mirrors ``create_dataset_mixing`` (:205-315):
  one entry per song directory holding time-ALIGNED stems, with source
  mapping, mono->stereo repeat, sampling-rate validation, wrap padding, and
  empty-directory pruning.
- :meth:`MixingDataset.sample_aligned` — mirrors ``generate_data`` (:318-389):
  the SAME random chunk is cut from every stem of a song (zero-centre-padding
  short stems to the longest), with wraparound at the song end.
- :func:`mixing_minibatch` — mirrors ``create_minibatch_mixing`` (:465-534):
  batches of aligned (stems, mixes), FX augmentation applied to *input*
  sources only, with edge padding trimmed after the augmenter.
- :func:`mixture_minibatch` — mirrors ``create_minibatch`` (:392-463):
  summed-mixture batches with per-source presence/overlap probabilities and
  joint mixture peak normalization.

Differences from the reference (deliberate): audio is channel-first
``[C, T]`` float32 (the layout used everywhere in this package, converted
once at load), randomness flows through an explicit
``np.random.Generator``, and augmenters are plain ``[C, T] -> [C, T]``
callables.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .wavio import read_wav

Augmenter = Callable[[np.ndarray], np.ndarray]


@dataclass
class _Stem:
    """One aligned stem of a song (lazily loadable)."""

    path: Optional[str]
    data: Optional[np.ndarray] = None  # [C, T] float32

    def load(self) -> np.ndarray:
        if self.data is None:
            audio, _ = read_wav(self.path, expected_rate=None)
            self.data = np.ascontiguousarray(audio.T, dtype=np.float32)
        return self.data


@dataclass
class MixingDataset:
    """Aligned multitrack corpus: ``songs[i][source] -> stem``."""

    songs: List[Dict[str, _Stem]] = field(default_factory=list)
    directories: List[str] = field(default_factory=list)
    material_seconds: Dict[str, float] = field(default_factory=dict)
    sample_rate: int = 44100

    def __len__(self) -> int:
        return len(self.songs)

    def sample_aligned(
        self,
        idx: int,
        n_samples: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        sources: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Cut the SAME random window from every stem of song ``idx``
        (reference ``generate_data``: shared ``idx_start``, zero-centre pad
        for short stems, wraparound past the end)."""
        song = self.songs[idx]
        names = list(sources) if sources is not None else list(song)
        stems = {s: song[s].load() for s in names}
        if n_samples is None:
            return {s: x.copy() for s, x in stems.items()}

        rng = rng or np.random.default_rng()
        max_len = max([n_samples] + [x.shape[1] for x in stems.values()])
        out: Dict[str, np.ndarray] = {}
        padded = {}
        for s, x in stems.items():
            if x.shape[1] < max_len:
                half = (max_len - x.shape[1]) // 2 + 1
                z = np.zeros((x.shape[0], half), np.float32)
                x = np.concatenate([z, x, z], axis=1)
            padded[s] = x
        start = int(rng.integers(0, max_len))
        for s, x in padded.items():
            if start + n_samples < x.shape[1]:
                out[s] = x[:, start : start + n_samples].copy()
            else:
                head = x[:, start:]
                out[s] = np.concatenate(
                    [head, x[:, : n_samples - head.shape[1]]], axis=1
                )
        return out


def scan_mixing_dataset(
    path: str,
    sources: Sequence[str],
    mapped_sources: Optional[Mapping[str, str]] = None,
    accepted_sampling_rates: Sequence[int] = (44100,),
    n_channels: int = 2,
    pad_wrap_samples: Optional[int] = None,
    max_songs: Optional[int] = None,
) -> MixingDataset:
    """Scan ``path`` (one sub-directory per song, one wav per source) into a
    :class:`MixingDataset` (reference ``create_dataset_mixing`` semantics).

    Unknown sources are skipped; ``mapped_sources`` renames on load; mono
    stems are repeated to ``n_channels``; a wrong sampling rate raises; songs
    with no recognized source are dropped. Stems are held in memory (the
    reference's ``load_to_memory=False`` mmap mode buys nothing here: rate
    and channel validation already force a full read, and the aligned-window
    sampler consumes stems whole-song).
    """
    mapped_sources = dict(mapped_sources or {})
    directories = sorted(
        d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
    )
    if max_songs is not None:
        directories = directories[:max_songs]

    ds = MixingDataset(sample_rate=int(accepted_sampling_rates[0]))
    for d in directories:
        entry: Dict[str, _Stem] = {}
        for f in sorted(os.listdir(os.path.join(path, d))):
            if not f.lower().endswith(".wav"):
                continue
            src = os.path.splitext(f)[0]
            if src not in sources and src not in mapped_sources:
                continue
            src = mapped_sources.get(src, src)
            fp = os.path.join(path, d, f)
            audio, rate = read_wav(fp, expected_rate=None)
            if rate not in accepted_sampling_rates:
                raise ValueError(
                    f"{fp}: fs={rate}Hz, expected one of {accepted_sampling_rates}"
                )
            x = np.ascontiguousarray(audio.T, dtype=np.float32)
            if x.shape[0] != n_channels:
                if x.shape[0] == 1:
                    x = np.repeat(x, n_channels, axis=0)
                else:
                    raise ValueError(
                        f"{fp}: {x.shape[0]} channels, expected {n_channels}"
                    )
            if pad_wrap_samples:
                x = np.concatenate([x[:, -pad_wrap_samples:], x], axis=1)
            if src in entry:  # same source twice -> append in time
                x = np.concatenate([entry[src].data, x], axis=1)
            entry[src] = _Stem(path=fp, data=x)
            ds.material_seconds[src] = ds.material_seconds.get(src, 0.0) + (
                x.shape[1] / rate
            )
        if entry:
            ds.songs.append(entry)
            ds.directories.append(d)
    return ds


def _trim(x: np.ndarray, pad: Tuple[int, int]) -> np.ndarray:
    lo = pad[0] or None
    hi = -pad[1] if pad[1] else None
    return x[:, lo:hi]


def mixing_minibatch(
    dataset: MixingDataset,
    inputs: Sequence[str],
    outputs: Sequence[str],
    batch_size: int,
    n_samples: int,
    augmenter: Optional[Augmenter] = None,
    augmenter_sources: Sequence[str] = (),
    augmenter_padding: Tuple[int, int] = (0, 0),
    idx_songs: Optional[Sequence[int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Aligned (stems, mix) minibatch (reference ``create_minibatch_mixing``).

    Per batch item one song is sampled; all its stems share the same random
    window (extended by ``augmenter_padding`` samples each side); sources in
    ``augmenter_sources`` are FX-augmented and the padding trimmed after —
    output sources pass through untouched (the supervised mixing target).

    Returns ``({input: [B, C, T]}, {output: [B, C, T]})``.
    """
    rng = rng or np.random.default_rng()
    stems = {s: np.zeros((batch_size, 2, n_samples), np.float32) for s in inputs}
    mixes = {s: np.zeros((batch_size, 2, n_samples), np.float32) for s in outputs}
    n_load = n_samples + sum(augmenter_padding)

    for j in range(batch_size):
        idx = (
            int(idx_songs[j])
            if idx_songs is not None
            else int(rng.integers(0, len(dataset)))
        )
        win = dataset.sample_aligned(idx, n_load, rng=rng)
        for src, x in win.items():
            if src in augmenter_sources and augmenter is not None:
                x = _trim(augmenter(x), augmenter_padding)
            else:
                x = _trim(x, augmenter_padding)
            if src in stems:
                stems[src][j] = x
            if src in mixes:
                mixes[src][j] = x
    return stems, mixes


def mixture_minibatch(
    dataset: MixingDataset,
    sources: Sequence[str],
    batch_size: int,
    n_samples: int,
    present_prob: Optional[Mapping[str, float]] = None,
    overlap_prob: Optional[Mapping[str, float]] = None,
    augmenter: Optional[Augmenter] = None,
    augmenter_padding: Tuple[int, int] = (0, 0),
    idx_songs: Optional[Mapping[str, Sequence[int]]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Summed-mixture minibatch with per-source targets (reference
    ``create_minibatch``): each source draws its own song, may be absent
    (``present_prob``), may be overlapped with the same source from another
    song (``overlap_prob``); the mixture is peak-normalized jointly with the
    targets.

    Returns ``(mixture [B, C, T], {source: [B, C, T]})``.
    """
    rng = rng or np.random.default_rng()
    present_prob = dict(present_prob or {})
    overlap_prob = dict(overlap_prob or {})
    inp = np.zeros((batch_size, 2, n_samples), np.float32)
    tar = {s: np.zeros((batch_size, 2, n_samples), np.float32) for s in sources}
    n_load = n_samples + sum(augmenter_padding)

    def augm(idx: int, src: str) -> np.ndarray:
        x = dataset.sample_aligned(idx, n_load, rng=rng, sources=[src])[src]
        if augmenter is not None:
            x = augmenter(x)
        return _trim(x, augmenter_padding)

    for src in sources:
        for j in range(batch_size):
            idx = (
                int(idx_songs[src][j])
                if idx_songs is not None
                else int(rng.integers(0, len(dataset)))
            )
            present = src not in present_prob or rng.random() < present_prob[src]
            overlap = src in overlap_prob and rng.random() < overlap_prob[src]
            if src in dataset.songs[idx] and present:
                tar[src][j] = augm(idx, src)
                if overlap:
                    idx2 = int(rng.integers(0, len(dataset)))
                    if idx2 != idx and src in dataset.songs[idx2]:
                        tar[src][j] += augm(idx2, src)
        inp += tar[src]

    # joint peak normalization, mixture-referenced (reference :459-462)
    maxabs = np.maximum(1.0, 1e-6 + np.max(np.abs(inp), axis=(1, 2), keepdims=True))
    inp /= maxabs
    for src in sources:
        tar[src] /= maxabs
    return inp, tar
