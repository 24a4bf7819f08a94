"""Training data: MUSDB-style FX-manipulated pairs and triplets, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/data/datasets.py``
(reference ``data_loader/data_loader.py``). The host reads raw WAV segments
and draws the plans; every effect runs batched on the card
(``train/fused.py``).

- :class:`ContrastivePairDataset` (reference
  ``MUSDB_Dataset_Mixing_Manipulated_FXencoder`` :115-348): two segments
  (A, B) of different content per instrument; ``num_strong_negatives + 1``
  FX draws applied to the same (A, B) pair give the positives (A_k, B_k)
  and the strong negatives (A_j, B_j, j != k).
- :class:`StyleTransferTripletDataset` (reference
  ``MUSDB_Dataset_Mixing_Manipulated_Style_Transfer`` :356-539): triplets
  (A1 raw input, A2 ground truth, B2 reference), one FX draw per
  (instrument, item) applied to both contents, so A2 and B2 share the style.
- the random-duration crop plan (reference
  ``Collate_Variable_Length_Segments`` :33-102): lengths in [L/2, L)
  bucketed to multiples of a quantum, starts per item.

The host-side numpy draws (file, start, crop plan) are the JAX package's
code, so segments and crop plans equal its own bit for bit. Segments are
read through the native C++ wav bank (``data/native_loader.py``: headers
parsed once, a batch in one call on a thread pool) where the library
builds, else through ``wavio``; both give the same bytes. Torch cannot
reproduce JAX's FX keys: each item's FX plan comes from a
``torch.Generator`` seeded with ``_seed_for(idx, epoch_seed)`` (the seed
JAX's key comes from), so a run repeats from its seed.

A dataset's ``device`` (the card unless the caller asks for the CPU) is
where ``sample_batch`` and ``generate_contents_w_effects`` run the chains;
the raw batches for the fused trainers stay on the host. In ``val`` mode
with a ``val_cache_dir``, the contrastive views of an item are written to
WAV once and read back after (reference :202-220).
"""
from __future__ import annotations

import glob as globlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fx import make_instrument_manipulators
from ..fx.chain import cat_plans, plan_to
from ..fx.fastpath import augment_contrastive_views, augment_triplets
from ..utils.device import resolve_device
from .native_loader import open_wav_bank
from .wavio import read_wav, wav_length, write_wav

PAD_B4_MANIPULATION = 2048  # reference data_loader.py:127


def _bucket_length(n: int, quantum: int = 4096) -> int:
    return max(quantum, (n // quantum) * quantum)


def to_transport(segs: np.ndarray, transport: str = "auto") -> np.ndarray:
    """Quantize float32 segments to int16 for the host->card copy when that
    is lossless (sources read from 16-bit PCM are exactly ``pcm/32768``);
    ``auto`` checks the round trip and keeps float32 otherwise."""
    if transport == "float32":
        return segs
    q = np.clip(np.round(segs * 32768.0), -32768, 32767).astype(np.int16)
    if transport == "int16":
        return q
    if transport != "auto":
        raise ValueError(f"unknown transport {transport!r}")
    exact = np.array_equal(q.astype(np.float32) * (1.0 / 32768.0), segs)
    return q if exact else segs


class _MUSDBFiles:
    """Per-instrument file lists with duration-ratio sampling weights
    (reference ``data_loader.py:135-146``). Segments come from the native
    wav bank (``cpp/mstio.cc``) when ``use_native`` and the library builds,
    else from ``wavio``, with the same bytes either way; ``reader`` says
    which (``"native"`` or ``"wavio"``). The bank checks every file's rate
    against ``sample_rate`` up front, as ``wavio`` does at each read."""

    def __init__(
        self,
        data_dir: str,
        instruments: Sequence[str],
        use_normalized: bool = True,
        normalization_order: str = "eqcompimagegain",
        use_native: bool = True,
        sample_rate: int = 44100,
    ):
        self.paths: Dict[str, List[str]] = {}
        self.weights: Dict[str, np.ndarray] = {}
        self.lengths: Dict[str, List[int]] = {}
        self.banks: Dict[str, object] = {}
        for inst in instruments:
            if use_normalized:
                pattern = f"{data_dir}/{inst}_normalized_{normalization_order}_silence_trimmed*.wav"
            else:
                pattern = f"{data_dir}/{inst}_silence_trimmed*.wav"
            paths = sorted(globlib.glob(pattern))
            if not paths:
                raise FileNotFoundError(f"no files match {pattern}")
            bank = open_wav_bank(paths) if use_native else None
            if bank is not None and sample_rate is not None:
                for p, rate in zip(paths, bank.rates):
                    if rate != sample_rate:
                        raise ValueError(f"{p}: sample rate {rate} != expected {sample_rate}")
            lengths = bank.frames if bank is not None else [wav_length(p) for p in paths]
            self.paths[inst] = paths
            self.lengths[inst] = list(lengths)
            self.weights[inst] = np.asarray(lengths, np.float64) / sum(lengths)
            if bank is not None:
                self.banks[inst] = bank
        self.reader = "native" if len(self.banks) == len(self.paths) else "wavio"

    def sample_segments(
        self, rng: np.random.Generator, inst: str, n: int, duration: int
    ) -> np.ndarray:
        """Load ``n`` random segments ``[n, 2, duration]`` (length-weighted
        file choice, random start; shorter files zero-padded)."""
        idxs = rng.choice(len(self.paths[inst]), size=n, p=self.weights[inst])
        starts = [
            int(rng.integers(0, max(self.lengths[inst][fi] - duration, 1)))
            if self.lengths[inst][fi] > duration
            else 0
            for fi in idxs
        ]
        bank = self.banks.get(inst)
        if bank is not None:
            return bank.read_segments(idxs, starts, duration)
        out = np.zeros((n, 2, duration), np.float32)
        for i, (fi, start) in enumerate(zip(idxs, starts)):
            path = self.paths[inst][fi]
            seg, _ = read_wav(path, start=start, duration=min(duration, self.lengths[inst][fi]))
            seg = seg.T[:2] if seg.shape[1] >= 2 else np.repeat(seg.T, 2, 0)
            out[i, :, : seg.shape[-1]] = seg
        return out


class _FXDataset:
    """What both datasets share: the corpus' files, the instruments' FX
    chains, and the per-item seeds of the segment draws and the FX plans."""

    def __init__(
        self,
        data_dir: str,
        mode: str = "train",
        instruments: Sequence[str] = ("drums", "bass", "other", "vocals"),
        segment_length: int = 2**17,
        apply_prob_dict: Optional[Dict[str, float]] = None,
        reverb_prob: Optional[Dict[str, float]] = None,
        ir_bank: Optional[np.ndarray] = None,
        use_normalized: bool = True,
        normalization_order: str = "eqcompimagegain",
        fixed_random_seed: int = 777,
        sample_rate: int = 44100,
        pad_b4_manipulation: bool = True,
        use_native: bool = True,
        device="cuda",
    ):
        self.files = _MUSDBFiles(
            os.path.join(data_dir, mode), instruments, use_normalized, normalization_order,
            use_native=use_native, sample_rate=sample_rate,
        )
        self._device = device
        self.mode = mode
        self.instruments = tuple(instruments)
        self.segment_length = segment_length
        self.fixed_random_seed = fixed_random_seed
        self.sample_rate = sample_rate
        self.pad = PAD_B4_MANIPULATION if pad_b4_manipulation else 0
        self.manipulators = make_instrument_manipulators(
            instruments, apply_prob_dict, reverb_prob, ir_bank, sample_rate
        )

    @property
    def device(self) -> torch.device:
        """Where the chains run (resolved at first use: the raw batches
        need no card)."""
        return resolve_device(self._device)

    def _rng_for(self, idx: int, epoch_seed: Optional[int]) -> np.random.Generator:
        if self.mode == "train":
            return np.random.default_rng(np.random.SeedSequence([epoch_seed or 0, idx]))
        return np.random.default_rng(idx * self.fixed_random_seed)

    def _seed_for(self, idx: int, epoch_seed: Optional[int]) -> int:
        if self.mode == "train":
            return (epoch_seed or 0) * 1_000_003 + idx
        return idx * self.fixed_random_seed

    def _draw_plans(self, indices: Sequence[int], epoch_seed: Optional[int], K: int) -> Dict[str, dict]:
        """Per instrument its chain's plan for ``len(indices) * K`` draws,
        item-major (item j's K draws at ``j*K : (j+1)*K``). Item j draws
        every instrument, in order, from a generator seeded with
        ``_seed_for(j, epoch_seed)``."""
        per_inst: Dict[str, list] = {inst: [] for inst in self.instruments}
        for idx in indices:
            gen = torch.Generator().manual_seed(self._seed_for(idx, epoch_seed))
            for inst in self.instruments:
                per_inst[inst].append(self.manipulators[inst].draw(gen, K))
        return {inst: cat_plans(p) for inst, p in per_inst.items()}

    def sample_raw_batch(
        self,
        indices: Sequence[int],
        epoch_seed: Optional[int] = None,
        transport: str = "auto",
        plans: Optional[Dict[str, dict]] = None,
    ) -> Tuple[np.ndarray, Dict[str, dict]]:
        """Host side of the fused train paths (``train/fused.py``): raw
        segments and FX plans, no card work. Returns ``(segs [n_inst, B,
        2(content A/B), 2(ch), segment_length + 2*pad]`` (int16 when
        losslessly quantizable, else float32), ``plans)``: per item one
        generator, and per instrument two segments of different content from
        it; ``plans`` is ``batch_plans(indices)`` unless given.

        Items are drawn one by one from ``(idx, epoch_seed)``, whatever the
        other indices: a data-parallel rank passes only its block of the
        global batch's indices (``train/fused.py:_FusedPipeline.shard``)
        and reads only its own segments: the items and plans of that
        block of the one-process batch."""
        load_len = self.segment_length + 2 * self.pad
        n_inst, B = len(self.instruments), len(indices)
        segs = np.zeros((n_inst, B, 2, 2, load_len), np.float32)
        for j, idx in enumerate(indices):
            rng = self._rng_for(idx, epoch_seed)
            for ii in range(n_inst):
                segs[ii, j] = self.files.sample_segments(rng, self.instruments[ii], 2, load_len)
        if plans is None:
            plans = self.batch_plans(indices, epoch_seed)
        return to_transport(segs, transport), plans


class ContrastivePairDataset(_FXDataset):
    """FXencoder contrastive data: per-instrument raw (A, B) segments and
    the FX plans of their draws."""

    def __init__(self, *args, num_strong_negatives: int = 1, val_cache_dir: Optional[str] = None,
                 **kwargs):
        """``_FXDataset``'s arguments, the strong negatives per item, and
        the directory of the val mode's on-disk cache (none by default)."""
        super().__init__(*args, **kwargs)
        self.num_strong_negatives = num_strong_negatives
        self.val_cache_dir = val_cache_dir

    def sample_batch(
        self, indices: Sequence[int], epoch_seed: Optional[int] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """The manipulated views of ``indices``: two dicts (A, B), ``inst ->
        [len(indices) * K, 2, segment_length]``, an item's K views adjacent
        (the reference collate's layout), the pad trimmed, clipped to +-1.
        The raw batch and its plans (:meth:`sample_raw_batch`) go through
        the chains on the dataset's device in one batched walk. Items in the
        val cache are read from it; the others are written to it."""
        K = self.num_strong_negatives + 1
        views = {idx: self._load_val_cache(idx) for idx in indices}
        todo = [idx for idx in indices if views[idx] is None]
        if todo:
            dev = self.device
            segs, plans = self.sample_raw_batch(todo, epoch_seed, transport="float32")
            man_a, man_b = augment_contrastive_views(
                self.manipulators, self.instruments, torch.from_numpy(segs).to(dev),
                plan_to(plans, dev), self.pad,
            )  # [n_inst, len(todo) * K, 2, L] each
            man_a, man_b = man_a.cpu().numpy(), man_b.cpu().numpy()
            for j, idx in enumerate(todo):
                views[idx] = {
                    inst: [(man_a[i, j * K + k], man_b[i, j * K + k]) for k in range(K)]
                    for i, inst in enumerate(self.instruments)
                }
                self._save_val_cache(idx, views[idx])
        return tuple(
            {inst: np.stack([views[idx][inst][k][side] for idx in indices for k in range(K)])
             for inst in self.instruments}
            for side in (0, 1)
        )

    def batch_plans(self, indices: Sequence[int], epoch_seed: Optional[int] = None) -> Dict[str, dict]:
        """FX plans of ``indices``: per instrument its chain's plan for
        ``len(indices) * K`` draws, item-major (``K = num_strong_negatives + 1``)."""
        return self._draw_plans(indices, epoch_seed, self.num_strong_negatives + 1)

    def collate_plan(
        self,
        n_items: int,
        rng: np.random.Generator,
        quantum: Optional[int] = None,
    ) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """The (la, lb, sa, sb) draw of :meth:`collate_random_duration`
        without touching audio: the fused path crops on the card."""
        L = self.segment_length
        if quantum is None:
            quantum = max(4096, L // 8)
        la = _bucket_length(int(rng.integers(L // 2, L)), quantum)
        lb = _bucket_length(int(rng.integers(L // 2, L)), quantum)
        sa = np.array([int(rng.integers(0, L - la + 1)) for _ in range(n_items)], np.int32)
        sb = np.array([int(rng.integers(0, L - lb + 1)) for _ in range(n_items)], np.int32)
        return la, lb, sa, sb

    def collate_random_duration(
        self,
        batch_a: Dict[str, np.ndarray],
        batch_b: Dict[str, np.ndarray],
        rng: np.random.Generator,
        quantum: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Random-duration crop shared across the batch (reference collate
        :46-75), the A and B lengths drawn independently
        (``data_loader.py:51``) and bucketed to ``quantum`` (default
        ``max(4096, L//8)``); starts stay fully random. ``batch_a/b``:
        ``inst -> [B, 2, L]``. Returns ``[n_inst, B, 2, La] / [..., Lb]``."""
        n_items = next(iter(batch_a.values())).shape[0]
        la, lb, sa, sb = self.collate_plan(n_items, rng, quantum)
        a = np.stack([
            np.stack([batch_a[i][j, :, sa[j] : sa[j] + la] for j in range(n_items)])
            for i in self.instruments
        ])
        b = np.stack([
            np.stack([batch_b[i][j, :, sb[j] : sb[j] + lb] for j in range(n_items)])
            for i in self.instruments
        ])
        return a, b


    def _val_cache_path(self, idx: int) -> Optional[str]:
        if self.mode != "val" or not self.val_cache_dir:
            return None
        return os.path.join(self.val_cache_dir, str(idx))

    def _load_val_cache(self, idx: int):
        """Item ``idx``'s views from the cache, ``inst -> [(A_k, B_k)]``
        (``[2, L]`` each), or ``None`` if it is not cached."""
        path = self._val_cache_path(idx)
        if path is None or not os.path.isdir(path):
            return None
        out = {}
        for inst in self.instruments:
            out[inst] = []
            for k in range(self.num_strong_negatives + 1):
                a, _ = read_wav(os.path.join(path, f"{inst}_A{k+1}.wav"))
                b, _ = read_wav(os.path.join(path, f"{inst}_B{k+1}.wav"))
                out[inst].append((a.T, b.T))
        return out

    def _save_val_cache(self, idx: int, views) -> None:
        path = self._val_cache_path(idx)
        if path is None:
            return
        os.makedirs(path, exist_ok=True)
        for inst, pairs in views.items():
            for k, (a, b) in enumerate(pairs):
                write_wav(os.path.join(path, f"{inst}_A{k+1}.wav"), a.T, self.sample_rate)
                write_wav(os.path.join(path, f"{inst}_B{k+1}.wav"), b.T, self.sample_rate)

    def generate_contents_w_effects(
        self, num_content: int, num_effects: int, out_dir: str, seed: int = 0
    ) -> None:
        """Data-inspection hook (reference ``data_loader.py:290-348``): a grid
        of FX-manipulated contents and their mixtures, written to WAV:
        ``<inst>_ori_<c>.wav`` (content c as read, the pad trimmed),
        ``<inst>_<AA..><e>.wav`` (content c under effect e) and
        ``mixture_<AA..><e>.wav`` (the clipped sum over instruments), with
        ``AA..`` the two letters of c. Each (instrument, effect) is one FX
        draw over all contents, drawn from a generator seeded with ``seed``;
        the contents from a numpy generator seeded with ``seed``. The chains
        run on the dataset's device, one walk an instrument."""
        os.makedirs(out_dir, exist_ok=True)
        dev = self.device
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        L, sl = self.segment_length, slice(self.pad, self.pad + self.segment_length)
        mixtures = torch.zeros(num_effects, num_content, 2, L, device=dev)

        def tag(c: int, e: int) -> str:
            return f"{chr(65 + c // 26)}{chr(65 + c % 26)}{e+1}"

        for inst in self.instruments:
            segs = self.files.sample_segments(rng, inst, num_content, L + 2 * self.pad)
            for c in range(num_content):
                write_wav(os.path.join(out_dir, f"{inst}_ori_{c}.wav"), segs[c, :, sl].T,
                          self.sample_rate)
            # draw e applies to every content: the draw axis is the effect
            plan = plan_to(self.manipulators[inst].draw(gen, num_effects), dev)
            x = torch.from_numpy(segs).to(dev).expand(num_effects, *segs.shape)
            man = self.manipulators[inst].apply(plan, x)[..., sl].clamp(-1.0, 1.0)
            mixtures += man
            man = man.cpu().numpy()
            for e in range(num_effects):
                for c in range(num_content):
                    write_wav(os.path.join(out_dir, f"{inst}_{tag(c, e)}.wav"), man[e, c].T,
                              self.sample_rate)
        mixtures = mixtures.clamp(-1.0, 1.0).cpu().numpy()
        for e in range(num_effects):
            for c in range(num_content):
                write_wav(os.path.join(out_dir, f"mixture_{tag(c, e)}.wav"), mixtures[e, c].T,
                          self.sample_rate)


class StyleTransferTripletDataset(_FXDataset):
    """Converter training data: (A1 input, A2 ground truth, B2 reference)
    triplets, raw segments and one FX plan per (instrument, item)."""

    def __len__(self) -> int:
        inst = self.instruments[-1]
        return sum(self.files.lengths[inst]) // self.segment_length

    def batch_plans(self, indices: Sequence[int], epoch_seed: Optional[int] = None) -> Dict[str, dict]:
        """FX plans of ``indices``: per instrument one draw per item, which
        ``fx/fastpath.py:augment_triplets`` applies to both of the item's
        contents (A2 and B2 share it)."""
        return self._draw_plans(indices, epoch_seed, 1)

    def sample_batch(
        self, indices: Sequence[int], epoch_seed: Optional[int] = None
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """The triplets themselves, augmented on the dataset's device by
        each instrument's generic chain walk: ``inst -> {'a1','a2','b2'} ->
        [B, 2, segment_length]``."""
        dev = self.device
        segs, plans = self.sample_raw_batch(indices, epoch_seed, transport="float32")
        views = augment_triplets(
            self.manipulators, self.instruments, torch.from_numpy(segs).to(dev), plan_to(plans, dev),
            self.pad, self.segment_length, fast=False,
        )
        B = len(indices)
        return {
            inst: {k: v[i * B : (i + 1) * B].cpu().numpy() for k, v in zip(("a1", "a2", "b2"), views)}
            for i, inst in enumerate(self.instruments)
        }
