"""PyTorch port: the data tools vs the JAX package, on the CPU.

Byte for byte: ``data/prep.py`` and ``data/multitrack.py`` (the same numpy
code, the same seeds and augmenter), the WAVs of ``tools/synth_corpus.py``
and of ``tools/prepare_musdb.py --no_normalize``. Normalized on the CPU,
the prepared corpus feeds the port's ``ContrastivePairDataset``. The val
cache: the first ``sample_batch`` writes each item's views as 16-bit WAVs,
later ones read them back (within one LSB of the first: the rounding to
16-bit PCM, and a clipped +1.0 written as 32767; as in the JAX package),
then equal. ``generate_contents_w_effects`` writes the JAX
package's file set; each mixture is the clipped sum of its instruments'
files within 2.5 LSB (each of the five files rounds once, by at most half
an LSB).
"""
import logging
import os

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.data import multitrack as jm
from music_mixing_style_transfer_tpu.data import prep as jprep
from music_mixing_style_transfer_tpu.tools import prepare_musdb as jprepare
from music_mixing_style_transfer_tpu.tools import synth_corpus as jsynth
from music_mixing_style_transfer_tpu_torch.data import ContrastivePairDataset
from music_mixing_style_transfer_tpu_torch.data import multitrack as pm
from music_mixing_style_transfer_tpu_torch.data import prep as pprep
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav, write_wav
from music_mixing_style_transfer_tpu_torch.tools import prepare_musdb as pprepare
from music_mixing_style_transfer_tpu_torch.tools import synth_corpus as psynth

torch.set_num_threads(2)
INSTS = ("drums", "bass", "other", "vocals")
SR = 44100


def same_arrays(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same_arrays(got[k], want[k])
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_arrays(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def tree_bytes(root):
    """``relative path -> file bytes`` of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_prep_equals_jax(tmp_path, rng):
    for i, (t, ch) in enumerate([(3000, 2), (2000, 1)]):
        write_wav(str(tmp_path / "wavs" / f"sub{i}" / f"a{i}.wav"),
                  (rng.standard_normal((t, ch)) * 0.3).astype(np.float32))
    same_arrays(pprep.load_wav_dir(str(tmp_path / "wavs")), jprep.load_wav_dir(str(tmp_path / "wavs")))
    # an RT60-organized IR directory: two short ranges and two long ones merged
    for k, rt in enumerate(["100-200", "300-500", "3000-4000", "5000-6000", "0-50"]):
        for j in range(2):
            L, ch = 400 + 100 * k + j, 1 + (j % 2)
            ir = rng.standard_normal((L, ch)) * np.exp(-np.arange(L) / 80.0)[:, None]
            write_wav(str(tmp_path / "irs" / f"room{j}" / "RT60_avg" / rt / f"ir{k}.wav"),
                      (ir * 0.5).astype(np.float32))
    for kw in (dict(), dict(max_len=500), dict(long_rt60_ms=400)):
        same_arrays(pprep.load_ir_bank(str(tmp_path / "irs"), **kw),
                    jprep.load_ir_bank(str(tmp_path / "irs"), **kw))
    x = (rng.standard_normal((2, 5000)) * 0.5).astype(np.float32)
    same_arrays(pprep.fade_in(x, 300), jprep.fade_in(x, 300))
    same_arrays(pprep.fade_out(x), jprep.fade_out(x))
    for length, start in ((1200, None), (1200, 4500), (12000, None)):  # wrap, and a short input
        same_arrays(pprep.random_trim(x, length, np.random.default_rng(4), start),
                    jprep.random_trim(x, length, np.random.default_rng(4), start))
    quiet = x.copy()
    quiet[:, 1000:3000] *= 1e-5
    same_arrays(pprep.trim_silence(quiet, frame=512), jprep.trim_silence(quiet, frame=512))
    same_arrays(pprep.trim_silence(x * 0), jprep.trim_silence(x * 0))


@pytest.fixture(scope="module")
def mixing_dir(tmp_path_factory):
    """Three songs of aligned stems: unequal lengths, a mono stem, a mapped
    name, a stem split in two files, an unknown source, an empty song."""
    root = tmp_path_factory.mktemp("mixing")
    rng = np.random.default_rng(1)
    songs = {
        "song0": {"drums": (6000, 2), "bass": (5000, 1), "vox": (6000, 2), "noise": (100, 2)},
        "song1": {"drums": (4000, 2), "bass": (4000, 2), "other": (3000, 2)},
        "song2": {"other": (7000, 2), "other ": (2000, 2)},
        "song3": {"readme": (10, 1)},
    }
    for song, stems in songs.items():
        for name, (t, ch) in stems.items():
            write_wav(str(root / song / f"{name}.wav"), (rng.standard_normal((t, ch)) * 0.2).astype(np.float32))
    return str(root)


def test_multitrack_equals_jax(mixing_dir):
    kw = dict(sources=("drums", "bass", "other", "vocals"), mapped_sources={"vox": "vocals"},
              pad_wrap_samples=256)
    pds, jds = pm.scan_mixing_dataset(mixing_dir, **kw), jm.scan_mixing_dataset(mixing_dir, **kw)
    assert len(pds) == len(jds) == 3 and pds.directories == jds.directories
    assert pds.material_seconds == jds.material_seconds
    for song_p, song_j in zip(pds.songs, jds.songs):
        same_arrays({k: s.data for k, s in song_p.items()}, {k: s.data for k, s in song_j.items()})
    same_arrays(pds.sample_aligned(0, 4096, np.random.default_rng(2)),
                jds.sample_aligned(0, 4096, np.random.default_rng(2)))
    same_arrays(pds.sample_aligned(1), jds.sample_aligned(1))

    def augmenter(x):
        return np.tanh(2.0 * x).astype(np.float32)

    mk = dict(inputs=("drums", "bass"), outputs=("drums", "bass", "vocals"), batch_size=3,
              n_samples=2048, augmenter=augmenter, augmenter_sources=("drums",),
              augmenter_padding=(64, 32))
    same_arrays(pm.mixing_minibatch(pds, rng=np.random.default_rng(3), **mk),
                jm.mixing_minibatch(jds, rng=np.random.default_rng(3), **mk))
    mk = dict(sources=("drums", "other"), batch_size=4, n_samples=1024,
              present_prob={"drums": 0.7}, overlap_prob={"other": 0.5}, augmenter=augmenter,
              augmenter_padding=(16, 16))
    same_arrays(pm.mixture_minibatch(pds, rng=np.random.default_rng(5), **mk),
                jm.mixture_minibatch(jds, rng=np.random.default_rng(5), **mk))
    with pytest.raises(ValueError, match="fs="):
        pm.scan_mixing_dataset(mixing_dir, sources=("drums",), accepted_sampling_rates=(48000,))


def test_synth_corpus_writes_the_jax_bytes(tmp_path):
    assert psynth.main(["--output_dir", str(tmp_path / "p"), "--n_songs", "2", "--seconds", "0.5",
                        "--seed", "5"]) == 0
    jsynth.generate(str(tmp_path / "j"), 2, 0.5, "train", 5)
    got, want = tree_bytes(tmp_path / "p"), tree_bytes(tmp_path / "j")
    assert sorted(got) == sorted(want) and len(got) == 8
    assert got == want


@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """A synthetic MUSDB-layout corpus of 1 s songs: one in ``train`` and
    one in ``val``, and one in ``test`` whose vocals rest throughout."""
    root = tmp_path_factory.mktemp("raw")
    for split, seed in (("train", 1), ("val", 2), ("test", 0)):
        psynth.generate(str(root), 1, 1.0, split, seed)
    return str(root)


def test_prepare_musdb_without_normalization_writes_the_jax_bytes(raw_corpus, tmp_path):
    splits = ("train", "val", "test", "missing")
    n = pprepare.prepare_corpus(raw_corpus, str(tmp_path / "p"), splits, normalize=False)
    assert n == jprepare.prepare_corpus(raw_corpus, str(tmp_path / "j"), splits, normalize=False) == 3
    got, want = tree_bytes(tmp_path / "p"), tree_bytes(tmp_path / "j")
    assert "train/drums_silence_trimmed0.wav" in got and "test/vocals_silence_trimmed0.wav" not in got
    assert len(got) == 11 and got == want


def test_prepared_corpus_feeds_the_contrastive_dataset(tmp_path, caplog):
    """``prepare_musdb`` normalizes on the CPU here (``--device cpu``; one
    instrument of 0.4 s, since the CPU walks the compression sweep's ~1000
    lanes in a Python loop), logs each song's seconds and K2 launches (0:
    the CPU runs the plain version), and the port's dataset reads the
    result through the bank."""
    raw, out = str(tmp_path / "raw"), str(tmp_path / "prepared")
    psynth.generate(raw, 1, 0.4, "train", 1)
    logger = logging.getLogger("prepare_musdb")
    logger.addHandler(caplog.handler)
    try:
        rc = pprepare.main(["--musdb_root", raw, "--output_dir", out, "--splits", "train",
                            "--instruments", "bass", "--device", "cpu"])
    finally:
        logger.removeHandler(caplog.handler)
    assert rc == 0
    stats = [r.song_stats for r in caplog.records if hasattr(r, "song_stats")]
    assert [(s["split"], s["song"], s["launches"]) for s in stats] == [("train", "synth000", 0)]
    assert os.listdir(os.path.join(out, "train")) == ["bass_normalized_eqcompimagegain_silence_trimmed0.wav"]
    normalized, _ = read_wav(os.path.join(out, "train", "bass_normalized_eqcompimagegain_silence_trimmed0.wav"))
    plain, _ = read_wav(os.path.join(raw, "train", "synth000", "bass.wav"))
    assert normalized.shape[0] > 0 and not np.array_equal(normalized, plain[: normalized.shape[0]])
    ds = ContrastivePairDataset(out, mode="train", instruments=("bass",), segment_length=4096,
                                device="cpu")
    assert ds.files.reader == "native"
    a, b = ds.sample_batch([0, 1], epoch_seed=1)
    for views in (a, b):
        assert set(views) == {"bass"}
        v = views["bass"]
        assert v.shape == (4, 2, 4096) and v.dtype == np.float32
        assert np.isfinite(v).all() and np.abs(v).max() <= 1.0
    segs, _ = ds.sample_raw_batch([0, 1], epoch_seed=1)
    assert segs.dtype == np.int16 and np.abs(segs).max() > 0


@pytest.fixture(scope="module")
def prepared_raw(raw_corpus, tmp_path_factory):
    """The raw corpus prepared without normalization (the dataset reads
    ``use_normalized=False`` names)."""
    out = str(tmp_path_factory.mktemp("prepared_raw"))
    pprepare.prepare_corpus(raw_corpus, out, ("train", "val"), normalize=False)
    return out


def test_val_cache_round_trip(prepared_raw, tmp_path):
    cache = str(tmp_path / "cache")
    kw = dict(mode="val", segment_length=4096, use_normalized=False, val_cache_dir=cache, device="cpu")
    ds = ContrastivePairDataset(prepared_raw, **kw)
    first = ds.sample_batch([0, 3])
    assert sorted(os.listdir(cache)) == ["0", "3"]
    assert sorted(os.listdir(os.path.join(cache, "3"))) == sorted(
        f"{i}_{s}{k}.wav" for i in INSTS for s in "AB" for k in (1, 2))
    again = ContrastivePairDataset(prepared_raw, **kw).sample_batch([3, 0])
    for side in (0, 1):
        for inst in INSTS:
            f, g = first[side][inst], again[side][inst]
            assert g.shape == f.shape == (4, 2, 4096)
            # item 3's views come first now; the cache holds them as 16-bit PCM
            np.testing.assert_allclose(g, np.concatenate([f[2:], f[:2]]), rtol=0, atol=1 / 32768)
    third = ds.sample_batch([3, 0])
    same_arrays(third, again)
    # train mode never caches
    ContrastivePairDataset(prepared_raw, **dict(kw, mode="train")).sample_batch([0])
    assert sorted(os.listdir(cache)) == ["0", "3"]


def test_generate_contents_w_effects_writes_the_file_set(prepared_raw, tmp_path):
    out = str(tmp_path / "grid")
    ds = ContrastivePairDataset(prepared_raw, mode="train", segment_length=4096, use_normalized=False,
                                device="cpu")
    ds.generate_contents_w_effects(2, 3, out, seed=4)
    tags = [f"{a}{b}{e}" for a, b in ("AA", "AB") for e in (1, 2, 3)]
    want = {f"{i}_ori_{c}.wav" for i in INSTS for c in (0, 1)}
    want |= {f"{i}_{t}.wav" for i in INSTS for t in tags} | {f"mixture_{t}.wav" for t in tags}
    assert set(os.listdir(out)) == want
    for t in tags:
        mix, rate = read_wav(os.path.join(out, f"mixture_{t}.wav"))
        parts = sum(read_wav(os.path.join(out, f"{i}_{t}.wav"))[0].astype(np.float64) for i in INSTS)
        assert rate == SR and mix.shape == (4096, 2)
        assert np.abs(mix - np.clip(parts, -1, 1)).max() <= 2.5 / 32768
    ori, _ = read_wav(os.path.join(out, "drums_ori_0.wav"))
    fx, _ = read_wav(os.path.join(out, "drums_AA1.wav"))
    assert ori.shape == fx.shape == (4096, 2) and not np.array_equal(ori, fx)
