"""PyTorch port: the native library (``native.py`` over ``cpp/``), its wav
bank (``data/native_loader.py``) and the datasets' reader, on the CPU.

The bank's reads equal the port's ``wavio`` reads and the JAX package's
bank, byte for byte, on 16-bit, float32 (EXTENSIBLE and plain, with a
chunk before ``fmt``) and 24-bit files; garbage yields no bank, a file
broken after opening is named in the ``IOError``. The port builds its own
library under its ``_build/`` (never ``cpp/libmstdsp.so``, the JAX
package's), once under concurrent builds. The DSP oracles hold against
the port's plain versions at the JAX package's own tolerances
(``tests/test_native.py``): the compressor rtol 1e-3, atol 1e-4 (the
branchy float64 loop against the float32 max-affine walk), the biquad
5e-4 of max (a DF2T float32 recurrence against two first-order complex
scans), the cascade's NRMSE 2e-3.
"""
import os
import struct
import threading
import wave

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.data.native_loader import open_wav_bank as j_open_wav_bank
from music_mixing_style_transfer_tpu_torch import native
from music_mixing_style_transfer_tpu_torch.data import native_loader
from music_mixing_style_transfer_tpu_torch.data.datasets import _MUSDBFiles
from music_mixing_style_transfer_tpu_torch.data.native_loader import open_wav_bank
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav, write_wav
from music_mixing_style_transfer_tpu_torch.ops.biquad import biquad_apply, rbj_coeffs
from music_mixing_style_transfer_tpu_torch.ops.compressor import compressor_process

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_float32_wav(path, audio, rate=44100, extensible=False):
    """IEEE-float WAV (plain, or EXTENSIBLE), a LIST chunk before ``fmt``."""
    audio = np.asarray(audio, np.float32)  # [T, C]
    c = audio.shape[1]
    data = audio.astype("<f4").tobytes()
    chunks = b"LIST" + struct.pack("<I", 10) + b"INFOjunk12"
    if extensible:
        sub = struct.pack("<H", 3) + bytes(14)
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, c, rate, rate * c * 4, c * 4, 32, 22, 32, 0x3) + sub
    else:
        fmt = struct.pack("<HHIIHH", 3, c, rate, rate * c * 4, c * 4, 32)
    chunks += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def _write_pcm24_wav(path, samples24, rate=44100):
    s = np.asarray(samples24, np.int32)
    raw = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in s.reshape(-1))
    with wave.open(path, "w") as w:
        w.setnchannels(s.shape[1])
        w.setsampwidth(3)
        w.setframerate(rate)
        w.writeframes(raw)


@pytest.fixture
def wav_files(tmp_path, rng):
    """16-bit stereo and mono, float32 plain and EXTENSIBLE, 24-bit."""
    paths = []
    for i, (t, ch) in enumerate([(5000, 2), (3000, 1)]):
        p = str(tmp_path / f"pcm16_{i}.wav")
        write_wav(p, (rng.standard_normal((t, ch)) * 0.3).clip(-1, 1).astype(np.float32))
        paths.append(p)
    for ext in (False, True):
        p = str(tmp_path / f"f32_{int(ext)}.wav")
        _write_float32_wav(p, rng.standard_normal((2000, 2)) * 0.5, extensible=ext)
        paths.append(p)
    p = str(tmp_path / "pcm24.wav")
    _write_pcm24_wav(p, rng.integers(-(2**23), 2**23, size=(800, 2), dtype=np.int32))
    paths.append(p)
    return paths


def _wavio_segment(path, start, dur, frames):
    seg, _ = read_wav(path, start=start, duration=max(min(dur, frames - start), 0))
    seg = seg.T[:2] if seg.shape[1] >= 2 else np.repeat(seg.T, 2, 0)
    out = np.zeros((2, dur), np.float32)
    out[:, : seg.shape[1]] = seg
    return out


def test_library_builds_under_the_port_never_in_cpp():
    lib = native.get_lib()
    assert lib is not None and native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "music_mixing_style_transfer_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libmstdsp-") and os.path.exists(path)
    assert lib._name == path


def test_concurrent_builds_produce_one_library(tmp_path, monkeypatch):
    """Four threads build into an empty directory at once: one library,
    every thread gets its path, no temporary file left."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    results, errors = [], []

    def build():
        try:
            results.append(native.build())
        except Exception as e:  # noqa: BLE001 - the assertion below reports it
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(results)) == 1 and len(results) == 4
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(results[0]), "libmstdsp.lock"])


def test_wav_bank_equals_wavio_and_the_jax_bank(wav_files, rng):
    bank = open_wav_bank(wav_files)
    jbank = j_open_wav_bank(wav_files)
    assert bank is not None and jbank is not None
    assert bank.frames == jbank.frames == [5000, 3000, 2000, 2000, 800]
    assert bank.rates == [44100] * 5 and bank.channels == [2, 1, 2, 2, 2]
    fi = np.array([0, 1, 2, 3, 4, 1, 0, 4])
    starts = np.array([0, 100, 37, 1990, 10, 2900, 4990, 799])  # some reads run past the end
    dur = 512
    got = bank.read_segments(fi, starts, dur)
    assert got.shape == (8, 2, dur) and got.dtype == np.float32
    assert got.tobytes() == jbank.read_segments(fi, starts, dur).tobytes()
    for k, (f, s) in enumerate(zip(fi, starts)):
        want = _wavio_segment(wav_files[f], s, dur, bank.frames[f])
        assert got[k].tobytes() == want.tobytes()
    # the thread pool's partition changes nothing
    assert bank.read_segments(fi, starts, dur, n_threads=1).tobytes() == \
        bank.read_segments(fi, starts, dur, n_threads=8).tobytes()
    bank.close()
    jbank.close()


def test_wav_bank_rejects_garbage_and_names_a_broken_file(tmp_path, rng):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file at all, definitely")
    assert open_wav_bank([bad]) is None and j_open_wav_bank([bad]) is None
    good, broken = str(tmp_path / "good.wav"), str(tmp_path / "broken.wav")
    for p in (good, broken):
        write_wav(p, (rng.standard_normal((8000, 2)) * 0.1).astype(np.float32))
    bank = open_wav_bank([good, broken])
    with open(broken, "r+b") as f:
        f.truncate(64)  # the header stays, the data goes
    with pytest.raises(IOError, match="broken.wav"):
        bank.read_segments([0, 1], [0, 4000], 1024)
    with pytest.raises(IndexError):
        bank.read_segments([2], [0], 128)
    with pytest.raises(ValueError):
        bank.read_segments([0], [-5], 128)
    with pytest.raises(ValueError):
        bank.read_segments([0], [0], 0)
    bank.close()
    with pytest.raises(ValueError, match="closed"):
        bank.read_segments([0], [0], 128)


def _corpus(root, rng, rate=44100):
    d = root / "train"
    os.makedirs(d)
    for inst in ("drums", "bass"):
        for i, t in enumerate([30000, 50000, 4000]):
            write_wav(str(d / f"{inst}_normalized_eqcompimagegain_silence_trimmed{i}.wav"),
                      (rng.standard_normal((t, 2)) * 0.2).clip(-1, 1).astype(np.float32), rate=rate)
    return str(d)


def test_musdb_files_read_the_same_bytes_either_way(tmp_path, rng):
    from music_mixing_style_transfer_tpu.data.datasets import _MUSDBFiles as JFiles

    d = _corpus(tmp_path, rng)
    kw = dict(instruments=("drums", "bass"))
    native_files, plain = _MUSDBFiles(d, use_native=True, **kw), _MUSDBFiles(d, use_native=False, **kw)
    assert native_files.reader == "native" and plain.reader == "wavio"
    assert set(native_files.banks) == {"drums", "bass"} and not plain.banks
    assert native_files.lengths == plain.lengths
    jfiles = JFiles(d, use_native=True, **kw)
    for inst in ("drums", "bass"):
        got = native_files.sample_segments(np.random.default_rng(7), inst, 5, 8192)
        assert got.tobytes() == plain.sample_segments(np.random.default_rng(7), inst, 5, 8192).tobytes()
        assert got.tobytes() == jfiles.sample_segments(np.random.default_rng(7), inst, 5, 8192).tobytes()


def test_musdb_files_check_the_rate_and_read_through_wavio_without_a_library(tmp_path, rng,
                                                                             monkeypatch):
    """The bank checks every file's rate when it opens; without a library
    the ``wavio`` reads check it at each read (the JAX package's contract)."""
    d48 = _corpus(tmp_path / "a", rng, rate=48000)
    with pytest.raises(ValueError, match="48000"):
        _MUSDBFiles(d48, instruments=("drums",), use_native=True)
    assert _MUSDBFiles(d48, instruments=("drums",), sample_rate=48000).reader == "native"
    d44 = _corpus(tmp_path / "b", rng)
    monkeypatch.setattr(native_loader.native, "get_lib", lambda: None)
    assert open_wav_bank([os.path.join(d44, os.listdir(d44)[0])]) is None
    files = _MUSDBFiles(d44, instruments=("drums",), use_native=True)
    assert files.reader == "wavio" and not files.banks
    seg = files.sample_segments(np.random.default_rng(0), "drums", 2, 4096)
    assert seg.shape == (2, 2, 4096) and np.isfinite(seg).all()
    with pytest.raises(ValueError, match="48000"):
        _MUSDBFiles(d48, instruments=("drums",)).sample_segments(np.random.default_rng(0), "drums", 1, 64)


@pytest.mark.parametrize("th,att,rel,ratio", [(-20.0, 5.0, 120.0, 6.0), (-20.0, 5.0, 120.0, 0.25),
                                              (-20.0, 200.0, 50.0, 6.0)])
def test_native_compressor_oracle_matches_the_plain_version(rng, th, att, rel, ratio):
    """Compression, expansion, and an attack slower than the release (the
    min branch of the max-affine walk)."""
    x = (rng.standard_normal((2, 6000)) * 0.5).astype(np.float32)
    want = native.compressor_process(x, th, att, rel, ratio)
    got = compressor_process(torch.from_numpy(x), th, att, rel, ratio).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_native_biquad_oracles_match_the_plain_version(rng):
    specs = [("low_shelf", 5.0, 0.707, 100.0), ("peaking", -6.0, 1.2, 2000.0),
             ("high_shelf", 3.0, 0.707, 8000.0)]
    cs = [rbj_coeffs(t, g, q, f, 44100.0) for t, g, q, f in specs]
    x = rng.standard_normal(5000).astype(np.float32)
    one = native.biquad_lfilter(x, cs[1].double().numpy())
    got = biquad_apply(torch.from_numpy(x), cs[1]).numpy()
    assert np.abs(got - one).max() <= 5e-4 * np.abs(one).max()
    cascade = native.biquad_cascade(x, torch.stack(cs).double().numpy())
    y = torch.from_numpy(x)
    for c in cs:
        y = biquad_apply(y, c)
    y = y.numpy()
    assert np.sqrt(np.mean((y - cascade) ** 2)) / np.sqrt(np.mean(cascade**2)) < 2e-3
