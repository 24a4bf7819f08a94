"""PyTorch port: the shape helpers, the STFT helpers (the reference
normalization's STFT pair and ``fx_utils``'s framing pair) and
``total_wav_length`` vs the JAX package, on the CPU.

Tolerance: 1e-5 of the largest magnitude (float32 FFTs and sums in another
order), as ``test_torch_dsp.py``; the inverse STFT's edge samples, where the
window sum is near 0, at the JAX package's own 1e-4 (``test_ops.py``);
windows and integer helpers are equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import torch

import music_mixing_style_transfer_tpu.data as jdata
import music_mixing_style_transfer_tpu.ops as jops
import music_mixing_style_transfer_tpu_torch.data as pdata
import music_mixing_style_transfer_tpu_torch.ops as pops
from music_mixing_style_transfer_tpu.data import wavio as jwavio
from music_mixing_style_transfer_tpu.ops import shapes as jshapes
from music_mixing_style_transfer_tpu_torch.data import wavio as pwavio
from music_mixing_style_transfer_tpu_torch.ops import shapes as pshapes
from music_mixing_style_transfer_tpu_torch.ops import stft as pstft

# the JAX package's ops/__init__ exports a function named stft
jstft = importlib.import_module("music_mixing_style_transfer_tpu.ops.stft")
torch.set_num_threads(2)
REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(float(np.max(np.abs(want))), 1e-30), err


def test_shape_helpers_match_jax(rng):
    x = rng.standard_normal((2, 3, 10)).astype(np.float32)
    for n in (4, 10, 17):
        got = pshapes.pad_to_length(torch.from_numpy(x), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jshapes.pad_to_length(jnp.asarray(x), n)))
    for args in ((1000, 15, 4), (44100, 25, 4, 12), (2**17, 5, 2, 0, 3), (999, 10, 1, 4, 2),
                 (4096, 15, 1, 7, 1)):
        assert pshapes.valid_length(*args) == jshapes.valid_length(*args)
        assert pshapes.is_complete_convolution(*args) == jshapes.is_complete_convolution(*args)
    for args in ((10, 1024, 256), (1, 2048, 512), (513, 4096, 1024)):
        assert pshapes.td_length_from_fd(*args) == jshapes.td_length_from_fd(*args)


def test_windows_match_jax():
    for n in (1, 7, 256, 2048):
        for periodic in (True, False):
            for name in ("hann_window", "hamming_window"):
                want = getattr(jstft, name)(n, periodic=periodic)
                got = getattr(pstft, name)(n, periodic=periodic)
                assert got.dtype == want.dtype and np.array_equal(got, want), (name, n, periodic)


def test_compute_stft_and_istft_match_jax(rng):
    samples = (rng.standard_normal((5000, 2)) * 0.3).astype(np.float32)  # [T, C]
    for hop, fft in ((256, 1024), (512, 2048)):
        got = pstft.compute_stft(torch.from_numpy(samples), hop, fft)
        want = jstft.compute_stft(jnp.asarray(samples), hop, fft)
        close(got.numpy(), np.asarray(want))
        for length in (None, 4000):
            y = pstft.compute_istft(got, hop, fft, length=length).numpy()
            y_jax = np.asarray(jstft.compute_istft(want, hop, fft, length=length))
            # the first and last samples divide by a window sum near 0, which
            # amplifies float32 rounding: there the JAX test's 1e-4 absolute
            np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4)
            close(y[fft // 2 : -fft // 2], y_jax[fft // 2 : -fft // 2])


def test_slicing_matches_jax(rng):
    x = rng.standard_normal(3001).astype(np.float32)
    for kw in (dict(), dict(windowing=True), dict(center=False), dict(pad=6, windowing=True)):
        for win, hop in ((512, 128), (400, 160)):
            got = pstft.slicing(torch.from_numpy(x), win, hop, **kw)
            want = jstft.slicing(x, win, hop, **kw)
            assert got.dtype == torch.float32
            close(got.numpy(), np.asarray(want))


def test_overlap_matches_jax(rng):
    for win, hop, x_len in ((512, 128, 3001), (400, 160, 4000)):
        frames = rng.standard_normal((x_len // hop + 3, win)).astype(np.float32)
        for kw in (dict(), dict(windowing=False), dict(rate=1.5)):
            got = pstft.overlap(torch.from_numpy(frames), x_len, win, hop, **kw)
            want = jstft.overlap(jnp.asarray(frames), x_len, win, hop, **kw)
            assert got.dtype == torch.float32
            close(got.numpy(), np.asarray(want))


def test_total_wav_length_matches_jax(tmp_path, rng):
    paths = []
    for i, (T, ch) in enumerate(((1000, 2), (333, 1), (4410, 2))):
        paths.append(str(tmp_path / f"{i}.wav"))
        pwavio.write_wav(paths[-1], (rng.standard_normal((T, ch)) * 0.1).astype(np.float32), 44100)
    assert pwavio.total_wav_length(paths) == jwavio.total_wav_length(paths) == 5743
    assert pdata.total_wav_length(paths[:1]) == 1000


def test_package_exports_cover_jaxs():
    """Every name the JAX package's ``ops`` and ``data`` export, the port's
    export too (``ops.stft`` stays the module in the port)."""
    for jax_pkg, port_pkg in ((jops, pops), (jdata, pdata)):
        names = {n for n in dir(jax_pkg) if not n.startswith("_")}
        names -= {m for m in names if type(getattr(jax_pkg, m)).__name__ == "module"}
        missing = sorted(n for n in names - {"stft"} if not hasattr(port_pkg, n))
        assert missing == [], jax_pkg.__name__
