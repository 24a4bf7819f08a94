"""PyTorch port: the DSP under FX normalization (STFT, biquads and
K-weighting, loudness, EQ FIR design and filtering, HFC onsets and peak
statistics, the imager and the Haas constants) vs the JAX package, on the
same numpy inputs, on the CPU.

Tolerances: 1e-5 of the largest magnitude for the FFT-based stages and the
float32 elementwise ones (float32 FFTs and sums in another order); the
boolean onset masks and segmentations must be equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from music_mixing_style_transfer_tpu.fx.processors import Haas as JaxHaas
from music_mixing_style_transfer_tpu.normalize import batch as jbatch
from music_mixing_style_transfer_tpu.normalize import imager as jimager
from music_mixing_style_transfer_tpu.normalize import matching as jmatch
from music_mixing_style_transfer_tpu.ops import biquad as jbiquad
from music_mixing_style_transfer_tpu.ops import loudness as jloud
from music_mixing_style_transfer_tpu_torch.fx.processors import HAAS_PARAMS_44K, rms_normalize
from music_mixing_style_transfer_tpu_torch.normalize import batch as pbatch
from music_mixing_style_transfer_tpu_torch.normalize import imager as pimager
from music_mixing_style_transfer_tpu_torch.normalize import matching as pmatch
from music_mixing_style_transfer_tpu_torch.ops import biquad as pbiquad
from music_mixing_style_transfer_tpu_torch.ops import loudness as ploud
from music_mixing_style_transfer_tpu_torch.ops import stft as pstft

# the JAX package's ops/__init__ exports a function named stft
jstft = importlib.import_module("music_mixing_style_transfer_tpu.ops.stft")
torch.set_num_threads(2)
SR = 44100
REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def music(rng, shape, T):
    """Noise under a slow envelope with sparse clicks: onsets to find."""
    env = np.abs(np.sin(np.linspace(0, rng.uniform(5, 30), T)))
    x = rng.standard_normal(shape + (T,)) * 0.2 * (0.05 + env)
    x[..., rng.integers(0, T, max(T // 3000, 1))] += 0.8
    return x.astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_windows_frame_and_stft(rng):
    np.testing.assert_array_equal(pstft.sqrt_hann_window(512), jstft.sqrt_hann_window(512))
    for periodic in (True, False):
        np.testing.assert_array_equal(
            pstft.hann_window(400, periodic), jstft.hann_window(400, periodic)
        )
    x = rng.standard_normal((2, 3, 5000)).astype(np.float32)
    np.testing.assert_array_equal(
        pstft.frame(t(x), 1024, 300).numpy(), np.asarray(jstft.frame(jnp.asarray(x), 1024, 300))
    )
    win = jstft.sqrt_hann_window(1024)
    for center in (False, True):
        close(pstft.stft(t(x), 1024, 256, win, center=center).numpy(),
              jstft.stft(jnp.asarray(x), 1024, 256, win, center=center))
    # a window shorter than n_fft is zero-padded to the centre
    close(pstft.stft(t(x), 1024, 256, jstft.hann_window(600)).numpy(),
          jstft.stft(jnp.asarray(x), 1024, 256, jstft.hann_window(600)))


@pytest.mark.parametrize("kind", ["low_shelf", "high_shelf", "peaking", "low_pass", "high_pass"])
def test_rbj_coeffs_and_frequency_response(kind):
    got = pbiquad.rbj_coeffs(kind, 5.0, 0.9, 1200.0, SR)
    want = jbiquad.rbj_coeffs(kind, 5.0, 0.9, 1200.0, SR)
    close(got.numpy(), want, rel=1e-6)
    omega = np.linspace(0, np.pi, 257).astype(np.float32)
    close(pbiquad.biquad_freq_response(got, t(omega)).numpy(),
          jbiquad.biquad_freq_response(want, jnp.asarray(omega)))


def test_cascade_fft_k_weight_and_odd_ext(rng):
    x = music(rng, (2,), 70000)
    coeffs = np.stack([np.asarray(jbiquad.rbj_coeffs("peaking", -4.0, 2.0, 800.0, SR)),
                       np.asarray(jbiquad.rbj_coeffs("low_pass", 0.0, 0.7, 9000.0, SR))])
    close(pbiquad.biquad_cascade_fft(t(x), t(coeffs)).numpy(),
          jbiquad.biquad_cascade_fft(jnp.asarray(x), jnp.asarray(coeffs)))
    close(ploud.k_weight(t(x), SR).numpy(), jloud.k_weight(jnp.asarray(x), SR))
    close(pbiquad._odd_ext(t(x[:, :5000]), 303).numpy(),
          jbiquad._odd_ext(jnp.asarray(x[:, :5000]), 303), rel=1e-6)


@pytest.mark.parametrize("layout", ["mono", "stereo", "batch"])
def test_integrated_loudness_matches_jax(rng, layout):
    """pyloudnorm layout [T], [T, C]; and [S, T, C], which JAX vmaps."""
    if layout == "mono":
        x = music(rng, (), 70000)
    elif layout == "stereo":
        x = music(rng, (2,), 70000).T.copy()
    else:
        x = music(rng, (3, 2), 80000).transpose(0, 2, 1).copy()
    got = ploud.integrated_loudness(t(x), SR).numpy().reshape(-1)
    items = x if layout == "batch" else [x]
    want = np.asarray([jloud.integrated_loudness(jnp.asarray(a), SR) for a in items])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)  # LUFS, dB


def test_loudness_silence_short_input_and_short_branch():
    assert ploud.integrated_loudness(torch.zeros(70000, 2), SR).item() == -np.inf
    assert float(jloud.integrated_loudness(jnp.zeros((70000, 2)), SR)) == -np.inf
    # too short for one 400 ms gating block: -inf, without filtering
    assert ploud.integrated_loudness(torch.ones(10000, 2), SR).item() == -np.inf
    # long enough to gate, too short for the spectral K-weighting: the
    # recurrence, on both sides (LUFS within 1e-4, as above)
    x = np.ones((30000, 2), np.float32)
    x[:, 1] = np.sin(np.arange(30000) * 0.01)
    got = ploud.integrated_loudness(t(x), SR).item()
    want = float(jloud.integrated_loudness(jnp.asarray(x), SR))
    assert np.isfinite(got) and abs(got - want) <= 1e-4


def test_lufs_normalize_matches_jax(rng):
    x = music(rng, (2,), 70000).T.copy()  # [T, C]
    close(ploud.lufs_normalize(t(x), SR, -18.0).numpy(),
          jloud.lufs_normalize(jnp.asarray(x), SR, -18.0))
    silent = np.zeros((70000, 2), np.float32)
    np.testing.assert_array_equal(ploud.lufs_normalize(t(silent), SR, -18.0).numpy(), silent)


def test_eq_fir_design_against_jax_and_scipy(rng):
    m, ntaps = 2049, 101
    a = (np.abs(rng.standard_normal((3, m))) + 0.01).astype(np.float32)
    r = (np.abs(rng.standard_normal((3, m))) + 0.01).astype(np.float32)
    got = pmatch.design_eq_fir_batch(t(a), t(r), ntaps).numpy()
    close(got, jmatch.design_eq_fir_batch(jnp.asarray(a), jnp.asarray(r), ntaps=ntaps))
    # scipy.signal.firwin2 (float64) on the same curve: float32 precision
    for i in range(3):
        frq = np.arange(m) / (m - 1)
        diff = np.sqrt(10.0 ** ((jmatch.amp_to_db(r[i]) - jmatch.amp_to_db(a[i])) / 20.0))
        close(got[i], scipy.signal.firwin2(ntaps, frq, diff, window="hamming"), rel=1e-4)


def test_grouped_fir_filtfilt_and_average_spectrum(rng):
    x = music(rng, (3,), 20000)
    taps = (rng.standard_normal((3, 101)) * 0.05).astype(np.float32)
    taps[:, 50] += 1.0
    close(pbatch._grouped_fir_filtfilt(t(x), t(taps)).numpy(),
          jbatch._grouped_fir_filtfilt(jnp.asarray(x), jnp.asarray(taps)))
    close(pmatch.average_magnitude_spectrum(t(x[0]), 4096, 1024).numpy(),
          jmatch.average_magnitude_spectrum(jnp.asarray(x[0]), 4096, 1024))
    valid = np.asarray([17, 5, 1], np.int32)
    close(pbatch._batched_avg_spectrum(t(x), t(valid), 4096, 1024).numpy(),
          jbatch._batched_avg_spectrum(jnp.asarray(x), jnp.asarray(valid), 4096, 1024))


def test_frame_features_onsets_and_peaks(rng):
    x = music(rng, (4,), 1024 * 60 + 100)
    x[2, : 1024 * 30] = 0.0  # a silent half: frames with no onset
    x[3] = 0.0               # no onset at all: every segment NaN but the pre-onset one
    got = pmatch.frame_peak_features(t(x))
    want = jmatch.frame_peak_features(jnp.asarray(x))
    for g, w in zip(got, want):
        if np.isfinite(np.asarray(w)).all():
            close(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = pmatch.onset_mask_from_features(got[0], got[2])
    jmask = np.asarray(jmatch.onset_mask_from_features(want[0], want[2]))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert jmask[:2].any() and not jmask[3].any()
    np.testing.assert_array_equal(pmatch.hfc_onset_mask(t(x)).numpy(),
                                  np.asarray(jmatch.hfc_onset_mask(jnp.asarray(x))))
    for pct in (75.0, 50.0):
        pm, ps = pmatch.mean_peak_from_frames(got[1], mask, percentile=pct)
        jm, js = jmatch.mean_peak_from_frames(want[1], jnp.asarray(jmask), percentile=pct)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)  # dB
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    assert np.isnan(pm.numpy()[3]) == np.isnan(np.asarray(jm)[3])
    pm, ps = pmatch.measure_mean_peak(t(x[:2]))
    jm, js = jmatch.measure_mean_peak(jnp.asarray(x[:2]))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-4)


def test_haas_constants_are_the_jax_draw():
    p = JaxHaas(44100).sample(jax.random.PRNGKey(0))
    assert int(p["delay"]) == HAAS_PARAMS_44K["delay"]
    assert np.float32(p["feedback"]) == np.float32(HAAS_PARAMS_44K["feedback"])
    assert float(np.float32(HAAS_PARAMS_44K["feedback"])) == HAAS_PARAMS_44K["feedback"]
    assert bool(p["left"]) == HAAS_PARAMS_44K["left"]


@pytest.mark.parametrize("mono", [False, True])
def test_normalize_imager_matches_jax(rng, mono):
    """A wide stem, and a near-mono one (the Haas branch)."""
    x = music(rng, (2,), 30000)
    if mono:
        x[1] = x[0] + 0.01 * x[1]
    targets, thresholds = np.asarray([0.12, 0.3], np.float32), np.asarray([0.975, 0.99], np.float32)
    stems = np.stack([x, x[::-1].copy() * 0.5])
    got = pimager.normalize_imager(t(stems), t(targets), t(thresholds)).numpy()
    for s in range(2):
        want = jimager.normalize_imager(
            jnp.asarray(stems[s]), target_side_mid_bal=float(targets[s]),
            mono_threshold=float(thresholds[s]),
        )
        close(got[s], want)
    with pytest.raises(NotImplementedError, match="44100"):
        pimager.normalize_imager(t(stems), 0.2, 0.9, sr=48000)
    close(rms_normalize(t(x), 3 * t(x)).numpy(), x)


def test_comp_grid_is_the_jax_grid():
    for ratio, expander in ((4, False), (6, True), (5, False)):
        for g, w in zip(pmatch._comp_grid(ratio, -40.0, 20, expander),
                        jmatch._comp_grid(ratio, -40.0, 20, expander)):
            np.testing.assert_array_equal(g, w)
