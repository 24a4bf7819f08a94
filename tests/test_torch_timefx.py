"""PyTorch port: resampling and the time/pitch FX vs the JAX package, on the
CPU, on the same numpy inputs.

Tolerances over max|oracle|:

- ``sinc_resample`` and ``playback_speed``: against JAX's own float32, 1e-5
  (a 65-tap gather and sum; measured ~3e-7).
- the phase vocoder (``time_stretch``, and inside ``pitch_shift`` and
  ``bend``): against JAX run in float64 (``jax.enable_x64``), 2e-5. The
  vocoder's phase arithmetic passes through ~1600 rad at the top bins, so
  JAX's own float32 lies ~1e-3 from its float64 run even at 2^14 samples;
  the port takes those steps in float64 (``ops/resample.py:phase_vocoder``)
  and sits ~1e-6 from it. ``pitch_shift``'s oracle is JAX's own pipeline
  with that stage in float64 and its resampling in float32, since the
  float32 sample positions are part of the function (they are pinned
  apart).
- the frame steps (``jnp.arange`` with a float step) and the sample
  positions: equal, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.fx import timefx as jt
from music_mixing_style_transfer_tpu.ops import resample as jr
from music_mixing_style_transfer_tpu_torch.fx import timefx as pt
from music_mixing_style_transfer_tpu_torch.ops import resample as pr

torch.set_num_threads(2)
T = 2**14
SINC_TOL = 1e-5
VOCODER_TOL = 2e-5


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def music(rng, shape, T=T):
    """Noise under a slow envelope, with two partials: ``[..., T]`` float32."""
    t = np.arange(T) / 44100.0
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1870.0 * t)
    env = 0.2 + np.abs(np.sin(np.linspace(0, 5, T)))
    return ((rng.standard_normal(shape + (T,)) * 0.2 + tone) * env * 0.5).astype(np.float32)


def vocoder64(fn, x, *args):
    """JAX's ``fn`` run in float64."""
    with jax.enable_x64(True):
        return np.asarray(fn(jnp.asarray(np.asarray(x, np.float64)), *args))


def jax_pitch_shift(x, semitones):
    """JAX's ``pitch_shift`` with its vocoder in float64, its resampling in
    float32 (``ops/resample.py:pitch_shift``'s steps, as they are)."""
    f = 2.0 ** (semitones / 12.0)
    stretched = vocoder64(jr.phase_vocoder, x, 1.0 / f).astype(np.float32)
    y = jr.sinc_resample(jnp.asarray(stretched), float(f), int(round(stretched.shape[-1] / f)))
    return np.asarray(jr._fix_length(y, x.shape[-1]))


def jax_bend(x, boundaries, cents):
    """JAX's ``bend`` over :func:`jax_pitch_shift`."""
    bounds = [0] + [int(b) for b in boundaries] + [x.shape[-1]]
    parts = []
    for i in range(len(bounds) - 1):
        seg = x[..., bounds[i] : bounds[i + 1]]
        short = seg.shape[-1] < 4096 or cents[i] == 0
        parts.append(seg if short else jax_pitch_shift(seg, float(cents[i]) / 100.0))
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("factor", [1.33, 0.77, 1.0, 1 / 1.33, 1.05])
def test_sinc_resample_and_playback_speed_match_jax(rng, factor):
    x = music(rng, (3, 2))
    n = int(round(T / factor))
    got = pr.sinc_resample(torch.from_numpy(x), factor, n).numpy()
    assert rel_err(got, jr.sinc_resample(jnp.asarray(x), factor, n)) <= SINC_TOL
    got = pr.playback_speed(torch.from_numpy(x[0]), factor).numpy()
    assert got.shape == (2, T)
    assert rel_err(got, jr.playback_speed(jnp.asarray(x[0]), factor)) <= SINC_TOL
    short = pr.playback_speed(torch.from_numpy(x[0]), factor, fix_length=False).numpy()
    assert rel_err(short, jr.playback_speed(jnp.asarray(x[0]), factor, fix_length=False)) <= SINC_TOL


def test_sample_positions_are_float32_as_in_jax():
    """At 2^19 outputs and factor 1.33 the float32 positions are the JAX
    package's bit for bit, and their fractional parts are quantised to 1/16
    of a sample over the last 1000 (float64 products take 100 values there,
    the hundredths of 1.33)."""
    out_len, factor = 2**19, 1.33
    got = pr.sample_positions(out_len, factor).numpy()
    # the expression of JAX's sinc_resample (ops/resample.py:33), jitted as there
    want = np.asarray(jax.jit(lambda f: jnp.arange(out_len) * f)(factor))
    np.testing.assert_array_equal(got, want)
    frac = got[-1000:] - np.floor(got[-1000:])
    assert len(np.unique(frac)) == 16 and np.all(np.round(frac * 16) == frac * 16)
    exact = np.arange(out_len - 1000, out_len) * factor
    assert len(np.unique(np.round(exact - np.floor(exact), 6))) == 100


@pytest.mark.parametrize("n_frames,rate", [(65, 1.05), (65, 0.84), (33, 1.33), (1025, 1 / 1.04)])
def test_frame_steps_are_jnp_arange(n_frames, rate):
    """``jnp.arange(0, n - 1, rate)``, JAX's frame steps, bit for bit. At
    (65, 1.05) and (65, 0.84), ``torch.arange`` would floor one step to the
    next frame."""
    got = pr.frame_steps(n_frames, rate)
    want = np.asarray(jnp.arange(0, n_frames - 1, rate))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    other = torch.arange(0, n_frames - 1, rate, dtype=torch.float32).numpy()
    if n_frames == 65:
        assert not np.array_equal(np.floor(got), np.floor(other))


@pytest.mark.parametrize("factor", [1.33, 0.8, 1.07, 1 / 1.33])
def test_time_stretch_matches_jax_in_float64(rng, factor):
    x = music(rng, (2,))
    got = pr.time_stretch(torch.from_numpy(x), factor).numpy()
    assert got.dtype == np.float32 and got.shape == (2, T)
    assert rel_err(got, vocoder64(jr.time_stretch, x, factor)) <= VOCODER_TOL
    long = pr.time_stretch(torch.from_numpy(x), factor, fix_length=False).numpy()
    assert rel_err(long, vocoder64(lambda y, f: jr.time_stretch(y, f, fix_length=False), x, factor)) \
        <= VOCODER_TOL


@pytest.mark.parametrize("semitones", [-3.0, 2.5, 5.95])
def test_pitch_shift_matches_jax(rng, semitones):
    x = music(rng, (2,))
    got = pr.pitch_shift(torch.from_numpy(x), semitones).numpy()
    assert rel_err(got, jax_pitch_shift(x, semitones)) <= VOCODER_TOL


def test_bend_matches_jax(rng):
    x = music(rng, (2,))
    params = jt.Bend().sample_host(np.random.default_rng(3), T)
    assert params.keys() == pt.Bend().sample_host(np.random.default_rng(3), T).keys()
    b, c = np.array([3000, 9000]), np.array([-300, 0, 475])
    got = pr.bend(torch.from_numpy(x), b, c).numpy()
    assert rel_err(got, jax_bend(x, b, c)) <= VOCODER_TOL
    assert np.array_equal(got[:, :3000], x[:, :3000])  # a segment under 4096 samples passes


def test_timefx_processors_draw_and_apply_as_jax(rng):
    """The same numpy seed gives both packages the same parameters; each
    processor applies them as the JAX package does, through the headroom
    scaling (peaks above 0.9) and the identity parameters."""
    x = music(rng, (2,)) * 4.0  # a peak above 0.9
    pairs = ((jt.PitchShift(), pt.PitchShift()), (jt.TimeStretch(), pt.TimeStretch()),
             (jt.PlaybackSpeed(), pt.PlaybackSpeed()))
    for seed in range(3):
        for jfx, pfx in pairs:
            want = jfx.sample_host(np.random.default_rng(seed))
            assert pfx.sample_host(np.random.default_rng(seed)) == want
        jb = jt.Bend().sample_host(np.random.default_rng(seed), T)
        pb = pt.Bend().sample_host(np.random.default_rng(seed), T)
        assert all(np.array_equal(jb[k], pb[k]) for k in jb)
    xt = torch.from_numpy(x)
    got = pt.PlaybackSpeed().apply({"factor": 1.21}, xt).numpy()
    assert rel_err(got, jt.PlaybackSpeed().apply({"factor": 1.21}, jnp.asarray(x))) <= SINC_TOL
    scale = float(np.abs(x).max())
    got = pt.TimeStretch().apply({"factor": 0.87}, xt).numpy()
    want = vocoder64(jr.time_stretch, x * (0.9 / scale), 0.87) * (scale / 0.9)
    assert rel_err(got, want) <= VOCODER_TOL
    got = pt.PitchShift().apply({"steps": -1.5}, xt).numpy()
    want = jax_pitch_shift((x * (0.9 / scale)).astype(np.float32), -1.5) * (scale / 0.9)
    assert rel_err(got, want) <= VOCODER_TOL
    assert pt.PitchShift().apply({"steps": 0.0}, xt) is xt
    assert pt.TimeStretch().apply({"factor": 1.0}, xt) is xt
    assert pt.PlaybackSpeed().apply({"factor": 1.0}, xt) is xt
