"""PyTorch port: the compressor and the envelope wrapper's plain version vs
the JAX package's ``compressor_process`` (its ``lax.scan`` path), on the
CPU. Same tolerance as ``tests/test_pallas_envelope.py``: rtol 1e-4, atol
1e-5 (float32 log10/pow forms and summation order differ; the recurrence is
contractive, so errors do not grow with T)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.ops import compressor as jcomp
from music_mixing_style_transfer_tpu_torch.ops import compressor as pcomp
from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import (
    compressor_envelope,
    envelope_reference,
)

torch.set_num_threads(2)
SR = 44100
TOL = dict(rtol=1e-4, atol=1e-5)


def _signal(rng, L, T, scale=0.3):
    env = np.abs(np.sin(np.linspace(0, rng.uniform(3, 12), T)))[None, :]
    gains = rng.uniform(0.05, 1.5, (L, 1))
    return (rng.standard_normal((L, T)) * scale * (0.05 + env) * gains).astype(np.float32)


def _jax(x, th, att, rel, ratio):
    """JAX compressor_process with per-lane parameters broadcast against x."""
    return np.asarray(
        jcomp.compressor_process(
            jnp.asarray(x), jnp.asarray(th)[:, None], jnp.asarray(att), jnp.asarray(rel),
            jnp.asarray(ratio)[:, None], 0.0, sample_rate=SR,
        )
    )


@pytest.mark.parametrize(
    "ratio,att,rel",
    [
        (4.0, 10.0, 180.0),   # downward compression, attack faster than release
        (0.25, 5.0, 60.0),    # upward expander
        (1.0, 10.0, 100.0),   # identity curve
        (3.0, 400.0, 20.0),   # a_att > a_rel: the min branch
    ],
)
def test_compressor_process_matches_jax(rng, ratio, att, rel):
    L, T = 3, 6000
    x = _signal(rng, L, T)
    th = np.asarray([-20.0, -12.0, -30.0], np.float32)
    full = lambda v: np.full(L, v, np.float32)  # noqa: E731
    want = _jax(x, th, full(att), full(rel), full(ratio))
    got = pcomp.compressor_process(
        torch.from_numpy(x), torch.from_numpy(th), att, rel, ratio, sample_rate=SR
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if ratio == 1.0:
        np.testing.assert_array_equal(got.numpy(), x)


def test_per_lane_parameters_match_jax(rng):
    """Every lane its own threshold, ratio (compressor, expander, identity)
    and attack/release, one lane with the attack slower than the release."""
    L, T = 5, 5000
    x = _signal(rng, L, T)
    th = np.asarray([-25.0, -10.0, -18.0, -30.0, -5.0], np.float32)
    ratio = np.asarray([6.0, 0.5, 1.0, 2.5, 20.0], np.float32)
    att = np.asarray([1.0, 7.5, 15.0, 300.0, 10.0], np.float32)
    rel = np.asarray([50.0, 400.0, 666.0, 30.0, 500.0], np.float32)
    want = _jax(x, th, att, rel, ratio)
    got = pcomp.compressor_process(*map(torch.from_numpy, (x, th, att, rel, ratio)), sample_rate=SR)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_envelope_reference_carries_the_envelope(rng):
    """The plain version against JAX's envelope scan itself, from a nonzero
    envelope carried in; the envelope it hands on is the last sample's."""
    L, T = 4, 3000
    x = _signal(rng, L, T)
    th = np.asarray([-20.0, -15.0, -25.0, -10.0], np.float32)
    ratio = np.asarray([4.0, 0.5, 8.0, 2.0], np.float32)
    a_att, a_rel = (np.array(a, np.float32) for a in jcomp.alphas(
        np.asarray([10.0, 5.0, 300.0, 1.0], np.float32),
        np.asarray([180.0, 60.0, 30.0, 400.0], np.float32), SR))
    env0 = np.asarray([3.0, -2.0, 7.5, 0.0], np.float32)
    x_g = jcomp.amp_to_db(jnp.asarray(x))
    x_l = x_g - jcomp.static_gain_curve(x_g, jnp.asarray(th)[:, None], jnp.asarray(ratio)[:, None])
    y_l = np.asarray(jcomp._envelope_scan(x_l, a_att, a_rel, y0=jnp.asarray(env0)))
    want = x * np.asarray(jnp.power(10.0, -y_l / 20.0))
    got, env = envelope_reference(*map(torch.from_numpy, (x, th, ratio, a_att, a_rel, env0)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(env.numpy(), y_l[:, -1], **TOL)


def test_compressor_stream_ragged_slabs_equal_one_pass(rng):
    L, T = 4, 7001
    x = _signal(rng, L, T)
    th = np.asarray([-20.0, -15.0, -25.0, -10.0], np.float32)
    ratio = np.asarray([4.0, 0.5, 8.0, 1.0], np.float32)
    att = np.asarray([10.0, 5.0, 300.0, 7.5], np.float32)
    rel = np.asarray([180.0, 60.0, 30.0, 400.0], np.float32)
    stream = pcomp.CompressorStream(th, att, rel, ratio, SR)
    cuts = [0, 1000, 1777, 4096, T]  # unequal, not aligned to anything
    got = np.concatenate(
        [stream.process(torch.from_numpy(x[:, a:b])).numpy() for a, b in zip(cuts, cuts[1:])], -1
    )
    one = pcomp.compressor_process(*map(torch.from_numpy, (x, th, att, rel, ratio)), sample_rate=SR)
    np.testing.assert_array_equal(got, one.numpy())
    np.testing.assert_allclose(got, _jax(x, th, att, rel, ratio), **TOL)


def test_compress_and_clip_matches_jax(rng):
    """Clip only the lanes whose output reaches full scale."""
    L, T = 4, 4000
    x = _signal(rng, L, T, scale=0.4)
    x[1] *= 40.0  # this lane exceeds full scale after compression
    th = np.asarray([-20.0, -6.0, -25.0, -10.0], np.float32)
    ratio = np.asarray([4.0, 1.5, 0.5, 1.0], np.float32)
    att = np.asarray([10.0, 5.0, 15.0, 7.5], np.float32)
    rel = np.asarray([180.0, 60.0, 666.0, 400.0], np.float32)
    want = np.asarray(jcomp.compress_and_clip(*map(jnp.asarray, (x, th, att, rel, ratio)), SR))
    got = pcomp.compress_and_clip(*map(torch.from_numpy, (x, th, att, rel, ratio)), SR).numpy()
    assert np.abs(want[1]).max() == 1.0 and np.abs(want[0]).max() < 1.0
    np.testing.assert_allclose(got, want, **TOL)


def test_envelope_wrapper_rejects_what_the_kernel_does_not_take():
    lanes = [torch.zeros(2) for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        compressor_envelope(
            torch.zeros(2, 8, device="meta"), *[a.to("meta") for a in lanes]
        )
    with pytest.raises(ValueError, match="float32"):
        compressor_envelope(torch.zeros(2, 8, dtype=torch.float64), *lanes)
    with pytest.raises(ValueError, match=r"must be \(2,\)"):
        compressor_envelope(torch.zeros(2, 8), *lanes[:4], torch.zeros(3))
    before = compressor_envelope.launches
    compressor_envelope(torch.zeros(2, 8), *lanes)  # the CPU takes the plain version
    assert compressor_envelope.launches == before
