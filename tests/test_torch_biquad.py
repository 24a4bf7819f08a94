"""PyTorch port: the biquad recurrences, FIR and zero-phase filtering, and the
K-weighting below 65,536 samples vs the JAX package and scipy, on the CPU.

Tolerances:
- pole pairs: 1e-6 absolute (float32 trigonometry in another library);
- biquads against scipy ``lfilter`` in float64: NRMSE below 2e-3, the JAX
  package's own bar (``tests/test_ops.py``); and against JAX's
  ``biquad_apply`` on the same inputs 1e-4 of max|jax| (two float32 scans
  that round in another order); the sequential walks against JAX's
  ``lax.scan`` by NRMSE below 2e-3 too (XLA fuses multiply-adds, so the
  two float32 walks drift apart near DC as each drifts from float64);
- FIR filtering against ``lfilter`` 1e-4 and ``filtfilt`` 1e-3 absolute,
  the JAX package's bars; against JAX 1e-5 of max|jax|;
- the K-weighting at 30,000 samples 2e-4 of max|jax| (see its test);
  loudness in LUFS 1e-4 absolute, as for the long signals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from music_mixing_style_transfer_tpu.ops import biquad as jbiquad
from music_mixing_style_transfer_tpu.ops import loudness as jloud
from music_mixing_style_transfer_tpu_torch.ops import biquad as pbiquad
from music_mixing_style_transfer_tpu_torch.ops import loudness as ploud

torch.set_num_threads(2)
SR = 44100.0
DESIGNS = [
    ("low_shelf", 6.0, 0.707, 80.0),
    ("high_shelf", -50.0, 0.707, 100.0),
    ("peaking", 9.0, 0.7, 2000.0),
    ("low_pass", 0.0, 0.707, 5000.0),
    ("high_pass", 0.0, 0.5, 38.0),  # critically damped: the K-weighting's high-pass
]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nrmse(got, ref):
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref**2)))


def rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def lfilter(c, x):
    c = np.asarray(c, np.float64)
    return scipy.signal.lfilter(c[:3], [1.0, c[3], c[4]], np.asarray(x, np.float64), axis=-1)


@pytest.mark.parametrize("ftype,G,Q,fc", DESIGNS)
def test_rbj_poles_match_jax(ftype, G, Q, fc):
    got = pbiquad.rbj_poles(ftype, G, Q, fc, SR)
    assert got.dtype == torch.complex64 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbiquad.rbj_poles(ftype, G, Q, fc, SR)),
                               rtol=0, atol=1e-6)
    # the poles are the roots of the design's denominator
    c = pbiquad.rbj_coeffs(ftype, G, Q, fc, SR).double().numpy()
    np.testing.assert_allclose(np.sort_complex(got.numpy()),
                               np.sort_complex(np.roots([1.0, c[3], c[4]])), rtol=0, atol=1e-3)


@pytest.mark.parametrize("ftype,G,Q,fc", DESIGNS)
def test_biquad_recurrences_match_lfilter_and_jax(rng, ftype, G, Q, fc):
    c = pbiquad.rbj_coeffs(ftype, G, Q, fc, SR)
    poles = pbiquad.rbj_poles(ftype, G, Q, fc, SR)
    x = rng.standard_normal(4000).astype(np.float32)
    ref = lfilter(c.numpy(), x)
    scan = pbiquad.biquad_apply_scan(t(x), c).numpy()
    par = pbiquad.biquad_apply(t(x), c).numpy()
    assert nrmse(scan, ref) < 2e-3 and nrmse(par, ref) < 2e-3
    want = np.asarray(jbiquad.biquad_apply(jnp.asarray(x), jnp.asarray(c.numpy())))
    rel_close(par, want, 1e-4)
    with_poles = pbiquad.biquad_apply(t(x), c, poles=poles).numpy()
    want_poles = np.asarray(jbiquad.biquad_apply(
        jnp.asarray(x), jnp.asarray(c.numpy()), poles=jnp.asarray(poles.numpy())))
    rel_close(with_poles, want_poles, 1e-4)
    want_scan = np.asarray(jbiquad.biquad_apply_scan(jnp.asarray(x), jnp.asarray(c.numpy())))
    assert nrmse(scan, want_scan) < 2e-3


def test_critically_damped_high_pass_takes_the_analytic_poles(rng):
    """The 38 Hz, Q = 0.5 high-pass has a double pole: the discriminant
    a1^2 - 4 a2 cancels, so the compensated one and the analytic poles must
    both recover it; the clamp keeps every radius at or below 0.999999."""
    c = pbiquad.rbj_coeffs("high_pass", 0.0, 0.5, 38.0, SR)
    p = pbiquad.rbj_poles("high_pass", 0.0, 0.5, 38.0, SR)
    assert abs(p[0] - p[1]).item() < 1e-3 and (p.abs() < 1).all()
    disc = pbiquad._compensated_disc(c[3], c[4]).item()
    assert abs(disc) < 1e-6
    x = (rng.standard_normal(20000) * 0.3).astype(np.float32)
    ref = lfilter(c.numpy(), x)
    assert nrmse(pbiquad.biquad_apply(t(x), c, poles=p).numpy(), ref) < 2e-4
    unstable = torch.tensor([1.0001 + 0j, 0.5 + 0j], dtype=torch.complex64)
    y = pbiquad.biquad_apply(t(x), c, poles=unstable).numpy()
    assert np.isfinite(y).all()


def test_batched_coefficients_cascade_and_impulse_response(rng):
    c = torch.stack([pbiquad.rbj_coeffs("peaking", 5.0, 1.0, 1000.0, SR),
                     pbiquad.rbj_coeffs("peaking", -5.0, 0.5, 4000.0, SR)])
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    y = pbiquad.biquad_apply(t(x), c).numpy()
    for i in range(2):
        np.testing.assert_allclose(y[i], lfilter(c[i].numpy(), x[i]), rtol=1e-3, atol=1e-4)
    casc = pbiquad.biquad_cascade(t(x[0]), c).numpy()
    want = np.asarray(jbiquad.biquad_cascade(jnp.asarray(x[0]), jnp.asarray(c.numpy())))
    rel_close(casc, want, 1e-4)
    seq = pbiquad.biquad_cascade(t(x[0]), c, parallel=False).numpy()
    rel_close(seq, want, 1e-4)
    ir = pbiquad.biquad_impulse_response(c[0], ir_len=512).numpy()
    rel_close(ir, np.asarray(jbiquad.biquad_impulse_response(jnp.asarray(c[0].numpy()), ir_len=512)), 1e-5)
    long_x = (rng.standard_normal(30000) * 0.3).astype(np.float32)
    got = pbiquad.biquad_apply_fft(t(long_x), c[1]).numpy()
    assert nrmse(got, lfilter(c[1].numpy(), long_x)) < 2e-3
    rel_close(got, np.asarray(jbiquad.biquad_apply_fft(jnp.asarray(long_x), jnp.asarray(c[1].numpy()))),
              1e-4)


def test_fir_filter_and_filtfilt_match_scipy_and_jax(rng):
    taps = scipy.signal.firwin(101, 0.3).astype(np.float32)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    got = pbiquad.fir_filter(t(x), t(taps)).numpy()
    np.testing.assert_allclose(got, scipy.signal.lfilter(taps, 1.0, x, axis=-1), atol=1e-4)
    rel_close(got, np.asarray(jbiquad.fir_filter(jnp.asarray(x), jnp.asarray(taps))), 1e-5)
    ff = pbiquad.filtfilt_fir(t(x), t(taps)).numpy()
    np.testing.assert_allclose(ff, scipy.signal.filtfilt(taps, 1.0, x, padtype="odd"), atol=1e-3)
    rel_close(ff, np.asarray(jbiquad.filtfilt_fir(jnp.asarray(x), jnp.asarray(taps))), 1e-5)
    c = pbiquad.rbj_coeffs("peaking", 5.0, 1.0, 1000.0, SR)
    fb = pbiquad.filtfilt_biquad(t(x[0]), c).numpy()
    rel_close(fb, np.asarray(jbiquad.filtfilt_biquad(jnp.asarray(x[0]), jnp.asarray(c.numpy()))), 1e-4)


def test_fir_filter_runs_full_float32_whatever_the_process_flags(rng):
    """The flags are restored after the filter."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        taps = scipy.signal.firwin(11, 0.3).astype(np.float32)
        pbiquad.fir_filter(t(rng.standard_normal(100).astype(np.float32)), t(taps))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_k_weight_and_loudness_below_the_spectral_branch(rng):
    """30,000 stereo samples: the recurrence with the analytic poles, on both
    sides. Each float32 scan lies ~9e-5 of the peak from a float64 ``lfilter``
    run of the same coefficients, and the two ~1.5e-4 from each other, so
    they are held within 2e-4 of max|jax|."""
    x = (rng.standard_normal((2, 30000)) * 0.1).astype(np.float32)
    kw = ploud.k_weight(t(x), SR).numpy()
    rel_close(kw, np.asarray(jloud.k_weight(jnp.asarray(x), SR)), 2e-4)
    (sc, _), (hc, _) = ploud.k_weighting_coeffs(SR)
    assert nrmse(kw, lfilter(hc.numpy(), lfilter(sc.numpy(), x))) < 2e-3
    pyln = x.T.copy()  # pyloudnorm's [T, C]
    got = ploud.integrated_loudness(t(pyln), int(SR)).item()
    assert abs(got - float(jloud.integrated_loudness(jnp.asarray(pyln), int(SR)))) <= 1e-4
