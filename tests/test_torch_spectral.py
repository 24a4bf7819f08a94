"""PyTorch port: the converter's losses against the JAX package, on the CPU.

``frontend_mag``, ``multiscale_spectral_midside``,
``multiscale_spectral_stereo`` and ``rms_loss`` (JAX oracle:
``tests/test_losses.py``) on the same seeded inputs, at a length that
trims the last frame at every scale (``T % (n_fft/4) == 0``) and one that
trims at none: values within 1e-5 relative in float32.

Gradients with respect to ``est``: in float64 (JAX under ``enable_x64``)
within 1e-4 of their max. In float32 the log-magnitude term is
ill-conditioned on noise (its gradient ``1/((mag + eps) ln 10)`` reaches
~1/sqrt(eps) in near-empty bins), so both packages' float32 gradients sit
~5e-4 of their max from the float64 one; there the port is held to
within twice JAX's own distance from float64, or 1e-4, whichever is larger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.losses import spectral as jspec
from music_mixing_style_transfer_tpu.ops.stft import magnitude as j_magnitude
from music_mixing_style_transfer_tpu_torch.losses import spectral as pspec
from music_mixing_style_transfer_tpu_torch.ops.stft import magnitude

torch.set_num_threads(2)
LENGTHS = [8192, 8192 + 300]  # every scale trims its last frame; none does
LOSSES = ["multiscale_spectral_midside", "multiscale_spectral_stereo", "rms_loss"]


def _pair(seed, T, B=3):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((B, 2, T)) * 0.2
    est = 0.6 * tgt + rng.standard_normal((B, 2, T)) * 0.1  # a prediction near its target
    return est, tgt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def test_magnitude_matches_jax(rng):
    spec = (rng.standard_normal((4, 33)) + 1j * rng.standard_normal((4, 33))).astype(np.complex64)
    spec[0, :3] = 0  # sqrt(eps) there
    got = magnitude(torch.from_numpy(spec)).numpy()
    assert _rel(got, j_magnitude(jnp.asarray(spec))) <= 1e-6


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("n_fft", [4096, 2048, 1024, 512])
def test_frontend_mag_matches_jax(T, n_fft):
    x = _pair(0, T)[0][:, 0].astype(np.float32)
    want = np.asarray(jspec.frontend_mag(jnp.asarray(x), n_fft, n_fft // 4))
    got = pspec.frontend_mag(torch.from_numpy(x), n_fft, n_fft // 4).numpy()
    assert got.shape == want.shape
    assert want.shape[-1] == T // (n_fft // 4) + (0 if T % (n_fft // 4) == 0 else 1)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("name", LOSSES)
def test_loss_values_and_gradients_match_jax(name, T):
    est, tgt = _pair(1, T)
    jfn, pfn = getattr(jspec, name), getattr(pspec, name)

    def port(dtype):
        e = torch.tensor(est, dtype=dtype, requires_grad=True)
        v = pfn(e, torch.tensor(tgt, dtype=dtype))
        v.backward()
        return float(v.detach()), e.grad.numpy()

    jv32, jg32 = jax.value_and_grad(jfn)(jnp.asarray(est, jnp.float32), jnp.asarray(tgt, jnp.float32))
    with jax.enable_x64(True):
        jg64 = np.asarray(jax.grad(jfn)(jnp.asarray(est), jnp.asarray(tgt)))
    pv32, pg32 = port(torch.float32)
    _, pg64 = port(torch.float64)
    assert abs(pv32 - float(jv32)) <= 1e-5 * abs(float(jv32))
    assert _rel(pg64, jg64) <= 1e-4
    assert _rel(pg32, jg64) <= max(2 * _rel(np.asarray(jg32), jg64), 1e-4)


def test_rms_weight_carries_its_gradient():
    """The nonlinear weight multiplies the scalar MSE and is not detached:
    the gradient differs from the one with the weight held constant."""
    est, tgt = _pair(2, 4096)
    e = torch.tensor(est, requires_grad=True)
    pspec.rms_loss(e, torch.tensor(tgt)).backward()
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(jspec.rms_loss)(jnp.asarray(est), jnp.asarray(tgt)))
    assert _rel(e.grad.numpy(), want) <= 1e-9

    e2 = torch.tensor(est, requires_grad=True)
    r_e = e2.reshape(-1, e2.shape[-1]).pow(2).mean(-1).sqrt()
    r_t = torch.tensor(tgt).reshape(-1, tgt.shape[-1]).pow(2).mean(-1).sqrt()
    w = (torch.clamp((r_t - r_e).abs(), min=0.01) * 100).detach()
    torch.mean(w**1.5 * torch.mean((r_e - r_t) ** 2)).backward()
    assert _rel(e2.grad.numpy(), want) > 1e-3
