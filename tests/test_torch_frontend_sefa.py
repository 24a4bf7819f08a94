"""PyTorch port: FrontEnd / BackEnd and SeFa vs the JAX package, on the CPU.

Tolerances: the front end's features and the back end's waveforms at 1e-5
of the largest magnitude (float32 FFTs in another order, as
``test_torch_dsp.py``); Griffin-Lim from JAX's initial phase at 1e-4 (each
iteration's ``angle`` is ill-conditioned where a bin's magnitude is near 0,
so float32 rounding grows over the iterations); the SeFa directions equal
(both packages run the same numpy on the same weight); the edited
converter at 1e-4, the models' tolerance.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import TCNConfig as JaxTCNCfg
from music_mixing_style_transfer_tpu.models import MixFXcloner as JaxMixFXcloner
from music_mixing_style_transfer_tpu.models import frontend as jfe
from music_mixing_style_transfer_tpu.models import sefa as jsefa
from music_mixing_style_transfer_tpu.models.fast_init import fast_init as jax_fast_init
from music_mixing_style_transfer_tpu_torch.config import TCNConfig
from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
from music_mixing_style_transfer_tpu_torch.models import frontend as pfe
from music_mixing_style_transfer_tpu_torch.models import sefa as psefa
from music_mixing_style_transfer_tpu_torch.models.weights import mixfxcloner_from_jax

# the JAX package's ops/__init__ exports a function named stft
jstft = importlib.import_module("music_mixing_style_transfer_tpu.ops.stft")
torch.set_num_threads(2)
REL = 1e-5
TCN = dict(condition_dimension=16, nblocks=4, channel_width=128)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(float(np.max(np.abs(want))), 1e-30), err


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX's arrays are read-only)


def test_frontend_modes_match_jax(rng):
    """Mono and stereo, Hann and Hamming, each mode and both together, with
    T a multiple of n_fft/4 (the trailing frame trimmed) and not."""
    for channel, shape in (("mono", (2,)), ("stereo", (2, 2))):
        for window in ("hann", "hamming"):
            kw = dict(channel=channel, n_fft=512, hop_length=128, window=window)
            port, ref = pfe.FrontEnd(**kw), jfe.FrontEnd(**kw)
            for T in (4096, 4100):
                x = rng.standard_normal(shape + (T,)).astype(np.float32)
                for mode in (["cplx"], ["mag"], ["cplx", "mag"]):
                    got = port(t(x), mode).numpy()
                    close(got, ref(jnp.asarray(x), mode))
                assert got.shape[1] == (6 if channel == "stereo" else 3), got.shape
    with pytest.raises(ValueError, match="unknown front-end mode"):
        pfe.FrontEnd(channel="mono", n_fft=256)(torch.zeros(1, 1024), ["phase"])


def test_backend_cplx_round_trip_matches_jax(rng):
    n_fft, hop = 512, 128
    for channel, shape in (("mono", (1,)), ("stereo", (1, 2))):
        kw = dict(channel=channel, n_fft=n_fft, hop_length=hop)
        x = (rng.standard_normal(shape + (4100,)) * 0.3).astype(np.float32)
        feats = jfe.FrontEnd(**kw)(jnp.asarray(x), ["cplx"])
        got = pfe.BackEnd(**kw).cplx_to_wave(t(np.asarray(feats))).numpy()
        close(got, jfe.BackEnd(**kw).cplx_to_wave(feats))
        # lossy only through the zeroed Nyquist bin: ~1/257 of white noise's energy
        ref = x.reshape(-1, x.shape[-1])
        y = got.reshape(-1, got.shape[-1])
        n = min(ref.shape[-1], y.shape[-1])
        assert np.sqrt(np.mean((y[:, hop : n - n_fft] - ref[:, hop : n - n_fft]) ** 2)) < 0.02


def test_backend_mag_phase_round_trip_matches_jax(rng):
    n_fft, hop = 512, 128
    x = (rng.standard_normal((1, 2, 4100)) * 0.3).astype(np.float32)
    win = jstft.hann_window(n_fft)
    specs = [np.swapaxes(np.asarray(jstft.stft(jnp.asarray(x[:, c]), n_fft, hop, win, center=True)),
                         -1, -2) for c in range(2)]
    mag = np.stack([np.abs(s) for s in specs], 1)[:, :, 1:]  # DC dropped, as the mag mode does
    phase = np.stack([np.angle(s) for s in specs], 1)[:, :, 1:]
    kw = dict(channel="stereo", n_fft=n_fft, hop_length=hop)
    got = pfe.BackEnd(**kw).mag_phase_to_wave(t(mag), t(phase)).numpy()
    close(got, jfe.BackEnd(**kw).mag_phase_to_wave(jnp.asarray(mag), jnp.asarray(phase)))
    n = min(x.shape[-1], got.shape[-1])
    assert np.sqrt(np.mean((got[..., hop : n - n_fft] - x[..., hop : n - n_fft]) ** 2)) < 0.02


def test_griffin_lim_matches_jax_from_its_initial_phase():
    sr, n_fft, hop, n_iter = 8192, 512, 128, 8
    tt = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * tt) + 0.1 * np.sin(2 * np.pi * 1234 * tt)).astype(np.float32)
    spec = jstft.stft(jnp.asarray(x[None]), n_fft, hop, jstft.hann_window(n_fft), center=True)
    mag = jstft.magnitude(jnp.swapaxes(spec, -1, -2))
    key = jax.random.PRNGKey(0)
    phase0 = jax.random.uniform(key, mag.shape, minval=-np.pi, maxval=np.pi)  # JAX's own draw
    be, jbe = pfe.BackEnd(channel="mono", n_fft=n_fft, hop_length=hop), jfe.BackEnd(
        channel="mono", n_fft=n_fft, hop_length=hop)
    got = be.griffin_lim(t(np.asarray(mag)), n_iter=n_iter, init_phase=t(np.asarray(phase0)))
    close(got.numpy(), jbe.griffin_lim(mag, n_iter=n_iter, key=key), rel=1e-4)
    # from a torch.Generator: seeded, and the tone's frequency survives
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (be.griffin_lim(t(np.asarray(mag)), n_iter=16, generator=gi).numpy()[0] for gi in g)
    assert np.array_equal(a, b) and np.abs(a).max() == pytest.approx(1.0)
    w = np.abs(np.fft.rfft(a[500:5000] * np.hanning(4500)))
    assert abs(np.fft.rfftfreq(4500, 1 / sr)[np.argmax(w)] - 440) < 10


def test_sefa_directions_match_jax(rng):
    conv = MixFXcloner(TCNConfig(**TCN))
    torch.nn.init.normal_(conv.blocks[2].film.film_fc.weight)
    w = conv.blocks[2].film.film_fc.weight.detach().numpy().copy()  # [2F, cond_dim]
    want_vals, want_vecs = jsefa.film_edit_directions({"weight": w})
    for film in (conv.blocks[2].film, w, torch.from_numpy(w)):
        vals, vecs = psefa.film_edit_directions(film)
        assert np.array_equal(vals, want_vals) and np.array_equal(vecs, want_vecs)
    assert np.all(np.diff(vals) <= 1e-6)  # descending
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(16), atol=1e-4)


def test_sefa_edited_converter_matches_jax(rng):
    """Per-block edited conditions (blocks 1 and 3; block 3 takes the fused
    block's dispatch) through the port's MixFXcloner and JAX's."""
    cond = rng.standard_normal(16).astype(np.float32)
    x = (rng.standard_normal((1, 2, 2048)) * 0.2).astype(np.float32)
    jtcn = JaxMixFXcloner(config=JaxTCNCfg(**TCN))
    v = jax_fast_init(jtcn, jnp.zeros((1, 2, 1024)), jnp.zeros((1, 16)), seed=3)
    conv = MixFXcloner(TCNConfig(**TCN)).eval()
    conv.load_state_dict(mixfxcloner_from_jax(v))
    assert conv.blocks[3].uses_kernel()
    edits = {1: (0, 5.0), 3: (2, -3.0)}
    want = jsefa.sefa_per_block_conditions(cond, v["params"], edits, n_blocks=4)
    got = psefa.sefa_per_block_conditions(cond, conv, edits)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    as_tensors = psefa.sefa_per_block_conditions(t(cond), conv, edits)
    for a, b in zip(as_tensors, want):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)
    y_jax = np.asarray(jtcn.apply(v, jnp.asarray(x), [jnp.asarray(c)[None] for c in want]))
    with torch.no_grad():
        y = conv(t(x), [c[None] for c in as_tensors]).numpy()
        base = conv(t(x), t(cond)[None]).numpy()
        null = conv(t(x), [c[None] for c in psefa.sefa_per_block_conditions(
            t(cond), conv, {1: (0, 0.0), 3: (2, 0.0)})]).numpy()
    np.testing.assert_allclose(y, y_jax, rtol=1e-4, atol=1e-4)
    assert not np.allclose(y, base, atol=1e-4)  # an edit changes the output
    assert np.array_equal(null, base)  # a null edit does not
