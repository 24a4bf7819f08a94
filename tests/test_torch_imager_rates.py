"""PyTorch port: the imager's Haas draw at every sample rate vs the JAX
package, on the CPU.

The JAX imager draws ``Haas(sr).sample(PRNGKey(0))``; the port computes the
same draw from two fixed words (``fx/processors.py:haas_params``). The
imager and the batched normalizer's imager stage must give JAX's output at
1e-5 of the largest magnitude (the tolerance of ``test_torch_dsp.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import NormalizationConfig as JaxNormCfg
from music_mixing_style_transfer_tpu.fx.processors import Haas as JaxHaas
from music_mixing_style_transfer_tpu.normalize import batch as jbatch
from music_mixing_style_transfer_tpu.normalize import imager as jimager
from music_mixing_style_transfer_tpu.normalize.features import load_fx_features as jax_load
from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
from music_mixing_style_transfer_tpu_torch.fx.processors import HAAS_PARAMS_44K, haas_params
from music_mixing_style_transfer_tpu_torch.normalize import imager as pimager
from music_mixing_style_transfer_tpu_torch.normalize.batch import BatchedAudioEffectsNormalizer
from music_mixing_style_transfer_tpu_torch.normalize.features import load_fx_features

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = os.path.join(REPO, "music_mixing_style_transfer_tpu_torch", "weights",
                        "musdb18_fxfeatures_eqcompimagegain.npy")
RATES = (22050, 32000, 48000, 96000)
REL = 1e-5


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(float(np.max(np.abs(want))), 1e-30), err


def near_mono(rng, T):
    """A stereo stem whose mid energy ratio is above the thresholds, so the
    imager stereoizes it with the Haas draw."""
    x = (rng.standard_normal((2, T)) * 0.2).astype(np.float32)
    x[1] = x[0] + 0.01 * x[1]
    return x


# 1 MHz: the randint multiplier's square wraps at 2^32 (span > 2^16)
@pytest.mark.parametrize("sr", (22050, 32000, 44100, 48000, 96000, 1000000))
def test_haas_draw_is_jaxs_at_every_rate(sr):
    want = JaxHaas(sample_rate=sr).sample(jax.random.PRNGKey(0))
    got = haas_params(sr)
    assert got["delay"] == int(want["delay"])
    assert np.float32(got["feedback"]) == np.float32(want["feedback"])
    assert got["left"] == bool(want["left"])
    if sr == 44100:
        assert got == HAAS_PARAMS_44K


def test_imager_matches_jax_at_other_rates(rng):
    """``normalize_imager`` on a near-mono stem (the Haas branch) and a wide
    one, and the batched normalizer with the imager as its only stage."""
    features = load_fx_features(FEATURES)
    jfeatures = jax_load(FEATURES)
    T = 6000
    stems = np.stack([near_mono(rng, T), (rng.standard_normal((2, T)) * 0.2).astype(np.float32)])
    targets = np.asarray([0.12, 0.3], np.float32)
    thresholds = np.asarray([0.975, 0.99], np.float32)
    for sr in RATES:
        got = pimager.normalize_imager(torch.from_numpy(stems), torch.from_numpy(targets),
                                       torch.from_numpy(thresholds), sr=sr).numpy()
        for s in range(2):
            want = jimager.normalize_imager(
                jnp.asarray(stems[s]), target_side_mid_bal=float(targets[s]),
                mono_threshold=float(thresholds[s]), sr=sr,
            )
            close(got[s], want)
        # the Haas draw moves with the rate: the stereoized stem differs from 44.1 kHz's
        at_44k = pimager.normalize_imager(torch.from_numpy(stems[:1]), 0.12, 0.975).numpy()
        assert not np.allclose(got[0], at_44k[0], atol=1e-4)

        cfg = dict(sample_rate=sr, effects=("imager",), fft_size=256)
        port = BatchedAudioEffectsNormalizer(features, NormalizationConfig(**cfg), device="cpu")
        jax_norm = jbatch.BatchedAudioEffectsNormalizer(jfeatures, JaxNormCfg(**cfg))
        batch = {"vocals": near_mono(rng, T), "bass": near_mono(rng, T)}
        got_b = port.normalize_stems(batch)
        want_b = jax_norm.normalize_stems(batch)
        for inst in batch:
            close(got_b[inst], want_b[inst])
