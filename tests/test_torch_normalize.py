"""PyTorch port: the batched FX normalizer vs the JAX package's
``BatchedAudioEffectsNormalizer``, on the CPU (the port's envelope wrapper
takes its plain version there; JAX its ``lax.scan`` compressor).

Small configs use ``fft_size=4096, hop_length=1024, ntaps=101`` and
synthetic features built with numpy; every stem has 2^16 samples or more,
so the K-weighting takes its spectral branch on both sides. Tolerance:
1e-4 of max|jax| on normalized stems (float32 FFTs and sums in another
order, through five stages); the compression choices, (ratio, threshold)
per channel and whether the host-stepped sweep ran, must be identical.
The JAX side's choices are read from the helpers its stage calls
(``_comp_static``, ``measure_mean_peak``, ``_stream_peaks_batch``).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import NormalizationConfig as JaxNormCfg
from music_mixing_style_transfer_tpu.normalize import batch as jbatch
from music_mixing_style_transfer_tpu.normalize import matching as jmatch
from music_mixing_style_transfer_tpu.normalize.features import load_fx_features as jax_load
from music_mixing_style_transfer_tpu.normalize.normalizer import (
    AudioEffectsNormalizer as JaxNormalizer,
)
from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
from music_mixing_style_transfer_tpu_torch.normalize.batch import BatchedAudioEffectsNormalizer
from music_mixing_style_transfer_tpu_torch.normalize.features import load_fx_features

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = "weights/musdb18_fxfeatures_eqcompimagegain.npy"
INSTS = ["drums", "bass", "other", "vocals"]
SMALL = dict(fft_size=4096, hop_length=1024, ntaps=101)
FFT = SMALL["fft_size"]
T = 2**16
REL = 1e-4


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def synthetic_features(rng, insts, bins=2049, comp=(-16.0, 1.0)):
    """Per-stem targets: EQ curves of ``bins`` bins, (peak dB, std)
    compression targets low enough to make the sweep compress, imager
    balances and loudness."""
    f = {"eq": {}, "compression": {}, "imager": {}, "loudness": {}}
    for i in insts:
        f["eq"][i] = np.abs(rng.standard_normal(bins)) * 0.05 + np.geomspace(1.0, 0.01, bins)
        f["compression"][i] = np.asarray(comp, np.float64)
        f["imager"][i] = rng.uniform(0.05, 0.3)
        f["loudness"][i] = np.asarray([-20.0 - rng.uniform(0, 5)])
    return f


def music(rng, shape, T, scale=0.2):
    env = np.abs(np.sin(np.linspace(0, rng.uniform(5, 30), T)))
    x = rng.standard_normal(shape + (T,)) * scale * (0.05 + env)
    x[..., rng.integers(0, T, max(T // 3000, 1))] += 3 * scale
    return x.astype(np.float32)


def normalizers(features, **cfg):
    cfg = {**SMALL, **cfg}
    return (
        jbatch.BatchedAudioEffectsNormalizer(features, JaxNormCfg(**cfg)),
        BatchedAudioEffectsNormalizer(features, NormalizationConfig(**cfg), device="cpu"),
    )


def jax_compression_choice(jb, stems_padded, insts):
    """What JAX's ``_stage_compression`` chooses per channel, from the
    helpers it calls: (ratio, threshold, active, fallback)."""
    cfg = jb.cfg
    ch = jnp.asarray(stems_padded).reshape(len(insts) * 2, -1)
    N = ch.shape[0]
    peaks = jnp.max(jnp.abs(ch), axis=-1, keepdims=True)
    x = ch * (10 ** (cfg.comp_peak_norm / 20.0) / jnp.maximum(peaks, 1e-30))
    feat = np.asarray(jmatch.measure_mean_peak(x, percentile=float(cfg.comp_percentile))[0])
    ref_peak, ref_std, attacks, releases, grids, Gm = jb._comp_static(insts)
    lo, hi = ref_peak - ref_std, ref_peak + ref_std
    down = ~((feat > lo) & (feat < hi)) & (feat > lo)
    up = ~((feat > lo) & (feat < hi)) & ~down & bool(cfg.comp_use_expander)
    active = (down | up) & np.isfinite(feat)
    grid_r = np.where(down[:, None], grids["down"][0], grids["up"][0])
    grid_t = np.where(down[:, None], grids["down"][1], grids["up"][1])
    Gc = int(min(Gm, max(1, 1024 // N)))
    chosen, found, fallback = np.full(N, Gm - 1), ~active, False
    for b in range(0, Gm, Gc):
        if found.all():
            break
        fallback = b > 0
        r, t = (np.pad(g[:, b : b + Gc], ((0, 0), (0, max(0, b + Gc - Gm))), mode="edge")
                for g in (grid_r, grid_t))
        pk = np.asarray(jbatch._stream_peaks_batch(
            x, r, t, attacks, releases, cfg.sample_rate, float(cfg.comp_percentile)))
        ok = np.where(down[:, None], pk < hi[:, None], pk > lo[:, None])[:, : min(Gc, Gm - b)]
        for n in range(N):
            if not found[n] and ok[n].any():
                chosen[n], found[n] = b + int(np.argmax(ok[n])), True
    rows = np.arange(N)
    return (np.where(active, grid_r[rows, chosen], 1.0), np.where(active, grid_t[rows, chosen], 0.0),
            active, fallback)


def assert_same_choice(pb, want):
    got = pb.last_compression
    np.testing.assert_array_equal(got["ratio"], want[0].astype(np.float32))
    np.testing.assert_array_equal(got["threshold"], want[1].astype(np.float32))
    np.testing.assert_array_equal(got["active"], want[2])
    assert bool(got["fallback"]) == want[3]


@pytest.fixture(scope="module")
def song():
    rng = np.random.default_rng(7)
    features = synthetic_features(rng, INSTS)
    x = np.stack([music(rng, (2,), T, scale=s) for s in (0.3, 0.2, 0.1, 0.15)])
    return features, np.pad(x, ((0, 0), (0, 0), (FFT, FFT)))


@pytest.mark.parametrize("effect", ["loudness", "eq", "compression", "imager"])
def test_stage_matches_jax(song, effect):
    features, xp = song
    if effect == "compression":
        # the stage takes no lengths and no K-weighting: a 2^14-sample stretch
        # of each stem keeps its sweep (1024 lanes walked in time) short
        xp = np.ascontiguousarray(xp[..., : 2 * FFT + 2**14])
    jb, pb = normalizers(features)
    args = ([T] * len(INSTS),) if effect == "eq" else ()
    want = getattr(jb, f"_stage_{effect}")(jnp.asarray(xp), INSTS, *args)
    got = getattr(pb, f"_stage_{effect}")(torch.from_numpy(xp), INSTS, *args)
    close(got.numpy(), want)
    if effect == "compression":
        choice = jax_compression_choice(jb, xp, INSTS)
        assert choice[2].all() and not choice[3]  # every channel compresses, in block 0
        assert_same_choice(pb, choice)


def test_normalize_stems_matches_jax():
    """Unequal stem lengths, a silent stem, a silent channel, a near-mono
    stem; the whole five-stage chain. A small candidate grid (42 candidates
    for ratio 4, none for drums' ratio 6) keeps the silent channels' sweep
    to one block (see the next test)."""
    rng = np.random.default_rng(11)
    features = synthetic_features(rng, INSTS)
    stems = {
        "drums": music(rng, (2,), T, 0.3),
        "bass": music(rng, (2,), T + 5000, 0.2),
        "other": np.zeros((2, T), np.float32),
        "vocals": music(rng, (2,), T + 1234, 0.15),
    }
    stems["bass"][1] = 0.0
    stems["vocals"][1] = stems["vocals"][0] + 0.01 * stems["vocals"][1]
    jb, pb = normalizers(features, comp_min_th=-20.0, comp_max_ratio=5)
    want, got = jb.normalize_stems(stems), pb.normalize_stems(stems)
    assert list(got) == INSTS
    for inst in INSTS:
        assert got[inst].shape == stems[inst].shape
        close(got[inst], want[inst])
    np.testing.assert_array_equal(got["other"], 0.0)


def swells(rng, Ts):
    """Tone bursts that rise and fall slowly (the envelope follows them, so
    the candidates' peak features spread out), alternating 0.9 and 0.3."""
    n = np.arange(Ts)
    env = np.zeros(Ts)
    for c in range(0, Ts - 3000, 3000):
        env[c : c + 2500] = np.hanning(2500) * (0.9 if (c // 3000) % 2 else 0.3)
    x = rng.standard_normal((2, Ts)) * 0.01 + env * np.sin(2 * np.pi * 220 * n / 44100)
    x[1] += rng.standard_normal(Ts) * 0.0005
    return np.pad(x.astype(np.float32), ((0, 0), (FFT, FFT)))[None]


def test_fallback_sweep_chooses_as_jax():
    """A compression target that no candidate of the first block meets: the
    host-stepped sweep runs, on both sides, and picks the same candidates."""
    rng = np.random.default_rng(1)
    xp = swells(rng, 2**14)
    insts = ["vocals"]
    features = synthetic_features(rng, insts)
    # the target lies between the best peak feature of block 0 (512
    # candidates for one stem's 2 channels, -28.516 dB) and the best of the
    # rest on each channel (-28.682 dB), both from JAX's _stream_peaks_batch
    # over the whole grid on this input
    features["compression"]["vocals"] = np.asarray([-28.599 - 0.5, 0.5])
    jb, pb = normalizers(features, stems=tuple(insts))

    want = jb._stage_compression(jnp.asarray(xp), insts)
    got = pb._stage_compression(torch.from_numpy(xp), insts)
    choice = jax_compression_choice(jb, xp, insts)
    assert choice[2].all() and choice[3]  # both channels active, the fallback ran
    assert (choice[0] > 4).all()  # past block 0's ratios
    assert_same_choice(pb, choice)
    close(got.numpy(), want)


def test_silent_channel_sweeps_the_whole_grid_as_jax():
    """A known fault shared with the JAX package (ROADMAP, section C): a
    silent channel measures a mean peak of 0 dB (no onsets, so the masked
    mean of nothing), takes the downward branch, meets no candidate and
    sweeps every block before falling through to the last candidate. The
    output is unchanged (zeros stay zeros); the time is the whole grid's."""
    rng = np.random.default_rng(2)
    xp = swells(rng, 2**14)
    xp[0, 1] = 0.0
    insts = ["vocals"]
    jb, pb = normalizers(synthetic_features(rng, insts), stems=tuple(insts))
    mean, _ = jmatch.measure_mean_peak(jnp.zeros((1, 2**14)))
    assert float(mean[0]) == 0.0
    got = pb._stage_compression(torch.from_numpy(xp), insts)
    np.testing.assert_array_equal(got.numpy()[0, 1], 0.0)
    choice = jax_compression_choice(jb, xp, insts)
    assert choice[3] and (choice[0][1], choice[1][1]) == (20.0, -40.0)
    assert_same_choice(pb, choice)


def test_default_config_with_the_shipped_features():
    """The CLI's configuration: the default NormalizationConfig and the
    port's copy of the MUSDB18 feature file, on a stem of about 1 s."""
    rng = np.random.default_rng(5)
    path = os.path.join(REPO, "music_mixing_style_transfer_tpu_torch", FEATURES)
    stems = {"drums": music(rng, (2,), 44100, 0.3)}
    cfg = dict(stems=("drums",))
    want = JaxNormalizer(path, JaxNormCfg(**cfg)).normalize_stems(stems)
    port = AudioEffectsNormalizer(path, NormalizationConfig(**cfg), device="cpu")
    got = port.normalize_stems(stems)
    close(got["drums"], want["drums"])
    assert port.batched().last_compression["ratio"].shape == (2,)


def test_feature_file_is_the_jax_packages_and_loads_the_same():
    ours = os.path.join(REPO, "music_mixing_style_transfer_tpu_torch", FEATURES)
    theirs = os.path.join(REPO, "music_mixing_style_transfer_tpu", FEATURES)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = load_fx_features(ours), jax_load(theirs)
    assert got.keys() == want.keys()
    for effect in want:
        assert got[effect].keys() == want[effect].keys()
        for stem in want[effect]:
            np.testing.assert_array_equal(got[effect][stem], want[effect][stem])


def test_normalizer_entry_points():
    path = os.path.join(REPO, "music_mixing_style_transfer_tpu_torch", FEATURES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            AudioEffectsNormalizer(path)  # the card by default, and none here
    norm = AudioEffectsNormalizer(path, device="cpu")
    assert norm.batched() is norm.batched() and norm.batched().device.type == "cpu"
    # the per-channel entry points run and match JAX's on the same input:
    # the min_db skip returns the stem as it is; two cheap stages of the
    # default config (the per-channel path's own tests: test_torch_normalize_channel.py)
    jnorm = JaxNormalizer(path)
    silent = np.zeros((2, 10), np.float32)
    np.testing.assert_array_equal(norm.normalize_audio(silent, "drums"),
                                  jnorm.normalize_audio(silent, "drums"))
    x = music(np.random.default_rng(3), (2,), 2000, 0.3)
    for effect in ("loudness", "imager"):
        close(norm.normalize_audio_per_effect(x, "drums", effect),
              jnorm.normalize_audio_per_effect(x, "drums", effect))
    assert dataclasses.asdict(norm.cfg) == dataclasses.asdict(JaxNormCfg())
