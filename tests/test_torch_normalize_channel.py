"""PyTorch port: the per-channel FX normalizer (``normalize_audio``,
``normalize_audio_per_effect``: eq_match, comp_match, panning_match, the
loudness and imager stages) vs the JAX package's, on the CPU.

Small config (fft 4096, hop 1024, 101 taps) and stems of 12,000 samples
(20,192 with the fft padding, below the spectral K-weighting's 65,536, so
the loudness stages run the biquad recurrence on both sides). The port's
envelope wrapper walks its plain version here, a Python loop over time, so
the inputs are chosen to match in the first chunk of 96 candidates.

Tolerances: 1e-4 of max|jax| for each stage and for the whole chain (float32
FFTs, scans and sums in another order, through five stages); the
compression choice, (ratio, threshold) per channel, must be identical. The
port's per-channel path against its batched path: the JAX package's own
bounds between its two paths (``tests/test_normalize.py``), NRMSE 1e-4
(loudness), 2e-2 (EQ), 1e-3 (imager) and 0.05 (the whole chain).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import NormalizationConfig as JaxNormCfg
from music_mixing_style_transfer_tpu.normalize import matching as jmatch
from music_mixing_style_transfer_tpu.normalize.normalizer import (
    AudioEffectsNormalizer as JaxNormalizer,
)
from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
from music_mixing_style_transfer_tpu_torch.normalize import matching as pmatch
from music_mixing_style_transfer_tpu_torch.normalize.normalizer import AudioEffectsNormalizer
from music_mixing_style_transfer_tpu_torch.ops import compressor as pcomp
from music_mixing_style_transfer_tpu_torch.ops.loudness import peak_normalize

torch.set_num_threads(2)
SMALL = dict(fft_size=4096, hop_length=1024, ntaps=101)
T = 12000
REL = 1e-4
# compression targets (mean peak dB, std): drums' sits below the inputs'
# peak feature (downward compression), vocals' above it (the expander)
COMP = {"drums": (-16.0, 1.0), "bass": (-16.0, 1.0), "other": (-16.0, 1.0), "vocals": (-6.0, 0.5)}


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def nrmse(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / (np.sqrt(np.mean(want**2)) + 1e-12))


def music(rng, T, scale):
    env = np.abs(np.sin(np.linspace(0, rng.uniform(5, 30), T)))
    x = rng.standard_normal((2, T)) * scale * (0.05 + env)
    x[..., rng.integers(0, T, max(T // 3000, 1))] += 3 * scale
    return x.astype(np.float32)


def features(rng):
    f = {"eq": {}, "compression": {}, "imager": {}, "loudness": {}, "panning": {}}
    for i in COMP:
        f["eq"][i] = np.abs(rng.standard_normal(2049)) * 0.05 + np.geomspace(1.0, 0.01, 2049)
        f["compression"][i] = np.asarray(COMP[i], np.float64)
        f["imager"][i] = rng.uniform(0.05, 0.3)
        f["loudness"][i] = np.asarray([-20.0 - rng.uniform(0, 5)])
        f["panning"][i] = np.clip(0.9 + 0.05 * rng.standard_normal(1025), 0, 1)
    return f


def build(cls, cfg_cls, feats, **cfg):
    """A normalizer on in-memory features (the constructor reads a file)."""
    n = cls.__new__(cls)
    n.cfg, n.features, n._batched = cfg_cls(**{**SMALL, **cfg}), feats, None
    if cls is AudioEffectsNormalizer:
        n.device = torch.device("cpu")
    return n


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    feats = features(rng)
    stems = {"drums": music(rng, T, 0.3), "vocals": music(rng, T, 0.15)}
    return feats, stems


@pytest.fixture
def choices(monkeypatch):
    """The (ratio, threshold) that each package's ``_comp_match_select``
    compresses with, in call order (one per matched channel)."""
    got = {"jax": [], "port": []}
    for key, mod in (("jax", jmatch), ("port", pmatch)):
        orig = mod._grid_one

        def record(x, r, t, *a, _orig=orig, _key=key):
            got[_key].append((float(r), float(t)))
            return _orig(x, r, t, *a)

        monkeypatch.setattr(mod, "_grid_one", record)
    return got


@pytest.mark.parametrize("effect", ["loudness", "eq", "imager", "panning"])
def test_stage_matches_jax(setup, effect):
    feats, stems = setup
    jn, pn = build(JaxNormalizer, JaxNormCfg, feats), build(AudioEffectsNormalizer, NormalizationConfig, feats)
    for inst, x in stems.items():
        got = pn.normalize_audio_per_effect(x, inst, effect)
        assert got.shape == x.shape and got.dtype == np.float32
        close(got, jn.normalize_audio_per_effect(x, inst, effect))


@pytest.mark.parametrize("inst,mode", [("drums", "down"), ("vocals", "up")])
def test_compression_makes_the_same_choice(setup, choices, inst, mode):
    """The downward branch (drums) and the expander (vocals): the same
    candidate per channel, found in the first chunk, and the same output."""
    feats, stems = setup
    cfg = dict(comp_use_expander=mode == "up")
    jn = build(JaxNormalizer, JaxNormCfg, feats, **cfg)
    pn = build(AudioEffectsNormalizer, NormalizationConfig, feats, **cfg)
    x = stems[inst]
    got = pn.normalize_audio_per_effect(x, inst, "compression")
    want = jn.normalize_audio_per_effect(x, inst, "compression")
    close(got, want)
    assert len(choices["port"]) == 2 and choices["port"] == choices["jax"]
    attack, release, ratio, _ = pn.cfg.comp_settings[inst]
    R, Th = pmatch._comp_grid(ratio, pn.cfg.comp_min_th, pn.cfg.comp_max_ratio, mode == "up")
    grid = list(zip(R.tolist(), Th.tolist()))
    assert all(grid.index(c) < 96 for c in choices["port"])


def test_min_db_skip_and_in_band_channel(setup, choices):
    """A stem at or below min_db passes through every stage untouched on both
    sides; a channel already in the target band is only peak-normalized."""
    feats, stems = setup
    jn, pn = build(JaxNormalizer, JaxNormCfg, feats), build(AudioEffectsNormalizer, NormalizationConfig, feats)
    quiet = stems["drums"] * 1e-4  # peaks below -50 dB
    for effect in ("loudness", "eq", "compression", "imager"):
        np.testing.assert_array_equal(pn.normalize_audio_per_effect(quiet, "drums", effect), quiet)
        np.testing.assert_array_equal(jn.normalize_audio_per_effect(quiet, "drums", effect), quiet)
    x = torch.from_numpy(np.pad(stems["drums"][0], 4096))
    peak = float(pmatch.measure_mean_peak(peak_normalize(x, -10.0))[0])
    y = pmatch.comp_match(x, peak, 1.0, 4.0, 20.0, 200.0)
    close(y.numpy(), np.asarray(jmatch.comp_match(jnp.asarray(x.numpy()), peak, 1.0, 4.0, 20.0, 200.0)))
    assert choices["port"] == choices["jax"] == []


def test_normalize_audio_matches_jax(setup, choices):
    """The whole default chain (loudness, eq, compression, imager, loudness;
    the expander off, so only drums' channels are compressed)."""
    feats, stems = setup
    jn, pn = build(JaxNormalizer, JaxNormCfg, feats), build(AudioEffectsNormalizer, NormalizationConfig, feats)
    for inst, x in stems.items():
        close(pn.normalize_audio(x, inst), jn.normalize_audio(x, inst))
    assert len(choices["port"]) == 2 and choices["port"] == choices["jax"]
    with pytest.raises(ValueError, match="unknown stem"):
        pn.normalize_audio(stems["drums"], "piano")


def test_per_channel_path_matches_the_batched_path(setup):
    """Within the JAX package's bounds between its own two paths."""
    feats, stems = setup
    pn = build(AudioEffectsNormalizer, NormalizationConfig, feats, stems=tuple(stems))
    b = pn.batched()
    fft = pn.cfg.fft_size
    insts = list(stems)
    x = torch.from_numpy(np.stack([np.pad(v, ((0, 0), (fft, fft))) for v in stems.values()]))
    for effect, tol in (("loudness", 1e-4), ("eq", 2e-2), ("imager", 1e-3)):
        args = (x, insts) + (([T] * len(insts),) if effect == "eq" else ())
        batched = getattr(b, f"_stage_{effect}")(*args).numpy()[:, :, fft : fft + T]
        for s, inst in enumerate(insts):
            seq = pn.normalize_audio_per_effect(stems[inst], inst, effect)
            assert nrmse(batched[s], seq) < tol, effect
    whole = pn.normalize_stems(stems)
    for inst in insts:
        assert nrmse(whole[inst], pn.normalize_audio(stems[inst], inst)) < 0.05


def test_comp_match_reads_the_channel_once_through_rows(setup, monkeypatch):
    """Every sweep launch gets the channel as one row [1, T] and 96 lanes
    that all read row 0; the final launch one lane."""
    feats, stems = setup
    seen = []
    orig = pcomp.compressor_envelope

    def spy(x, *params, rows=None):
        seen.append((tuple(x.shape), None if rows is None else rows.tolist()))
        return orig(x, *params, rows=rows)

    monkeypatch.setattr(pcomp, "compressor_envelope", spy)
    x = torch.from_numpy(np.pad(stems["drums"][0], 4096))
    pmatch.comp_match(x, -16.0, 1.0, 4.0, 20.0, 200.0)
    Tp = T + 2 * 4096
    assert seen[0] == ((1, Tp), [0] * 96) and seen[-1] == ((1, Tp), [0])


def test_kernel_failures_propagate_and_matching_failures_pass_through(setup, monkeypatch):
    """The compression stage swallows the matching's own failures (here an
    empty candidate grid: the channel passes unchanged, as JAX's swallowed
    IndexError leaves it); a failure of the envelope wrapper propagates."""
    feats, stems = setup
    x = stems["drums"]
    cfg = dict(comp_max_ratio=5.5)  # half a step below drums' ratio 6: no candidate
    pn = build(AudioEffectsNormalizer, NormalizationConfig, feats, **cfg)
    jn = build(JaxNormalizer, JaxNormCfg, feats, **cfg)
    got = pn.normalize_audio_per_effect(x, "drums", "compression")
    np.testing.assert_array_equal(got, x)
    close(got, jn.normalize_audio_per_effect(x, "drums", "compression"))
    with pytest.raises(pmatch.MatchingError):
        pmatch._comp_match_select(torch.from_numpy(x[0]), np.zeros(0, np.float32),
                                  np.zeros(0, np.float32), 20.0, 200.0, -16.0, 1.0, 44100, 75.0, "down")

    def broken(*args, **kwargs):
        raise RuntimeError("compressor_envelope: kernel launch failed with CUDA error 98")

    monkeypatch.setattr(pcomp, "compressor_envelope", broken)
    pn = build(AudioEffectsNormalizer, NormalizationConfig, feats)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pn.normalize_audio_per_effect(x, "drums", "compression")

