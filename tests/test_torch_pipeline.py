"""PyTorch port: the whole-song pipeline, checkpoints and CLI vs the JAX
package, on the CPU, with small configs.

The converter is 128 wide with 4 blocks, so block 3 (d = 8) takes the fused
block's dispatch (its plain version on the CPU). Both engines hold the same
weights (the JAX engine's random ones, carried across). The int16 mixtures
may differ by 1 LSB, where float32 rounding puts a sample on the other side
of a quantization step.
"""
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import (
    FXencoderConfig as JaxEncCfg,
    InferenceConfig as JaxInfCfg,
    NormalizationConfig as JaxNormCfg,
    TCNConfig as JaxTCNCfg,
)
from music_mixing_style_transfer_tpu.infer.pipeline import (
    MixingStyleTransfer as JaxMST,
    StyleTransferEngine as JaxEngine,
)
from music_mixing_style_transfer_tpu.models import FXencoder as JaxFXencoder
from music_mixing_style_transfer_tpu.models import MixFXcloner as JaxMixFXcloner
from music_mixing_style_transfer_tpu.normalize.normalizer import (
    AudioEffectsNormalizer as JaxNormalizer,
)
from music_mixing_style_transfer_tpu.models.torch_import import (
    fxencoder_from_torch,
    load_torch_state_dict as jax_load_torch_state_dict,
    mixfxcloner_from_torch,
)
from music_mixing_style_transfer_tpu_torch.config import (
    FXencoderConfig,
    InferenceConfig,
    NormalizationConfig,
    TCNConfig,
)
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav_stereo_ct, write_wav
from music_mixing_style_transfer_tpu_torch.infer import pipeline as port_pipeline
from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
    MixingStyleTransfer,
    StyleTransferEngine,
    separate_with_demucs,
)
from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
from music_mixing_style_transfer_tpu_torch.models.checkpoints import load_model_state
from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
from music_mixing_style_transfer_tpu_torch.models.weights import (
    fxencoder_from_jax,
    mixfxcloner_from_jax,
)
from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer

torch.set_num_threads(2)

ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=4, channel_width=128)
INSTS = ("drums", "bass")
L = 2048
SR = 44100


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(encoder_cfg=JaxEncCfg(**ENC), converter_cfg=JaxTCNCfg(**TCN), seed=11)
    eng = StyleTransferEngine(
        encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN), device="cpu"
    )
    eng.encoder.load_state_dict(fxencoder_from_jax(jax_eng.enc_vars))
    eng.converter.load_state_dict(mixfxcloner_from_jax(jax_eng.conv_vars))
    assert [n for n, b in enumerate(eng.converter.blocks) if b.uses_kernel()] == [3]
    return jax_eng, eng


# FX normalization at a small size: fft_size 32768 pads every stem past the
# 65,536 samples of the spectral K-weighting; a small candidate grid keeps
# the compression sweep short
NORM = dict(fft_size=32768, hop_length=8192, ntaps=101, comp_min_th=-20.0, comp_max_ratio=5,
            stems=INSTS)


@pytest.fixture(scope="module")
def normalizers(tmp_path_factory):
    """The JAX and the port normalizer on one synthetic feature file."""
    rng = np.random.default_rng(21)
    bins = NORM["fft_size"] // 2 + 1
    feats = {
        "eq": {i: np.abs(rng.standard_normal(bins)) * 0.05 + np.geomspace(1.0, 0.01, bins)
               for i in INSTS},
        "compression": {i: np.asarray([-16.0, 1.0]) for i in INSTS},
        "imager": {i: rng.uniform(0.05, 0.3) for i in INSTS},
        "loudness": {i: np.asarray([-22.0]) for i in INSTS},
    }
    path = str(tmp_path_factory.mktemp("feat") / "features.npy")
    np.save(path, feats, allow_pickle=True)
    return (
        JaxNormalizer(path, JaxNormCfg(**NORM)),
        AudioEffectsNormalizer(path, NormalizationConfig(**NORM), device="cpu"),
    )


def _pcm(rng, S, T, scale=0.3):
    return np.clip(rng.standard_normal((S, 2, T)) * scale * 32768, -32768, 32767).astype(np.int16)


def _cfgs(**kw):
    common = dict(segment_length=L, segment_length_ref=L, instruments=INSTS, **kw)
    return JaxInfCfg(**common), InferenceConfig(**common)


@pytest.mark.parametrize(
    "T,Tr,interp",
    [
        (3000, 3000, False),   # reference <= 2L: encoded whole, bucketed to 4096
        (5000, 6000, False),   # reference > 2L: segmented, grouped mean
        (3000, 6000, True),    # interpolation mode, reference B <= 2L
    ],
)
def test_transfer_song_pcm_matches_jax(engines, rng, T, Tr, interp):
    jax_eng, eng = engines
    jcfg, cfg = _cfgs(interpolate_segments=3)
    x, ref = _pcm(rng, 2, T), _pcm(rng, 2, Tr)
    ref_b = _pcm(rng, 2, 2500) if interp else None
    want, want_stems = JaxMST(jax_eng, jcfg).transfer_song_pcm(
        x, ref, want_stems=True, reference_pcm_b=ref_b
    )
    got, got_stems = MixingStyleTransfer(eng, cfg).transfer_song_pcm(
        x, ref, want_stems=True, reference_pcm_b=ref_b
    )
    assert got.dtype == np.int16 and got.shape == (2, T)
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert np.abs(got).max() > 0
    for inst in INSTS:
        assert np.abs(got_stems[inst].astype(np.int32) - want_stems[inst]).max() <= 1


@pytest.mark.parametrize("interp", [False, True])
def test_normalized_transfer_song_pcm_matches_jax(engines, normalizers, rng, interp):
    """FX normalization on the device path, before the plain and the
    interpolation dispatch: int16 mixtures within 1 LSB."""
    jax_eng, eng = engines
    jnorm, norm = normalizers
    jcfg, cfg = _cfgs(interpolate_segments=3)
    x, ref = _pcm(rng, 2, 3000, 0.2), _pcm(rng, 2, 3000)
    ref_b = _pcm(rng, 2, 2500) if interp else None
    want, _ = JaxMST(jax_eng, jcfg, normalizer=jnorm).transfer_song_pcm(
        x, ref, reference_pcm_b=ref_b
    )
    got, _ = MixingStyleTransfer(eng, cfg, normalizer=norm).transfer_song_pcm(
        x, ref, reference_pcm_b=ref_b
    )
    plain, _ = MixingStyleTransfer(eng, cfg).transfer_song_pcm(x, ref, reference_pcm_b=ref_b)
    assert got.dtype == np.int16 and got.shape == (2, 3000)
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert np.abs(got.astype(np.int32) - plain).max() > 100  # normalization ran
    assert norm.batched().last_compression is not None


def test_normalized_transfer_stems_matches_jax(engines, normalizers, rng):
    jax_eng, eng = engines
    jnorm, norm = normalizers
    jcfg, cfg = _cfgs()
    x = {i: (rng.standard_normal((2, 2500)) * 0.2).astype(np.float32) for i in INSTS}
    ref = {i: (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32) for i in INSTS}
    want, _ = JaxMST(jax_eng, jcfg, normalizer=jnorm).transfer_stems(x, ref)
    got, _ = MixingStyleTransfer(eng, cfg, normalizer=norm).transfer_stems(x, ref)
    assert got.shape == (2, 2500)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_transfer_stems_takes_a_per_channel_normalizer(engines, rng):
    """A normalizer with ``normalize_audio`` only (no ``normalize_stems``)
    is called stem by stem, in both packages, and its output is clipped."""

    class PerStem:
        def __init__(self):
            self.calls = []

        def normalize_audio(self, x, src):
            self.calls.append(src)
            return x * 3.0

    jax_eng, eng = engines
    jcfg, cfg = _cfgs()
    x = {i: (rng.standard_normal((2, 2500)) * 0.2).astype(np.float32) for i in INSTS}
    ref = {i: (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32) for i in INSTS}
    jnorm, norm = PerStem(), PerStem()
    want, _ = JaxMST(jax_eng, jcfg, normalizer=jnorm).transfer_stems(x, ref)
    got, _ = MixingStyleTransfer(eng, cfg, normalizer=norm).transfer_stems(x, ref)
    assert norm.calls == jnorm.calls == list(INSTS)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain, _ = MixingStyleTransfer(eng, cfg).transfer_stems(x, ref)
    assert np.abs(got - plain).max() > 1e-3  # the normalizer's output was used


def test_engine_runs_full_float32_whatever_the_process_flags(engines, rng):
    """The engine turns TF32 off in its own forward passes (a CLI user gets
    the float32 asked for) and restores the process-wide flags afterwards."""
    _, eng = engines

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    seen = []
    handles = [
        m.register_forward_hook(lambda m, args, out: seen.append(flags()))
        for m in (eng.encoder, eng.converter)
    ]
    prev = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        MixingStyleTransfer(eng, _cfgs()[1]).transfer_song_pcm(_pcm(rng, 2, 3000), _pcm(rng, 2, 3000))
        after = flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        for h in handles:
            h.remove()
    assert seen == [(False, False), (False, False)]
    assert after == (True, True)


def test_host_path_transfer_stems_matches_jax(engines, rng):
    jax_eng, eng = engines
    jcfg, cfg = _cfgs()
    x = {i: (rng.standard_normal((2, 2500)) * 0.2).astype(np.float32) for i in INSTS}
    ref = {
        "drums": (rng.standard_normal((2, 5000)) * 0.2).astype(np.float32),  # > 2L
        "bass": (rng.standard_normal((2, 1500)) * 0.2).astype(np.float32),  # <= 2L
    }
    want, _ = JaxMST(jax_eng, jcfg).transfer_stems(x, ref)
    got, stems = MixingStyleTransfer(eng, cfg).transfer_stems(x, ref)
    assert got.shape == (2, 2500) and set(stems) == set(INSTS)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("halo", [0, 512])
def test_embed_and_convert_song_match_jax(engines, rng, halo):
    jax_eng, eng = engines
    x = (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32)
    ref = (rng.standard_normal((2, 1000)) * 0.2).astype(np.float32)
    emb = eng.embed_song(ref, L)
    np.testing.assert_allclose(emb, jax_eng.embed_song(ref, L), rtol=1e-4, atol=1e-4)
    got = eng.convert_song(x, emb, L, halo=halo)
    want = jax_eng.convert_song(x, emb, L, halo=halo)
    assert got.shape == (2, 3000)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pt_checkpoint_loads_into_both_packages(tmp_path, rng):
    """A reference-style .pt: state dict under "model" with DDP prefixes."""
    enc = fast_init(FXencoder(FXencoderConfig(**ENC)), seed=1).eval()
    conv = fast_init(MixFXcloner(TCNConfig(**TCN)), seed=2).eval()
    paths = {}
    for name, m in (("enc", enc), ("conv", conv)):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save(
            {"model": {"module." + k: v for k, v in m.state_dict().items()}, "epoch": 3},
            paths[name],
        )
    x = (rng.standard_normal((2, 2, 2048)) * 0.3).astype(np.float32)
    cond = (rng.standard_normal((2, 16)) * 0.5).astype(np.float32)

    jenc = fxencoder_from_torch(jax_load_torch_state_dict(paths["enc"]), n_blocks=2)
    jconv = mixfxcloner_from_torch(jax_load_torch_state_dict(paths["conv"]), n_blocks=4)
    want_e = np.asarray(JaxFXencoder(config=JaxEncCfg(**ENC)).apply(jenc, jnp.asarray(x)))
    want_c = np.asarray(
        JaxMixFXcloner(config=JaxTCNCfg(**TCN)).apply(jconv, jnp.asarray(x), jnp.asarray(cond))
    )

    eng = StyleTransferEngine(
        encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN),
        ckpt_path_enc=paths["enc"], ckpt_path_conv=paths["conv"], device="cpu",
    )
    with torch.no_grad():
        got_e = eng.encoder(torch.from_numpy(x)).numpy()
        got_c = eng.converter(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
        direct = load_model_state(paths["conv"], MixFXcloner(TCNConfig(**TCN)).eval())
        torch.testing.assert_close(direct(torch.from_numpy(x), torch.from_numpy(cond)),
                                   torch.from_numpy(got_c))
    np.testing.assert_allclose(got_e, want_e, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-4)


def test_orbax_directories_raise_not_yet_ported(tmp_path):
    (tmp_path / "variables").mkdir()
    # read by JAX only: it raises, with the recipe that exports it to an .npz
    with pytest.raises(ValueError, match="orbax checkpoint directory.*flatten_dict"):
        load_model_state(str(tmp_path), MixFXcloner(TCNConfig(**TCN)))
    with pytest.raises(FileNotFoundError):
        load_model_state(str(tmp_path / "missing"), MixFXcloner(TCNConfig(**TCN)))


def test_from_jax_round_trips(engines):
    jax_eng, _ = engines
    for from_jax, from_torch, variables, n in (
        (fxencoder_from_jax, fxencoder_from_torch, jax_eng.enc_vars, 2),
        (mixfxcloner_from_jax, mixfxcloner_from_torch, jax_eng.conv_vars, 4),
    ):
        back = from_torch({k: v.numpy() for k, v in from_jax(variables).items()}, n_blocks=n)
        flat_a = jax_flatten(variables)
        flat_b = jax_flatten(back)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k])


def jax_flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_normalization_is_refused_not_skipped(engines, rng):
    """FX normalization, once refused, now runs: a normalizer with
    ``normalize_input`` is called on both paths and never skipped; with
    normalization off it is accepted and unused, as in JAX."""
    _, eng = engines

    class Spy:
        def __init__(self):
            self.calls = []

        def normalize_stems(self, stems):
            self.calls.append(sorted(stems))
            return {i: v * 0.5 for i, v in stems.items()}

    spy = Spy()
    _, cfg = _cfgs()
    x = {i: (rng.standard_normal((2, 2500)) * 0.2).astype(np.float32) for i in INSTS}
    MixingStyleTransfer(eng, cfg, normalizer=spy).transfer_stems(x, x)
    assert spy.calls == [sorted(INSTS)]
    _, off = _cfgs(normalize_input=False)
    MixingStyleTransfer(eng, off, normalizer=object()).transfer_stems(x, x)


def _write_song(root, rng, T, names=("input", "reference")):
    for name in names:
        for inst in INSTS:
            x = (rng.standard_normal((T, 2)) * 0.2).astype(np.float32)
            write_wav(str(root / "separated" / name / f"{inst}.wav"), x, SR)


def test_cli_writes_mixture_on_cpu(tmp_path, rng):
    """With its defaults, the CLI FX-normalizes (--normalize_input true, the
    port's own feature file, the default NormalizationConfig) and writes
    mixture_output.wav; with --normalize_input false, the _notnormed one."""
    from music_mixing_style_transfer_tpu_torch.infer.style_transfer import main

    _write_song(tmp_path / "song0", rng, 1500)
    argv = [
        "--target_dir", str(tmp_path) + "/", "--do_not_separate", "true",
        "--segment_length", "2048", "--segment_length_ref", "2048",
        "--instruments", *INSTS, "--inference_device", "cpu",
    ]
    assert main(argv) == 0
    assert main(argv + ["--normalize_input", "false"]) == 0
    normed = read_wav_stereo_ct(str(tmp_path / "song0" / "mixture_output.wav"))
    y = read_wav_stereo_ct(str(tmp_path / "song0" / "mixture_output_notnormed.wav"))
    for a in (normed, y):
        assert a.shape == (2, 1500) and np.isfinite(a).all() and np.abs(a).max() > 0


def test_run_directory_interpolation_and_stems(engines, tmp_path, rng):
    _, eng = engines
    _write_song(tmp_path / "a", rng, 3000, names=("input", "reference", "reference_B"))
    cfg = InferenceConfig(
        segment_length=L, segment_length_ref=L, instruments=INSTS, do_not_separate=True,
        normalize_input=False, interpolation=True, interpolate_segments=3,
        save_each_inst=True,
    )
    written = MixingStyleTransfer(eng, cfg).run_directory(str(tmp_path))
    assert [os.path.basename(p) for p in written] == [
        "mixture_output_notnormed_interpolation.wav"
    ]
    for inst in INSTS:
        assert (tmp_path / "a" / f"{inst}_output_notnormed_interpolation.wav").exists()


@pytest.mark.parametrize(
    "T,discard_last", [(0, False), (4096, False), (5000, False), (5000, True)]
)
def test_segments_and_wavio_match_jax(tmp_path, rng, T, discard_last):
    """The port's own copies of the numpy data modules give the JAX
    package's arrays and files, byte for byte."""
    from music_mixing_style_transfer_tpu.data import segments as jseg
    from music_mixing_style_transfer_tpu.data import wavio as jwav
    from music_mixing_style_transfer_tpu_torch.data import segments as pseg
    from music_mixing_style_transfer_tpu_torch.data import wavio as pwav

    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    got, want = pseg.segment_song(x, L, discard_last), jseg.segment_song(x, L, discard_last)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(
        pseg.reassemble_song(got[0], T), jseg.reassemble_song(want[0], T)
    )
    np.testing.assert_array_equal(pseg.pad_to_batches(got[0], 4)[0],
                                  jseg.pad_to_batches(want[0], 4)[0])
    np.testing.assert_array_equal(pseg.segment_song_halo(x, L, 100),
                                  jseg.segment_song_halo(x, L, 100))

    pwav.write_wav(str(tmp_path / "p.wav"), x.T, SR)
    jwav.write_wav(str(tmp_path / "j.wav"), x.T, SR)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(pwav.read_wav_stereo_ct_i16(str(tmp_path / "p.wav")),
                                  jwav.read_wav_stereo_ct_i16(str(tmp_path / "j.wav")))
    np.testing.assert_array_equal(pwav.read_wav_stereo_ct(str(tmp_path / "p.wav")),
                                  jwav.read_wav_stereo_ct(str(tmp_path / "j.wav")))


def test_separate_with_demucs_argv_and_missing_binary(monkeypatch):
    calls = []
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="demucs CLI not found"):
        separate_with_demucs("/x/song.wav", "/x/separated")

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/demucs")
    monkeypatch.setattr(subprocess, "run", lambda argv, check: calls.append((argv, check)))
    separate_with_demucs("/x/song.wav", "/x/separated", model="mdx_extra", device="cpu")
    assert calls == [
        (["demucs", "/x/song.wav", "-n", "mdx_extra", "-d", "cpu", "-o", "/x/separated"], True)
    ]
    assert port_pipeline._bucket(5) == 8 and port_pipeline._bucket(129) == 256
