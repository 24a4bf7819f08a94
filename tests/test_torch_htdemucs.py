"""PyTorch port: HTDemucs separation (``models/htdemucs.py``) against its
plain reference (``models/htdemucs_reference.py``), on the CPU, at a tiny
size that keeps the published topology: depth 4 on both branches, no
collapsed-frequency layer, the channel samplers around all 5 transformer
layers (self, cross, self, cross, self), 0.5 s chunks.

There is no JAX counterpart: Demucs is the system's first stage, which the
reference pipeline runs as a separate program. Weights are the program's
seeded ones with every norm, layer scale and the frequency embedding
redrawn large (scales in [0.5, 1.5]), so that no layer hides under the
tolerance behind Demucs's 1e-4 and 1e-3 layer-scale inits.

Tolerance 1e-5 of each source's norm (float32; read ~1e-7): the two
compute the same float32 arithmetic in other orders (the program's STFT is
``rfft`` over framed windows where the reference calls ``torch.stft``, its
attention ``scaled_dot_product_attention`` where the reference writes the
softmax out, its chunks in batches), so they differ by rounding, which the
random network amplifies a few times over its depth.
"""
import os

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu_torch.config import (
    FXencoderConfig,
    InferenceConfig,
    TCNConfig,
)
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav_stereo_ct_i16, write_wav
from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
    MixingStyleTransfer,
    StyleTransferEngine,
)
from music_mixing_style_transfer_tpu_torch.models import htdemucs as port
from music_mixing_style_transfer_tpu_torch.models import htdemucs_reference as ref
from music_mixing_style_transfer_tpu_torch.ops.stft import demucs_ispec, demucs_spec

torch.set_num_threads(2)

TINY = dict(nfft=2048, channels=8, bottom_channels=16, t_heads=2, segment=0.5, batch=2)
TOL = 1e-5


def _separators(seed=3, **kw):
    """The program's separator and the reference model on one set of
    weights (norms, layer scales and the embedding redrawn large)."""
    sep = port.HTDemucsSeparator(port.HTDemucsConfig(**TINY, **kw), seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sep.model.named_parameters():
            if name.endswith(".scale") or ("norm" in name and name.endswith("weight")):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif "norm" in name and name.endswith("bias"):
                p.copy_(0.2 * torch.rand(p.shape, generator=g) - 0.1)
            elif name.startswith("freq_emb"):
                p.copy_(torch.randn(p.shape, generator=g) / 10)
    model = ref.HTDemucs(ref.HTDemucsConfig(**TINY, **kw))
    model.load_state_dict(sep.model.state_dict())
    return sep, model.eval()


def _nrmse(a, b):
    return float((a - b).norm() / b.norm())


def _mix(rng, T):
    return np.clip(rng.standard_normal((2, T)) * 6000, -32768, 32767).astype(np.int16)


def test_demucs_spectrogram_matches_torch_stft(rng):
    """``_spec``/``_ispec``'s framing: the port's ``rfft`` over reflect-padded
    frames against ``torch.stft``/``torch.istft``, at two sizes."""
    for T, nfft in ((22050, 2048), (5000, 1024)):
        x = torch.from_numpy(rng.standard_normal((3, 2, T)).astype(np.float32))
        z, z_ref = demucs_spec(x, nfft), ref.spec(x, nfft)
        assert z.shape == z_ref.shape == (3, 2, nfft // 2, -(-T // (nfft // 4)))
        assert _nrmse(z, z_ref) < 1e-6
        assert _nrmse(demucs_ispec(z_ref, T), ref.ispec(z_ref, nfft // 4, T)) < 1e-6


def test_a_batch_of_chunks_matches_the_reference_chunk_by_chunk(rng):
    sep, model = _separators()
    L = sep.cfg.segment_length
    x = torch.from_numpy(rng.standard_normal((2, 2, L)).astype(np.float32) * 0.3)
    with torch.no_grad():
        got = sep.model(x)
        want = torch.cat([model(x[i : i + 1]) for i in range(2)])
    assert got.shape == (2, 4, 2, L)
    for i in range(2):
        for s in range(4):
            assert _nrmse(got[i, s], want[i, s]) < TOL, (i, s)


def test_a_mixture_of_three_chunks_through_the_batched_overlap_add(rng):
    """Chunks at 0, 1 and 2 strides, the last one short (centred, zeros past
    the song), in dispatches of 2 and 1, overlap-added on the device, and
    the mixture's standardization undone; int16 in."""
    sep, model = _separators()
    T = 2 * sep.cfg.chunk_stride + sep.cfg.segment_length // 2
    mix = _mix(rng, T)
    got = sep.separate(mix)
    want = ref.separate(model, torch.from_numpy(mix))
    assert got.shape == want.shape == (4, 2, T) and got.dtype == torch.float32
    for s in range(4):
        assert _nrmse(got[s], want[s]) < TOL, s


def test_transfer_mix_pcm_is_separation_then_the_stem_path(tmp_path, rng):
    """``transfer_mix_pcm`` equals separating both mixtures and handing the
    stems to ``transfer_song_pcm``; ``run_directory`` with
    ``separation_model="htdemucs"`` reads the mixtures and writes the same
    int16 mixture; without a separator it raises."""
    sep, _ = _separators()
    engine = StyleTransferEngine(
        FXencoderConfig(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1)),
        TCNConfig(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7),
        device="cpu")
    cfg = InferenceConfig(segment_length=2048, segment_length_ref=2048, normalize_input=False,
                          do_not_separate=False, separation_model="htdemucs")
    pipe = MixingStyleTransfer(engine, cfg, separator=sep)
    assert pipe.separates_in_process()
    mix_in, mix_ref = _mix(rng, 26000), _mix(rng, 30000)
    got, stems = pipe.transfer_mix_pcm(mix_in, mix_ref, want_stems=True)
    want, want_stems = pipe.transfer_song_pcm(sep.separate(mix_in).numpy(),
                                              sep.separate(mix_ref).numpy(), want_stems=True)
    assert got.shape == (2, 26000) and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert all(np.array_equal(stems[i], want_stems[i]) for i in cfg.instruments)
    with pytest.raises(ValueError, match="needs a separator"):
        MixingStyleTransfer(engine, cfg).transfer_mix_pcm(mix_in, mix_ref)

    song = tmp_path / "songs" / "song0"
    song.mkdir(parents=True)
    for name, m in (("input", mix_in), ("reference", mix_ref)):
        write_wav(str(song / f"{name}.wav"), m.T, 44100)
    (written,) = pipe.run_directory(str(tmp_path / "songs"), str(tmp_path / "out"))
    assert os.path.basename(written) == "mixture_output_notnormed.wav"
    np.testing.assert_array_equal(read_wav_stereo_ct_i16(written), want)


def test_parameters_carry_demucs_names():
    """At the published sizes (on the meta device): the program's and the
    reference's state dicts have the same names and shapes, Demucs's."""
    with torch.device("meta"):
        prog = port.HTDemucs(port.HTDemucsConfig()).state_dict()
        plain = ref.HTDemucs(ref.HTDemucsConfig()).state_dict()
    assert {k: v.shape for k, v in prog.items()} == {k: v.shape for k, v in plain.items()}
    for name, shape in {
        "encoder.0.conv.weight": (48, 4, 8, 1),
        "encoder.0.dconv.layers.1.0.weight": (6, 48, 3),
        "encoder.0.dconv.layers.1.6.scale": (48,),
        "tencoder.3.rewrite.weight": (768, 384, 1),
        "decoder.0.rewrite.weight": (768, 384, 3, 3),
        "decoder.3.conv_tr.weight": (48, 16, 8, 1),
        "tdecoder.3.conv_tr.weight": (48, 8, 8),
        "freq_emb.embedding.weight": (512, 48),
        "channel_upsampler.weight": (512, 384, 1),
        "channel_downsampler_t.weight": (384, 512, 1),
        "crosstransformer.norm_in_t.weight": (512,),
        "crosstransformer.layers.0.self_attn.in_proj_weight": (1536, 512),
        "crosstransformer.layers_t.1.cross_attn.out_proj.weight": (512, 512),
        "crosstransformer.layers.3.norm3.weight": (512,),
        "crosstransformer.layers_t.4.linear1.weight": (2048, 512),
        "crosstransformer.layers.4.norm_out.bias": (512,),
        "crosstransformer.layers_t.2.gamma_2.scale": (512,),
    }.items():
        assert tuple(prog[name].shape) == shape, name
    assert not any(k.startswith("decoder") and ".dconv." in k for k in prog)  # dconv_mode 1
    assert not any(".norm1." in k for k in prog if k.split(".")[0] in ("encoder", "decoder"))
    assert 41e6 < sum(v.numel() for v in prog.values()) < 42e6


def test_settings_outside_the_published_topology_raise(tmp_path):
    """A depth that reaches the collapsed-frequency layer (``last_freq``)
    raises in both; so does a transformer width that is not a positive
    multiple of 4 and of the heads (no channel samplers at 0). A
    checkpoint packed as Demucs packs one loads by name."""
    for mod in (port, ref):
        with pytest.raises(ValueError, match="last_freq"):
            mod.HTDemucs(mod.HTDemucsConfig(**dict(TINY, depth=5)))
    for width in (0, 18):
        with pytest.raises(ValueError, match="transformer width"):
            port.HTDemucs(port.HTDemucsConfig(**dict(TINY, bottom_channels=width)))
    sep, _ = _separators(seed=5)
    path = str(tmp_path / "htdemucs.pt")
    torch.save({"state": sep.model.state_dict()}, path)
    loaded = port.HTDemucsSeparator(sep.cfg, ckpt=path, seed=6, device="cpu")
    assert all(torch.equal(v, sep.model.state_dict()[k])
               for k, v in loaded.model.state_dict().items())
