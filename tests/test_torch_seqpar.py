"""PyTorch port: multi-device inference on meshes of CPU entries against
the JAX package's mesh engine and ``infer/seqpar.py`` on the 8-device CPU
mesh.

The converter has a 128-channel block of dilation 8 and kernel 15 (the
4-block ``TCNConfig``: dilations 1, 2, 4, 8), so the sequence-parallel
path runs K1's wrapper (its plain version on the CPU) on the halo'd chunks,
as on the card. Tolerances: the time-sharded forward within 1e-5 of
max|single forward| of the port, and within 1e-4 of JAX's
``make_seq_parallel_converter``; int16 mixtures (data-parallel and
sequence-parallel ``transfer_song_pcm``, the server's ``/transfer``)
within 1 LSB of the single-device run and of the JAX mesh engine (float32
rounding can put a sample across a quantization step).
"""
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from music_mixing_style_transfer_tpu.config import FXencoderConfig as JEncCfg
from music_mixing_style_transfer_tpu.config import InferenceConfig as JInfCfg
from music_mixing_style_transfer_tpu.config import TCNConfig as JTcnCfg
from music_mixing_style_transfer_tpu.infer.pipeline import MixingStyleTransfer as JaxMST
from music_mixing_style_transfer_tpu.infer.pipeline import StyleTransferEngine as JaxEngine
from music_mixing_style_transfer_tpu.infer.seqpar import make_seq_parallel_converter as j_seqpar
from music_mixing_style_transfer_tpu.models import MixFXcloner as JMixFXcloner
from music_mixing_style_transfer_tpu.models.fast_init import fast_init as j_fast_init
from music_mixing_style_transfer_tpu.parallel import create_mesh as j_create_mesh
from music_mixing_style_transfer_tpu_torch import serve as pserve
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, InferenceConfig, TCNConfig
from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav, write_wav
from music_mixing_style_transfer_tpu_torch.infer.pipeline import MixingStyleTransfer, StyleTransferEngine
from music_mixing_style_transfer_tpu_torch.infer.seqpar import (
    convert_seq_parallel,
    make_seq_parallel_converter,
    max_halo,
)
from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
from music_mixing_style_transfer_tpu_torch.models.weights import fxencoder_from_jax, mixfxcloner_from_jax
from music_mixing_style_transfer_tpu_torch.parallel import create_mesh

torch.set_num_threads(2)
ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=4, kernel_size=15)  # width 128, dilations 1, 2, 4, 8
SERVE_TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)  # 2^19 segments
T_SEG = 2048
INSTS = ("drums", "bass", "other", "vocals")


def _cpu_mesh(n):
    return create_mesh(n, ["cpu"] * n)


def _pcm(rng, T):
    return (rng.standard_normal((4, 2, T)) * 8000).astype(np.int16)


@pytest.fixture(scope="module")
def converter():
    """JAX's channels-last converter with seeded weights, and the port's
    with the same weights (eval mode)."""
    cfg = JTcnCfg(**TCN)
    jmodel = JMixFXcloner(config=cfg, channels_last=True)
    variables = j_fast_init(jmodel, jnp.zeros((1, 2, 1024)), jnp.zeros((1, 16)))
    model = MixFXcloner(TCNConfig(**TCN))
    model.load_state_dict(mixfxcloner_from_jax(variables))
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_matches_single_forward_and_jax(converter, n):
    jmodel, variables, model = converter
    assert max_halo(model.config) == 56 and model.blocks[3].uses_kernel()
    rng = np.random.default_rng(n)
    B, T = 2, 1024
    x = (rng.standard_normal((B, 2, T)) * 0.3).astype(np.float32)
    cond = rng.standard_normal((B, 16)).astype(np.float32)
    with torch.inference_mode():
        single = model(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    fn = make_seq_parallel_converter(model, _cpu_mesh(n))
    got = fn(torch.from_numpy(np.swapaxes(x, 1, 2).copy()), torch.from_numpy(cond))
    got = np.swapaxes(got.numpy(), 1, 2)
    scale = float(np.abs(single).max())
    assert float(np.abs(got - single).max()) <= 1e-5 * scale

    mesh = j_create_mesh(n)
    xd = jax.device_put(jnp.asarray(np.swapaxes(x, 1, 2)), NamedSharding(mesh, P(None, "data", None)))
    want = np.swapaxes(np.asarray(j_seqpar(JTcnCfg(**TCN), mesh)(variables, xd, jnp.asarray(cond))), 1, 2)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


@pytest.fixture(scope="module")
def engines():
    """Mesh engines of both packages with the same weights (JAX's seeded
    ones carried into the port), keyed by the mesh size (1: no mesh)."""
    out = {}
    for n in (1, 2, 4):
        jeng = JaxEngine(encoder_cfg=JEncCfg(**ENC), converter_cfg=JTcnCfg(**TCN), seed=2,
                         mesh=None if n == 1 else j_create_mesh(n))
        eng = StyleTransferEngine(FXencoderConfig(**ENC), TCNConfig(**TCN), device="cpu",
                                  mesh=None if n == 1 else _cpu_mesh(n))
        eng.encoder.load_state_dict(fxencoder_from_jax(jeng.enc_vars))
        eng.converter.load_state_dict(mixfxcloner_from_jax(jeng.conv_vars))
        out[n] = (jeng, eng)
    return out


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_engine_convert_seq_parallel_matches_one_forward(engines):
    """Twin of JAX ``test_engine_convert_seq_parallel``: a length that no
    shard count divides, padded and cut back, equals one forward over the
    padded span."""
    eng = engines[4][1]
    rng = np.random.default_rng(1)
    T = 4 * 300 + 13
    audio = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    emb = rng.standard_normal(16).astype(np.float32)
    out = convert_seq_parallel(eng, audio, emb)
    assert out.shape == (2, T) and np.isfinite(out).all()
    T_loc = max(-(-T // 4), max_halo(eng.converter_cfg))
    xb = np.pad(audio, ((0, 0), (0, T_loc * 4 - T)))[None]
    with torch.inference_mode():
        ref = eng.converter(torch.from_numpy(xb), torch.from_numpy(emb)[None])[0, :, :T].numpy()
    assert float(np.abs(out - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    # a chunk shorter than the widest block's halo (56 frames) is refused
    with pytest.raises(ValueError, match="shorter than block 3 halo 56"):
        make_seq_parallel_converter(eng.converter, _cpu_mesh(4))(torch.zeros(1, 4 * 40, 2),
                                                                 torch.zeros(1, 16))


def test_pcm_path_sequence_parallel_matches_segments_and_jax(engines):
    """Twin of JAX ``test_pcm_path_sequence_parallel_matches_segments``, on
    meshes of 2 and 4 CPU entries: a one-segment song (no boundary to
    remove) through the PCM path with ``sequence_parallel`` equals the
    segment-batched conversion within 1 LSB, and the JAX mesh engine's
    sequence-parallel mixture within 1 LSB."""
    icfg = dict(segment_length=T_SEG, segment_length_ref=T_SEG, normalize_input=False)
    rng = np.random.default_rng(5)
    inp, ref = _pcm(rng, T_SEG), _pcm(rng, T_SEG)
    for n in (2, 4):
        jeng, eng = engines[n]
        mix_seg, _ = MixingStyleTransfer(eng, InferenceConfig(**icfg)).transfer_song_pcm(inp, ref)
        mix_sp, _ = MixingStyleTransfer(eng, InferenceConfig(**icfg, sequence_parallel=True)
                                        ).transfer_song_pcm(inp, ref)
        assert mix_sp.shape == mix_seg.shape == (2, T_SEG)
        assert _lsb(mix_sp, mix_seg) <= 1, n
        want, _ = JaxMST(jeng, JInfCfg(**icfg, sequence_parallel=True)).transfer_song_pcm(inp, ref)
        assert _lsb(mix_sp, np.asarray(want)) <= 1, n


def test_data_parallel_pcm_path_matches_single_device_and_jax(engines):
    icfg = dict(segment_length=T_SEG, segment_length_ref=T_SEG, normalize_input=False)
    rng = np.random.default_rng(6)
    inp, ref = _pcm(rng, 3 * T_SEG - 300), _pcm(rng, 5 * T_SEG)  # 12 segments: 8 a shard after the bucket
    single, _ = MixingStyleTransfer(engines[1][1], InferenceConfig(**icfg)).transfer_song_pcm(inp, ref)
    jeng, eng = engines[2]
    got, stems = MixingStyleTransfer(eng, InferenceConfig(**icfg)).transfer_song_pcm(inp, ref, want_stems=True)
    want, _ = JaxMST(jeng, JInfCfg(**icfg)).transfer_song_pcm(inp, ref)
    assert got.shape == (2, inp.shape[-1]) and set(stems) == set(INSTS)
    assert _lsb(got, single) <= 1 and _lsb(got, np.asarray(want)) <= 1
    assert eng._pad_bucket(12) == 16 and engines[4][1]._pad_bucket(3) == 4 and eng._pad_bucket(1) == 2


def _song(root, rng, T=12_000):
    for name in ("input", "reference"):
        for inst in INSTS:
            write_wav(str(root / "s1" / "separated" / name / f"{inst}.wav"),
                      (rng.standard_normal((T, 2)) * 0.2).astype(np.float32), 44100)
    return str(root) + "/"


@pytest.mark.parametrize("argv", [[], ["--sequence_parallel"]], ids=["data_parallel", "sequence_parallel"])
def test_server_with_data_parallel_answers_transfer(monkeypatch, tmp_path, argv):
    """``serve.main --data_parallel 2 --inference_device cpu`` builds a
    mesh of 2 CPU entries and answers ``/transfer`` (the small configs in
    place of the published widths): the mixture within 1 LSB of the
    single-device engine's ``run_directory``; with ``--sequence_parallel``
    byte-equal to the same engine's in-process run (one boundary-free
    forward a stem, which the segmented single device does not compute)."""
    made, started, serve_once = [], threading.Event(), pserve.serve

    def engine(**kw):
        made.append(StyleTransferEngine(FXencoderConfig(**ENC), TCNConfig(**SERVE_TCN), **kw))
        return made[-1]

    def serve(service, port, host):
        httpd = serve_once(service, 0, host)
        made.append(httpd)
        started.set()
        return httpd

    monkeypatch.setattr(pserve, "StyleTransferEngine", engine)
    monkeypatch.setattr(pserve, "serve", serve)
    main = threading.Thread(target=pserve.main, args=(
        ["--data_parallel", "2", "--inference_device", "cpu", "--dtype", "float32", *argv],), daemon=True)
    main.start()
    assert started.wait(120)
    eng, httpd = made
    try:
        assert eng.mesh.size == 2 and eng.mesh.distinct == (torch.device("cpu"),)
        target = _song(tmp_path / "songs", np.random.default_rng(8))
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/transfer",
            data=json.dumps({"target_dir": target, "output_dir": str(tmp_path / "out") + "/"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            (written,) = json.loads(r.read())["written"]
    finally:
        httpd.shutdown()
        main.join(60)
    assert not main.is_alive()
    got, _ = read_wav(written)
    cfg = InferenceConfig(do_not_separate=True, normalize_input=False, dtype="float32",
                          sequence_parallel=bool(argv))
    if argv:  # the same mesh engine in this process: the same bytes
        want_eng = eng
    else:  # segment-batched: the single device's numbers
        want_eng = StyleTransferEngine(FXencoderConfig(**ENC), TCNConfig(**SERVE_TCN),
                                       device="cpu")
    (want_path,) = MixingStyleTransfer(want_eng, cfg).run_directory(target, str(tmp_path / "want") + "/")
    want, _ = read_wav(want_path)
    assert got.shape == want.shape == (12_000, 2) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= (0.0 if argv else 1.0 / 32768 + 1e-9)
