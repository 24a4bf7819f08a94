"""PyTorch port: feature extraction, evaluation, the inference profiler and
the profiling helpers vs the JAX package, on the CPU.

Tolerances: embeddings within 1e-4 of max|jax| (the FXencoder in float32,
convolutions summed in another order); the evaluation report metric by
metric within 1e-6 relative (the same numpy and scipy code; the K-weighting
coefficients come from the port's float32 design, equal to JAX's); the
profiler reports every key of the JAX tool's JSON line.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import (
    FXencoderConfig as JaxEncCfg,
    TCNConfig as JaxTCNCfg,
)
from music_mixing_style_transfer_tpu.infer import feature_extraction as jfe
from music_mixing_style_transfer_tpu.infer.pipeline import StyleTransferEngine as JaxEngine
from music_mixing_style_transfer_tpu.tools import evaluate as jeval
from music_mixing_style_transfer_tpu_torch.config import (
    FXencoderConfig,
    NormalizationConfig,
    TCNConfig,
)
from music_mixing_style_transfer_tpu_torch.data.wavio import write_wav
from music_mixing_style_transfer_tpu_torch.infer import feature_extraction as pfe
from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine
from music_mixing_style_transfer_tpu_torch.metrics import integrated_loudness_np
from music_mixing_style_transfer_tpu_torch.models.weights import (
    fxencoder_from_jax,
    mixfxcloner_from_jax,
)
from music_mixing_style_transfer_tpu_torch.tools import evaluate as peval
from music_mixing_style_transfer_tpu_torch.tools import infer_prof
from music_mixing_style_transfer_tpu_torch.utils import profiling
from music_mixing_style_transfer_tpu_torch.utils.logging import RTFMeter, Timer

torch.set_num_threads(2)
SR = 44100
ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)


def _tone(seconds, freq, gain, pan=0.5, seed=0):
    n = np.arange(int(SR * seconds)) / SR
    x = gain * np.sin(2 * np.pi * freq * n).astype(np.float32)
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(n)).astype(np.float32)
    return np.stack([x * (1 - pan), x * pan], axis=1)


def test_feature_extraction_writes_the_jax_embeddings(tmp_path, rng, monkeypatch):
    """Both CLIs over one directory tree, on the same weights: the same
    files, embeddings within 1e-4 of max|jax|."""
    jax_eng = JaxEngine(encoder_cfg=JaxEncCfg(**ENC), converter_cfg=JaxTCNCfg(**TCN), seed=3)
    eng = StyleTransferEngine(
        encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN), device="cpu"
    )
    eng.encoder.load_state_dict(fxencoder_from_jax(jax_eng.enc_vars))
    eng.converter.load_state_dict(mixfxcloner_from_jax(jax_eng.conv_vars))
    asked = []

    def port_engine(**kw):
        asked.append(kw)
        return eng

    monkeypatch.setattr(pfe, "StyleTransferEngine", port_engine)
    monkeypatch.setattr(jfe, "StyleTransferEngine", lambda **kw: jax_eng)
    src = tmp_path / "wavs"
    write_wav(str(src / "a.wav"), (rng.standard_normal((30_000, 2)) * 0.2).astype(np.float32), SR)
    write_wav(str(src / "sub" / "b.wav"), (rng.standard_normal((9_000, 2)) * 0.3).astype(np.float32), SR)
    common = ["--target_dir", str(src), "--segment_length", "8192"]
    assert pfe.main(common + ["--output_dir", str(tmp_path / "port"), "--inference_device", "cpu"]) == 0
    assert jfe.main(common + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert asked[0]["device"] == "cpu" and asked[0]["dtype"] == "float32"
    for rel in ("a_fx_embedding.npy", os.path.join("sub", "b_fx_embedding.npy")):
        got, want = np.load(tmp_path / "port" / rel), np.load(tmp_path / "jax" / rel)
        assert got.shape == want.shape == (ENC["channels"][-1],)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_evaluate_report_matches_jax(tmp_path):
    paths = {}
    for name, x in (("ref", _tone(3.0, 220, 0.4, pan=0.45)),
                    ("out", _tone(3.0, 1760, 0.1, pan=0.8, seed=2))):
        paths[name] = str(tmp_path / f"{name}.wav")
        write_wav(paths[name], x, SR)
    got = peval.evaluate_pair(paths["out"], paths["ref"], SR)
    want = jeval.evaluate_pair(paths["out"], paths["ref"], SR)
    assert got.keys() == want.keys() and len(got) > 20
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k
    # identical files score ~0 on every metric
    assert all(abs(v) < 1e-3 for v in peval.evaluate_pair(paths["ref"], paths["ref"], SR).values())


def test_evaluate_cli_json_report_matches_jax(tmp_path):
    for song in ("song1", "song2"):
        d = tmp_path / "songs" / song
        write_wav(str(d / "mixture_output.wav"), _tone(2.0, 330, 0.3, pan=0.4), SR)
        write_wav(str(d / "reference.wav"), _tone(2.0, 440, 0.25, pan=0.6, seed=3), SR)
    reports = {}
    for name, mod in (("port", peval), ("jax", jeval)):
        out = str(tmp_path / f"{name}.json")
        assert mod.main(["--target_dir", str(tmp_path / "songs"), "--json", out]) == 0
        with open(out) as f:
            reports[name] = json.load(f)
    assert set(reports["port"]) == set(reports["jax"]) == {"song1", "song2", "mean"}
    for row in reports["jax"]:
        for k, v in reports["jax"][row].items():
            assert (reports["port"][row][k] is None) if v is None else (
                reports["port"][row][k] == pytest.approx(v, rel=1e-6, abs=1e-12)), (row, k)
    assert peval.main(["--target_dir", str(tmp_path / "empty")]) == 1


def test_numpy_loudness_matches_the_ports_bs1770(rng):
    """The metrics' float64 loudness against the port's own
    ``integrated_loudness`` (the JAX package's bar, 0.02 LU)."""
    from music_mixing_style_transfer_tpu_torch.ops.loudness import integrated_loudness

    for seconds, gain in ((1.0, 0.3), (2.5, 0.8)):
        x = (gain * rng.standard_normal((int(SR * seconds), 2))).astype(np.float32)
        assert abs(integrated_loudness_np(x, SR) - integrated_loudness(torch.from_numpy(x), SR).item()) < 0.02


def test_infer_prof_reports_every_phase_on_the_cpu(tmp_path, rng, monkeypatch):
    """A tiny engine, short segments, and a small normalization config on
    synthetic features, in place of the published widths, 2^19-sample
    segments and the MUSDB18 file."""
    from music_mixing_style_transfer_tpu_torch import config, normalize
    from music_mixing_style_transfer_tpu_torch.infer import pipeline

    feats = {"eq": {}, "compression": {}, "imager": {}, "loudness": {}}
    for i in ("drums", "bass", "other", "vocals"):
        feats["eq"][i] = np.abs(rng.standard_normal(2049)) * 0.05 + np.geomspace(1.0, 0.01, 2049)
        feats["compression"][i] = np.asarray([-16.0, 1.0])
        feats["imager"][i] = 0.2
        feats["loudness"][i] = np.asarray([-22.0])
    path = str(tmp_path / "features.npy")
    np.save(path, feats, allow_pickle=True)
    small = NormalizationConfig(fft_size=4096, hop_length=1024, ntaps=101, comp_min_th=-20.0,
                                comp_max_ratio=5)
    monkeypatch.setattr(config, "InferenceConfig", functools.partial(
        config.InferenceConfig, segment_length=8192, segment_length_ref=8192))
    monkeypatch.setattr(pipeline, "StyleTransferEngine", lambda **kw: StyleTransferEngine(
        encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN), **kw))
    monkeypatch.setattr(normalize, "AudioEffectsNormalizer", lambda _path, _cfg, device: (
        normalize.normalizer.AudioEffectsNormalizer(path, small, device=device)))
    out = infer_prof.run(infer_prof.build_parser().parse_args(
        ["--seconds", "0.3", "--inference_device", "cpu", "--dtype", "float32"]))
    keys = ["norm_loudness_s", "norm_eq_s", "norm_compression_s", "norm_imager_s", "upload_s",
            "normalize_s", "embed_s", "convert_s", "download_s", "total_s", "rtf"]
    assert set(keys) <= set(out) and out["backend"] == "cpu" and out["device"] == "cpu"
    assert all(out[k] > 0 for k in keys)
    # each phase is a span of the one traced request; on the CPU, host seconds
    phases = ("upload_s", "normalize_s", "embed_s", "convert_s", "download_s")
    assert sum(out[k] for k in phases) <= out["total_s"]
    assert sum(out[k] for k in keys[:4]) <= out["normalize_s"]
    assert out["rtf"] == pytest.approx(0.3 / out["total_s"])


def test_profiling_trace_timer_and_rtf(tmp_path):
    x = torch.randn(256, 256)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0
    assert profiling.device_time(lambda a: a @ a, x, iters=3) > 0
    timer, meter = Timer(), RTFMeter(SR)
    with timer.section("a"), meter.measure(SR):
        (x @ x).sum()
    assert timer.counts == {"a": 1} and "a=" in timer.summary() and meter.rtf > 0
