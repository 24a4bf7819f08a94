"""The port's tracing (``utils/profiling.py``): spans and counters that cost
nothing without a profiler, every serving and training span under one, the
counters' records, and the benchmark's readers of them on hand-made traces."""
from __future__ import annotations

import gzip
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from music_mixing_style_transfer_tpu_torch.config import (
    FXencoderConfig,
    InferenceConfig,
    NormalizationConfig,
    TCNConfig,
)
from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
    MixingStyleTransfer,
    StyleTransferEngine,
)
from music_mixing_style_transfer_tpu_torch.normalize import batch as nbatch
from music_mixing_style_transfer_tpu_torch.normalize.normalizer import AudioEffectsNormalizer
from music_mixing_style_transfer_tpu_torch.utils import profiling

ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
INSTS = ("drums", "bass", "other", "vocals")
SERVING_SPANS = (
    "infer.request", "infer.upload", "normalize.batch", "normalize.loudness", "normalize.eq",
    "normalize.compression", "normalize.compression.sync", "normalize.compression.host_sweep",
    "normalize.imager", "models.fx_encoder", "models.tcn", "models.tcn.plain", "infer.finish",
)


def _pipeline(tmp_path=None, rng=None) -> MixingStyleTransfer:
    """The tiny engine (segments of 2048) on the CPU, with a small
    normalizer (FFT frames of 2048) on synthetic features when ``tmp_path``
    is given."""
    engine = StyleTransferEngine(FXencoderConfig(**ENC), TCNConfig(**TCN), device="cpu")
    normalizer = None
    if tmp_path is not None:
        feats = {"eq": {}, "compression": {}, "imager": {}, "loudness": {}}
        for i in INSTS:
            feats["eq"][i] = np.abs(rng.standard_normal(1025)) * 0.05 + np.geomspace(1.0, 0.01, 1025)
            feats["compression"][i] = np.asarray([-16.0, 1.0])
            feats["imager"][i] = 0.2
            feats["loudness"][i] = np.asarray([-22.0])
        path = str(tmp_path / "features.npy")
        np.save(path, feats, allow_pickle=True)
        small = NormalizationConfig(fft_size=2048, hop_length=512, ntaps=101, comp_min_th=-20.0,
                                    comp_max_ratio=5)
        normalizer = AudioEffectsNormalizer(path, small, device="cpu")
    cfg = InferenceConfig(segment_length=2048, segment_length_ref=2048,
                          normalize_input=normalizer is not None)
    return MixingStyleTransfer(engine, cfg, normalizer)


def _pcm(rng, T: int) -> np.ndarray:
    env = (np.sin(2 * np.pi * np.arange(T) / 22050) > 0.7).astype(np.float32)
    return (rng.standard_normal((4, 2, T)) * (0.05 + 0.4 * env) * 20000).astype(np.int16)


def _spans(prof):
    """``{name: [(start_ns, end_ns), ...]}`` of the ranges on the host (the
    raw events: ``events()`` is slow on the plain envelope's many ops)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in SERVING_SPANS + ("train.augment",
                                                                              "train.step"):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_without_a_profiler_spans_make_no_range_and_counters_keep_nothing(monkeypatch, rng):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    with profiling.span("a.span"):
        profiling.count("a.counter", 1)
    mixture, _ = _pipeline().transfer_song_pcm(_pcm(rng, 9000), _pcm(rng, 9000))
    assert mixture.shape == (2, 9000)
    assert all(profiling.records(n) == [] for n in
               ("a.counter", "infer.request", "infer.segments", "ops.cuda.envelope"))


def test_a_traced_song_opens_every_serving_span_inside_its_request(tmp_path, rng, monkeypatch):
    """One normalized song of 3 segments a stem (12 real, bucket 16); the
    first candidate block cut to 77 of the 78 candidates a channel, so that
    channels that no candidate of it satisfies take the host-stepped
    sweep."""
    monkeypatch.setattr(nbatch, "BLOCK_LANES", 8 * 77)
    pipe = _pipeline(tmp_path, rng)
    T = 2 * 2048 + 500
    with profiling.trace() as prof:
        pipe.transfer_song_pcm(_pcm(rng, T), _pcm(rng, T))
    spans = _spans(prof)
    assert set(spans) == set(SERVING_SPANS)
    ((r0, r1),) = spans["infer.request"]
    assert all(r0 <= a <= b <= r1 for ivs in spans.values() for a, b in ivs)
    assert len(spans["infer.upload"]) == 2 and len(spans["models.tcn.plain"]) == 2
    assert profiling.records("infer.request") == [{"samples": T, "ok": True}]
    assert profiling.records("infer.segments") == [("encoder", 12, 16), ("converter", 12, 16)]
    assert profiling.records("normalize.compression") == [{"fallback": True}]
    # over the padded song (3 segments and an FFT frame on each side): the
    # sweeps' 8 x 77 lanes read the 8 channels' rows, and the two final
    # compressions (the device's, then the host sweep's) walk the channels
    envs = profiling.records("ops.cuda.envelope")
    assert set(envs) == {(616, 10240, 8), (8, 10240, None)} and envs.count((8, 10240, None)) == 2
    assert profiling.records("ops.cuda.tcn_block") == []  # the tiny converter has no K1 block


def test_a_traced_mixture_opens_the_separation_spans_inside_its_request(rng, monkeypatch):
    """``transfer_mix_pcm`` on two mixtures of 3 chunks (dispatches of 2
    and 1): the separation's spans inside the one request, a counter record
    a dispatch; without a profiler, no range and no record."""
    from music_mixing_style_transfer_tpu_torch.models.htdemucs import (
        HTDemucsConfig,
        HTDemucsSeparator,
    )

    names = ("separate.htdemucs", "separate.htdemucs.spec", "separate.htdemucs.unet",
             "separate.htdemucs.transformer")
    sep = HTDemucsSeparator(HTDemucsConfig(nfft=2048, channels=8, bottom_channels=16, t_heads=2,
                                           segment=0.25, batch=2), device="cpu")
    pipe = _pipeline()
    pipe = MixingStyleTransfer(pipe.engine, pipe.cfg, separator=sep)
    mixes = [_pcm(rng, T)[0] for T in (20000, 19000)]

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        profiling.clear()
        pipe.transfer_mix_pcm(*mixes)
        assert profiling.records("separate.htdemucs") == profiling.records("infer.request") == []
    with profiling.trace() as prof:
        mixture, _ = pipe.transfer_mix_pcm(*mixes)
    assert mixture.shape == (2, 20000)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names + ("infer.request",):
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(spans) == set(names) | {"infer.request"}
    ((r0, r1),) = spans["infer.request"]
    assert all(r0 <= a <= b <= r1 for ivs in spans.values() for a, b in ivs)
    assert len(spans["separate.htdemucs"]) == 2 and len(spans["separate.htdemucs.transformer"]) == 4
    assert profiling.records("infer.request") == [{"samples": 20000, "ok": True}]
    tok = {"freq_tokens": 4 * 22, "time_tokens": 44}  # 1024 / 4^4 bins x 22 frames; 11025 / 4^4
    assert profiling.records("separate.htdemucs") == [
        dict(samples=T, chunks=3, batch=b, **tok) for T in (20000, 19000) for b in (2, 1)]


def test_a_request_that_runs_out_of_memory_is_recorded_and_reraised(rng, monkeypatch):
    pipe = _pipeline()
    err = torch.OutOfMemoryError("CUDA out of memory (planted)")

    def fail(*a, **k):
        raise err

    with profiling.trace():
        pipe.transfer_song_pcm(_pcm(rng, 9000), _pcm(rng, 9000))
        monkeypatch.setattr(pipe.engine, "_convert_multi", fail)
        with pytest.raises(torch.OutOfMemoryError) as got:
            pipe.transfer_song_pcm(_pcm(rng, 5000), _pcm(rng, 5000))
    assert got.value is err
    assert profiling.records("infer.request") == [{"samples": 9000, "ok": True},
                                                  {"samples": 5000, "ok": False}]


def test_a_traced_converter_step_opens_the_training_spans():
    from music_mixing_style_transfer_tpu_torch.config import TrainConfig
    from music_mixing_style_transfer_tpu_torch.fx.factory import make_instrument_manipulators
    from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedConverterPipeline
    from music_mixing_style_transfer_tpu_torch.train.state import (
        TrainState, make_lr_schedule, make_optimizer)

    tcfg, seg, pad, B = TrainConfig(segment_length=4096), 4096, 256, 1
    converter = fast_init(MixFXcloner(TCNConfig(**TCN)), seed=1).train()
    state = TrainState(step=0, model=converter, lr_schedule=make_lr_schedule(tcfg),
                       optimizer=make_optimizer(converter.parameters(), 1e-4, 0.0))
    pipe = FusedConverterPipeline(fast_init(FXencoder(FXencoderConfig(**ENC)), seed=0), device="cpu")
    chains = make_instrument_manipulators(INSTS, tcfg.apply_prob, tcfg.reverb_prob, None, 44100)
    pipe.set_chains(chains, INSTS, pad, seg)
    gen = np.random.default_rng(3)
    segs = (gen.standard_normal((4, B, 2, 2, seg + 2 * pad)) * 3000).astype(np.int16)
    plans = {i: chains[i].draw(torch.Generator().manual_seed(5), B) for i in INSTS}
    with profiling.trace() as prof:
        state, loss = pipe.step(state, segs, plans)
    spans = _spans(prof)
    assert np.isfinite(float(loss)) and state.step == 1
    ((a0, a1),), ((s0, s1),) = spans["train.augment"], spans["train.step"]
    assert a1 <= s0
    # training runs every block channels-first, off K1; the frozen encoder too
    assert len(spans["models.tcn.plain"]) >= 2 and spans["models.fx_encoder"]
    assert all(s0 <= a <= b <= s1 for n in ("models.tcn", "models.fx_encoder")
               for a, b in spans[n])


def _trace_file(path, spans, kernels, window=(0.0, 100.0)):
    """A Chrome trace (microseconds) with the benchmark's window, host
    ranges ``(name, start, end)`` and device operations ``(name, start,
    end, launched_at)``."""
    from mstbench.trace_file import WINDOW

    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": window[0],
           "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a} for n, a, b in spans]
    for i, (n, a, b, t) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 1,
                   "args": {"correlation": i}})
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    return path


def test_the_readers_of_the_program_spans_and_counters(tmp_path):
    from mstbench.harness import HERE, load_module
    from mstbench.metrics.counts import k2_bound_s
    from mstbench.tracing import Trace

    def reader(name):
        return load_module(os.path.join(HERE, "metrics", name + ".py")).read

    # two requests: the first completes, the second fails; a minute of song
    spans = [("infer.request", 10, 40), ("infer.request", 50, 90), ("normalize.batch", 12, 30),
             ("normalize.eq", 12, 14), ("normalize.compression", 14, 28)]
    kernels = [("envelope_scan_kernel", 15, 19, 14.5), ("envelope_scan_kernel", 22, 26, 21),
               ("fft_kernel", 12, 13, 12.5), ("gemm", 60, 80, 55)]
    tr = Trace(_trace_file(str(tmp_path / "t.json.gz"), spans, kernels))
    attempts = [{"samples": 10, "ok": True}, {"samples": 20, "ok": False}]
    ctx = types.SimpleNamespace(trace=tr, counters={"attempted_audio_s": 60.0, "attempts": attempts})
    with profiling.trace():
        profiling.count("ops.cuda.envelope", (1024, 262144, 8))
        profiling.count("ops.cuda.envelope", (8, 655360, None))
        for a in attempts:
            profiling.count("infer.request", a)
    # normalize.batch is 18 us long, 9 us of it busy (12-13, 15-19, 22-26)
    assert reader("normalize_idle_ms_per_min.serve")(ctx) == pytest.approx(1e3 * 9e-6)
    assert reader("normalize_comp_ms_per_min.serve")(ctx) == pytest.approx(1e3 * 8e-6)
    assert reader("normalize_eq_ms_per_min.serve")(ctx) == pytest.approx(1e3 * 1e-6)
    assert reader("converter_plain_ms_per_min.serve")(ctx) is None  # no such span
    want = 100.0 * (k2_bound_s(1024, 262144, 8) + k2_bound_s(8, 655360)) / 8e-6
    assert reader("k2_roofline.serve")(ctx) == reader("k2_roofline.train")(ctx) == pytest.approx(want)
    assert reader("oom_share.serve")(ctx) == pytest.approx(40.0)  # 40 us of the 100
    # records that do not pair with the kernels or the attempts: no reading
    ctx.counters["attempts"] = attempts[:1]
    assert reader("oom_share.serve")(ctx) is None
    profiling.count("ops.cuda.envelope", (8, 655360, None))  # no profiler: not kept
    with profiling.trace():
        profiling.count("ops.cuda.envelope", (8, 655360, None))
    assert reader("k2_roofline.serve")(ctx) is None
    # a trace without device operations (a CPU run): nothing to read
    ctx.trace = Trace(_trace_file(str(tmp_path / "cpu.json.gz"), spans, []))
    assert reader("normalize_idle_ms_per_min.serve")(ctx) is None
