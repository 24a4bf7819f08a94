"""PyTorch port on the card: the CUDA kernels against their plain versions.

Marked ``cuda``; skips where ``torch.cuda.is_available()`` is false. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets JAX up for the CPU.)
"""
import contextlib

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import (
    compressor_envelope,
    envelope_reference,
)
from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import (
    block_epilogue,
    dilated_conv,
    tcn_block,
    tcn_block_reference,
)

C, K = 128, 15
ENVELOPE_TOL = 1e-5  # K2 against a float64 run, over max|float64|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full float32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _inputs(seed, B, T, dev, dtype):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)

    return dict(
        x=t(rng.standard_normal((B, T, C)) * 0.3, dtype),
        w=t(rng.standard_normal((K, C, C)) * 0.05, dtype),
        s=t(rng.standard_normal(C) * 0.2 + 1), t=t(rng.standard_normal(C) * 0.1),
        r=t(rng.standard_normal((B, C)) * 0.2 + 1), b=t(rng.standard_normal((B, C)) * 0.1),
        wr=t(rng.standard_normal(C) * 0.3),
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,d",
    [
        (2, 4096, 8), (3, 17477, 8192), (4, 1000, 64), (1, 1, 64),
        (3, 133 * 256 + 77, 16),  # 400 tiles: not a multiple of the persistent grid
        (2, 100, 8),              # T < one tile of 256 rows
        (1, 1, 8192),             # T = 1, only tap 7 live
        (2, 5000, 8192),          # T < 7*d: dead taps skipped
        (1, 1000, 1),             # d = 1
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(card, B, T, d, dtype):
    """Ragged T (< 7*d, not a multiple of d or of the tile), B > 1 with
    distinct FiLM rows, dead taps, a ragged persistent grid. float32
    (3xTF32): 1e-4 of max|plain|; bf16: 2e-2 of the float32 plain version
    on the same bf16-rounded inputs."""
    a = _inputs(B * T + d, B, T, card, dtype)
    before = tcn_block.launches
    got = tcn_block(**a, d=d)
    assert tcn_block.launches == before + 1
    want = tcn_block_reference(**{k: v.float() for k, v in a.items()}, d=d)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == (B, T, C)
    assert (got.float() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1024])
def test_float32_kernel_has_float32_accuracy(card, d):
    """3xTF32 against a float64 run of the plain version: within 1e-5 of
    max|float64|, as close as float32 itself gets (1xTF32 is ~3e-4)."""
    a = _inputs(d, 2, 16384, card, torch.float32)
    got = tcn_block(**a, d=d).double()
    a64 = {k: v.double() for k, v in a.items()}
    want = block_epilogue(
        dilated_conv(a64["x"], a64["w"], d), a64["x"], *(a64[k] for k in "strb"), a64["wr"]
    )
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    a = _inputs(0, 1, 64, card, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tcn_block(**{**a, "x": a["x"].transpose(1, 2).contiguous().transpose(1, 2)}, d=8)
    shifted = torch.zeros(64 * C + 1, device=card)[1:].view(1, 64, C)  # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        tcn_block(**{**a, "x": shifted}, d=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcn_block(**{**a, "x": a["x"].half()}, d=8)
    with pytest.raises(ValueError, match="must be"):
        tcn_block(**{**a, "r": a["r"].cpu()}, d=8)


def _lanes(seed, L, T, dev):
    """Audio and per-lane compressor parameters: compressors, an expander,
    an identity lane and lanes whose attack is slower than the release."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, T)) * 0.3 * rng.uniform(0.01, 1.5, (L, 1))
    ratio = rng.choice([4.0, 6.0, 20.0, 0.25, 1.0], L)
    a = np.exp(-1.0 / (44.1 * rng.uniform(1.0, 700.0, (2, L))))
    params = [rng.uniform(-40.0, -10.0, L), ratio, a[0], a[1], rng.uniform(0.0, 20.0, L)]
    return [torch.from_numpy(v.astype(np.float32)).to(dev) for v in [x] + params]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "L,T,cuts,shared",
    [  # from 128 lanes on the kernel takes chunk 16, below chunk 64
        (1024, 4096, None, False), (1000, 1000, None, False), (1, 1, None, False),
        (8, 1000, None, False), (7, 5000, [1, 1777, 4096], False),
        (1024, 70001, [65536], True),  # lanes reading 8 shared rows, two windows' ragged tail
        (1000, 9001, None, True),  # 125 lanes a row: blocks of 8 lanes straddle two rows
        (16, 30001, [20000], True),  # chunk 64, lanes reading shared rows, 15 windows
    ],
)
def test_envelope_kernel_matches_plain_version(card, L, T, cuts, shared):
    """Ragged L and T, slabs of unequal lengths with the envelope carried,
    lanes reading shared rows, both chunk lengths: within 1e-5 of max|y| of
    a float64 run of the plain version (y and env_out), and within the
    float32 plain version's own error against float64 plus 1e-5 of it."""
    x, *p = _lanes(L * 7 + T, L, T, card)
    rows = None
    if shared:
        x = x[:8].contiguous()
        rows = torch.arange(8, device=card).repeat_interleave(L // 8)
    want, env_want = envelope_reference(x.double(), *(v.double() for v in p), rows=rows)
    plain, _ = envelope_reference(x, *p, rows=rows)
    before = compressor_envelope.launches
    if cuts is None:
        got, env = compressor_envelope(x, *p, rows=rows)
    else:
        parts, env = [], p[-1]
        for a, b in zip([0] + cuts, cuts + [T]):
            y, env = compressor_envelope(x[:, a:b].contiguous(), *p[:-1], env, rows=rows)
            parts.append(y)
        got = torch.cat(parts, -1)
    torch.cuda.synchronize()
    assert compressor_envelope.launches == before + (1 if cuts is None else len(cuts) + 1)
    scale, env_scale = want.abs().max().item(), env_want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= ENVELOPE_TOL * scale
    assert (env.double() - env_want).abs().max().item() <= ENVELOPE_TOL * env_scale + 1e-6
    # implied by the float64 bar above (|got - plain| <= |got - want| +
    # |plain - want|), kept as the figure that compares the two float32 walks
    plain_err = (plain.double() - want).abs().max().item()
    assert (got - plain).abs().max().item() <= plain_err + ENVELOPE_TOL * scale


@pytest.mark.cuda
def test_envelope_wrapper_raises_on_what_the_kernel_does_not_take(card):
    x, *p = _lanes(0, 4, 64, card)
    with pytest.raises(ValueError, match="contiguous"):
        compressor_envelope(x.t().contiguous().t(), *p)
    with pytest.raises(ValueError, match="float32"):
        compressor_envelope(x.double(), *p)
    with pytest.raises(ValueError, match="must be"):
        compressor_envelope(x, *p[:-1], p[-1].cpu())
    with pytest.raises(ValueError, match="rows"):
        compressor_envelope(x, *p, rows=torch.zeros(4, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("L,T", [(96, 70001), (96, 1000), (1, 70001)])
def test_envelope_kernel_per_channel_shapes(card, L, T):
    """The per-channel compression matching's launches: 96 candidates that
    all read one channel (``rows`` all zeros; chunk 64 below 128 lanes), and
    the chosen candidate alone (one lane, ``rows`` [0], as ``_grid_one``
    calls it). Against a float64 run of the plain version."""
    x, *p = _lanes(L + T, L, T, card)
    x = x[:1].contiguous()
    rows = torch.zeros(L, dtype=torch.int64, device=card)
    want, env_want = envelope_reference(x.double(), *(v.double() for v in p), rows=rows)
    got, env = compressor_envelope(x, *p, rows=rows)
    torch.cuda.synchronize()
    assert got.shape == (L, T)
    assert (got.double() - want).abs().max().item() <= ENVELOPE_TOL * want.abs().max().item()
    assert (env.double() - env_want).abs().max().item() <= ENVELOPE_TOL * env_want.abs().max().item() + 1e-6


def _music(rng, T, scale):
    env = np.abs(np.sin(np.linspace(0, 20, T)))
    x = rng.standard_normal((2, T)) * scale * (0.05 + env)
    x[..., rng.integers(0, T, max(T // 3000, 1))] += 3 * scale
    return x.astype(np.float32)


@pytest.mark.cuda
def test_per_channel_normalizer_card_matches_cpu(card):
    """``normalize_audio`` at T = 2^15 with the shipped features and a small
    FFT: the same compression choices on the card as on the CPU, and the stem
    within 1e-4 of max|cpu|."""
    import os

    from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
    from music_mixing_style_transfer_tpu_torch.normalize import matching
    from music_mixing_style_transfer_tpu_torch.normalize.normalizer import AudioEffectsNormalizer

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "music_mixing_style_transfer_tpu_torch", "weights",
                        "musdb18_fxfeatures_eqcompimagegain.npy")
    x = _music(np.random.default_rng(4), 2**15, 0.3)
    picks = []
    orig = matching._grid_one

    def record(x_, r, t, *a):
        picks.append((float(r), float(t)))
        return orig(x_, r, t, *a)

    out = {}
    try:
        matching._grid_one = record
        for dev in ("cuda", "cpu"):
            norm = AudioEffectsNormalizer(path, NormalizationConfig(stems=("drums",)), device=dev)
            before = compressor_envelope.launches
            out[dev] = norm.normalize_audio(x, "drums")
            out[dev + "_launches"] = compressor_envelope.launches - before
    finally:
        matching._grid_one = orig
    n = len(picks) // 2  # one pick per matched channel, card then CPU
    assert len(picks) == 2 * n and picks[:n] == picks[n:]
    assert out["cuda_launches"] >= 2 * n and out["cpu_launches"] == 0
    err = np.abs(out["cuda"] - out["cpu"]).max()
    assert np.isfinite(out["cuda"]).all() and err <= 1e-4 * np.abs(out["cpu"]).max()


@pytest.mark.cuda
def test_server_round_trip_on_the_card(card, tmp_path):
    """/health, /embed and /transfer of a tiny engine on the card; the
    written mixture equals the same engine's in-process run_directory."""
    import json
    import threading
    import urllib.request

    from music_mixing_style_transfer_tpu_torch.config import (
        FXencoderConfig,
        InferenceConfig,
        TCNConfig,
    )
    from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav, write_wav
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
        MixingStyleTransfer,
        StyleTransferEngine,
    )
    from music_mixing_style_transfer_tpu_torch.serve import StyleTransferService, serve

    eng = StyleTransferEngine(
        encoder_cfg=FXencoderConfig(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1)),
        converter_cfg=TCNConfig(condition_dimension=16, nblocks=4, channel_width=128),
    )
    cfg = InferenceConfig(segment_length=8192, segment_length_ref=8192, normalize_input=False,
                          do_not_separate=True)
    rng = np.random.default_rng(0)
    for name in ("input", "reference"):
        for inst in ("drums", "bass", "other", "vocals"):
            write_wav(str(tmp_path / "s" / "s1" / "separated" / name / f"{inst}.wav"),
                      (rng.standard_normal((12_000, 2)) * 0.2).astype(np.float32), 44100)
    httpd = serve(StyleTransferService(eng, cfg), port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert json.loads(r.read())["backend"] == "cuda"
        target = str(tmp_path / "s") + "/"
        before = tcn_block.launches
        written = post("/transfer", {"target_dir": target, "output_dir": str(tmp_path / "o") + "/"})
        assert tcn_block.launches > before
        emb = post("/embed", {"wav": str(tmp_path / "s" / "s1" / "separated" / "input" / "bass.wav")})
        assert np.isfinite(emb["embedding"]).all()
    finally:
        httpd.shutdown()
        httpd.server_close()
    want = MixingStyleTransfer(eng, cfg).run_directory(target, str(tmp_path / "w") + "/")
    got_mix, _ = read_wav(written["written"][0])
    want_mix, _ = read_wav(want[0])
    np.testing.assert_array_equal(got_mix, want_mix)


@pytest.mark.cuda
def test_envelope_kernel_at_the_fast_path_layout(card):
    """K2 as ``fx/fastpath.py`` launches it: 128 lanes (32 draws of the
    ``Compressor``'s ranges, each over 2 contents x 2 channels), chunk 16,
    against a float64 run of the plain version."""
    from music_mixing_style_transfer_tpu_torch.fx.processors import Compressor
    from music_mixing_style_transfer_tpu_torch.ops.compressor import alphas

    L, T = 128, 8192
    p = Compressor().sample(torch.Generator().manual_seed(0), L // 4)
    rep = lambda v: v.repeat_interleave(4).to(card)  # noqa: E731
    a_att, a_rel = alphas(rep(p["attack_ms"]), rep(p["release_ms"]), 44100)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((L, T)) * 0.3).astype(np.float32)).to(card)
    args = (x, rep(p["threshold"]), rep(p["ratio"]), a_att, a_rel, torch.zeros(L, device=card))
    want, env_want = envelope_reference(*(v.double() for v in args))
    before = compressor_envelope.launches
    got, env = compressor_envelope(*args)
    assert compressor_envelope.launches == before + 1
    assert (got - want).abs().max().item() <= ENVELOPE_TOL * want.abs().max().item()
    assert (env - env_want).abs().max().item() <= ENVELOPE_TOL * env_want.abs().max().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("T, items, pad", [(4096, 2, 512), (2**15 + 4096, 1, 2048)])
def test_augmentation_card_matches_cpu(card, T, items, pad):
    """The 4 default instrument chains under one plan on the same int16
    segments: the card (K2, twice: the eq/comp shuffle's two rounds)
    against the CPU (plain versions), within 1e-4 of max|cpu|. Below 32768
    samples the Equaliser scans; from 32768 on it takes its FFT cascade, as
    training does."""
    from music_mixing_style_transfer_tpu_torch.fx import make_instrument_manipulators
    from music_mixing_style_transfer_tpu_torch.fx.chain import plan_to
    from music_mixing_style_transfer_tpu_torch.train.fused import augment_contrastive_views

    insts = ("drums", "bass", "other", "vocals")
    man = make_instrument_manipulators()
    gen = torch.Generator().manual_seed(2)
    plans = {inst: man[inst].draw(gen, 2 * items) for inst in insts}  # items x K = 2
    rng = np.random.default_rng(3)
    segs = torch.from_numpy((rng.standard_normal((4, items, 2, 2, T)) * 5000).astype(np.int16))
    cpu = augment_contrastive_views(man, insts, segs, plans, pad=pad)
    before = compressor_envelope.launches
    got = augment_contrastive_views(man, insts, segs.to(card), plan_to(plans, card), pad=pad)
    assert compressor_envelope.launches == before + 2
    for g, c in zip(got, cpu):
        assert g.shape == c.shape == (4, 2 * items, 2, T - 2 * pad)
        assert (g.cpu() - c).abs().max().item() <= 1e-4 * c.abs().max().item()


@pytest.mark.cuda
def test_triplet_augmentation_card_matches_cpu(card):
    """``augment_triplets`` of the 4 default instrument chains, one draw per
    (instrument, item), on the same int16 segments: the card (K2, twice:
    one launch over 4 instruments x 2 items x 2 contents x 2 channels = 32
    lanes per round of the eq/comp shuffle) against the CPU, within 1e-4 of
    max|cpu|; the generic walk on the card (8 launches) too."""
    from music_mixing_style_transfer_tpu_torch.fx import make_instrument_manipulators
    from music_mixing_style_transfer_tpu_torch.fx.chain import plan_to
    from music_mixing_style_transfer_tpu_torch.train.fused import augment_triplets

    insts = ("drums", "bass", "other", "vocals")
    man = make_instrument_manipulators()
    gen = torch.Generator().manual_seed(4)
    plans = {inst: man[inst].draw(gen, 2) for inst in insts}
    rng = np.random.default_rng(5)
    segs = torch.from_numpy((rng.standard_normal((4, 2, 2, 2, 5120)) * 5000).astype(np.int16))
    cpu = augment_triplets(man, insts, segs, plans, 512, 4096)
    scale = max(c.abs().max().item() for c in cpu)
    for fast, launches in ((True, 2), (False, 8)):
        before = compressor_envelope.launches
        got = augment_triplets(man, insts, segs.to(card), plan_to(plans, card), 512, 4096, fast=fast)
        assert compressor_envelope.launches == before + launches
        for g, c in zip(got, cpu):
            assert g.shape == c.shape == (8, 2, 4096)
            assert (g.cpu() - c).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_converter_step_card_matches_cpu(card):
    """One converter step on a small TCN against a small frozen encoder,
    the same weights and triplets on the card and the CPU (TF32 off): the
    loss within 1e-4, BN's running statistics within 1e-5, the converter's
    backward from one cotangent within 1e-4 of each gradient's max, and the
    full-step gradients within 5e-4 of each tensor's max, card against CPU
    and each device against a float64 CPU run (the spectral loss's
    log-magnitude term is ill-conditioned in float32: both devices land
    ~1.1e-4...1.3e-4 from float64 in ``chip_smoke.py``'s step)."""
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig, TrainConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.train.converter import (
        frozen,
        init_converter,
        make_converter_train_step,
    )

    enc_cfg = FXencoderConfig(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
    tcn_cfg = TCNConfig(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
    rng = np.random.default_rng(6)
    a1, a2, b2, cot = (torch.from_numpy((rng.standard_normal((4, 2, 8192)) * 0.2).astype(np.float32))
                       for _ in range(4))
    a2 = 0.5 * a1 + 0.5 * a2
    runs, backward = {}, {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, dev, dtype in (("float64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                                 ("card", card, torch.float32)):
            enc = frozen(fast_init(FXencoder(enc_cfg), seed=0).to(dev, dtype))
            args = [v.to(dev, dtype) for v in (a1, a2, b2)]
            if name != "float64":
                _, state, _ = init_converter(tcn_cfg, TrainConfig(), seed=0, device=dev)
                with torch.no_grad():
                    emb = enc(args[2])
                state.model(args[0], emb).backward(cot.to(dev))
                backward[name] = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
            _, state, _ = init_converter(tcn_cfg, TrainConfig(), seed=0, device=dev)
            state.model.to(dtype)
            state, loss = make_converter_train_step()(state, enc, *args)
            runs[name] = (float(loss), {n: p.grad.cpu().double() for n, p in state.model.named_parameters()},
                          {k: v.cpu().double() for k, v in state.model.state_dict().items() if "running" in k})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

    def rel(a, b):
        return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)

    (_, g64, _), (lc, gc, sc), (lg, gg, sg) = runs["float64"], runs["cpu"], runs["card"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for n in gc:
        assert rel(backward["card"][n], backward["cpu"][n]) <= 1e-4, n
        errs = rel(gg[n], gc[n]), rel(gg[n], g64[n]), rel(gc[n], g64[n])
        assert max(errs) <= 5e-4, (n, errs)
    for k in sc:
        assert rel(sg[k], sc[k]) <= 1e-5, k


def remat_after_full_cache(root: str, keep_cache: bool = False) -> dict:
    """``train_converter`` at full width (the default MixFXcloner and
    FXencoder, 16 triplets of 2^17 a step, 2 steps an epoch) on a noise
    corpus under ``root``: a ``remat`` run, then a float32 and a bf16 run
    that leave the allocator's cache near the card's size, then ``remat``
    again. Returns each run's synced step, the allocation retries over it
    (a ``cudaMalloc`` that failed and was retried after the cache was
    freed) and the cache it started from. ``keep_cache=True`` skips the
    cache's empty at ``train_converter``'s start, for comparison:
    ``python -c "import sys; sys.path.insert(0, 'tests'); import
    test_torch_cuda as t; print(t.remat_after_full_cache('work', True))"``."""
    import json
    import os
    from unittest import mock

    from music_mixing_style_transfer_tpu_torch.config import TrainConfig
    from music_mixing_style_transfer_tpu_torch.data.wavio import write_wav
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.train.loop import train_converter

    rng = np.random.default_rng(7)
    for mode in ("train", "val"):
        os.makedirs(os.path.join(root, mode), exist_ok=True)
        for inst in ("drums", "bass", "other", "vocals"):
            write_wav(os.path.join(root, mode, f"{inst}_normalized_eqcompimagegain_silence_trimmed0.wav"),
                      (rng.standard_normal((44100 * 10, 2)) * 0.2).astype(np.float32))
    encoder = fast_init(FXencoder(), seed=0)
    torch.cuda.empty_cache()
    out = {}
    for name, cfg in (("remat_fresh", dict(remat=True)), ("float32", {}),
                      ("bfloat16", dict(compute_dtype="bfloat16")), ("remat_after", dict(remat=True))):
        run = os.path.join(root, name)
        reserved = torch.cuda.memory_reserved() / 2**30
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        with mock.patch("torch.cuda.empty_cache") if keep_cache else contextlib.nullcontext():
            train_converter(root, run, encoder, train_cfg=TrainConfig(**cfg), epochs=1,
                            steps_per_epoch=2, batch_items=4, fused=True, val_items=1)
        torch.cuda.synchronize()
        with open(os.path.join(run, "metrics.jsonl")) as f:
            wall = json.loads(f.readline())["wall"]
        out[name] = {"synced_step": wall["synced_step"], "reserved_gb_before": round(reserved, 2),
                     "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries}
    return out


@pytest.mark.cuda
def test_train_converter_keeps_its_pace_after_a_full_cache(card, tmp_path):
    """A ``remat`` converter run after float32 and bf16 runs in one process
    (~60 GB left in the allocator's cache) takes no allocation retries and
    keeps within 1.25x of a fresh run's synced step."""
    runs = remat_after_full_cache(str(tmp_path))
    assert runs["remat_after"]["alloc_retries"] == 0, runs
    assert runs["remat_after"]["synced_step"] <= 1.25 * runs["remat_fresh"]["synced_step"], runs


@pytest.mark.cuda
def test_blockwise_compressor_on_the_card(card):
    """``Compressor(blockwise=True)`` at [4, 2, 3 x 4096 + 100]: one K2
    launch over the 32 blocks as lanes, and the processor within 1e-5 of
    max|float64| of a float64 run of the plain version on those lanes, on
    the card; the CPU's float32 processor beside it within 1e-4 (its serial
    float32 walk drifts ~1e-5 from float64 on noise)."""
    from music_mixing_style_transfer_tpu_torch.fx.processors import Compressor
    from music_mixing_style_transfer_tpu_torch.ops import compressor as comp

    fx = Compressor(blockwise=True)
    p = fx.sample(torch.Generator().manual_seed(0), 4)
    rng = np.random.default_rng(2)
    R, T = 4 * 2, 3 * 4096 + 100
    x = torch.from_numpy((rng.standard_normal((4, 2, T)) * 0.3).astype(np.float32))
    lanes = {}

    def capture(xl, *args):
        lanes["args"] = (xl, *args)
        return compressor_envelope(xl, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(comp, "compressor_envelope", capture)
        before = compressor_envelope.launches
        got = fx.apply({k: v.to(card) for k, v in p.items()}, x.to(card)).cpu()
        assert compressor_envelope.launches == before + 1
    xl, *prm = lanes["args"]
    assert tuple(xl.shape) == (R * 4, 8192 + 4096)
    want, _ = envelope_reference(*(v.double() for v in (xl, *prm)))
    want = want[:, 8192:].reshape(R, -1)[:, :T].reshape(4, 2, T).float().cpu()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= ENVELOPE_TOL * scale
    assert (fx.apply(p, x) - got).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_compand_scan_on_the_card(card):
    """``compand`` and ``lufs_normalize_compand`` at [2, 2^16] on audio
    within full scale (peak 0.9): the card's chunked scan within 1e-5 of
    max|float64| of a float64 serial run on the CPU. Above full scale the
    reference's curve climbs 20 dB in its last 0.1 dB (slope 200), which
    multiplies any float32 walk's rounding: the card there stays within 3x
    of the CPU's float32 serial walk's own distance from float64."""
    from music_mixing_style_transfer_tpu_torch.ops.compressor import compand
    from music_mixing_style_transfer_tpu_torch.ops.loudness import lufs_normalize_compand

    rng = np.random.default_rng(3)
    T = 2**16
    env = np.abs(np.sin(np.linspace(0, 7, T))) ** 3
    loud = (rng.standard_normal((2, T)) * 0.6 * (0.003 + env)).astype(np.float32)
    x = torch.from_numpy(loud * (0.9 / np.abs(loud).max()))

    def err(a, b):
        return (a.double().cpu() - b).abs().max().item() / b.abs().max().item()

    for fn in (compand, lambda y: lufs_normalize_compand(y, 44100, -14.0)):
        want = fn(x.double())
        got = fn(x.to(card))
        assert got.dtype == torch.float32 and err(got, want) <= 1e-5
    hot = torch.from_numpy(loud)  # peaks ~2.6, +8 dBFS
    want = compand(hot.double())
    assert err(compand(hot.to(card)), want) <= 3 * err(compand(hot), want)


@pytest.mark.cuda
def test_time_fx_card_matches_cpu(card):
    """Each time-FX processor at [2, 2^15] with one numpy-drawn parameter
    set, card against CPU within 1e-4 of max|cpu|; ``bend`` at its drawn
    segments."""
    from music_mixing_style_transfer_tpu_torch.fx import timefx

    rng = np.random.default_rng(4)
    T = 2**15
    x = torch.from_numpy((rng.standard_normal((2, T)) * 0.3).astype(np.float32))
    draw = np.random.default_rng(5)
    for fx in (timefx.PitchShift(), timefx.TimeStretch(), timefx.PlaybackSpeed(), timefx.Bend()):
        params = fx.sample_host(draw, T) if isinstance(fx, timefx.Bend) else fx.sample_host(draw)
        cpu = fx.apply(params, x)
        got = fx.apply(params, x.to(card)).cpu()
        assert got.shape == cpu.shape == (2, T)
        assert (got - cpu).abs().max().item() <= 1e-4 * cpu.abs().max().item(), (fx.name, params)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_runs_k1_on_halo_chunks(card, n):
    """``infer/seqpar.py`` on a mesh of n entries of the one card: K1 runs
    on each shard's extended chunk (one launch a shard for the one
    128-channel block of dilation 8), and the result equals one forward
    within 1e-5 of its max."""
    from music_mixing_style_transfer_tpu_torch.config import TCNConfig
    from music_mixing_style_transfer_tpu_torch.infer.seqpar import make_seq_parallel_converter
    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.parallel import create_mesh
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    model = fast_init(MixFXcloner(TCNConfig(condition_dimension=16, nblocks=4, kernel_size=15)),
                      seed=n).to(card).eval()
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal((2, 2, 4096)) * 0.3).astype(np.float32)).to(card)
    cond = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32)).to(card)
    with full_float32(), torch.inference_mode():
        single = model(x, cond)
    fn = make_seq_parallel_converter(model, create_mesh(n, ["cuda:0"] * n))
    before = tcn_block.launches
    out = fn(x.transpose(1, 2), cond).transpose(1, 2)
    assert tcn_block.launches - before == n
    assert float((out - single).abs().max()) <= 1e-5 * float(single.abs().max())


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(card, tmp_path):
    """Two ranks of the data-parallel contrastive step on ``cuda:0`` over
    gloo (NCCL refuses two ranks on one device): the loss and the averaged
    gradients equal the one-process step's on the card (no BN: per-rank
    batch statistics differ by design), within 1e-5."""
    from torch_ddp_workers import _plain_weights, card_contrastive_step, run_ranks

    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.train.contrastive import contrastive_loss_fn
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    fields = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1), norm="none")
    rng = np.random.default_rng(0)
    a, b = ((rng.standard_normal((2, 4, 2, 4096)) * 0.2).astype(np.float32) for _ in range(2))
    ranks = run_ranks(card_contrastive_step, 2, str(tmp_path), (fields, a, b), timeout=180)
    model = FXencoder(FXencoderConfig(**fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _plain_weights(fields).items()})
    model = model.to(card).train()
    with full_float32():
        loss = contrastive_loss_fn(model, torch.from_numpy(a).to(card), torch.from_numpy(b).to(card), 0.1)
        loss.backward()
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for name, p in model.named_parameters():
            want = p.grad.cpu().numpy()
            assert np.abs(r["grads"][name] - want).max() <= 1e-5 * np.abs(want).max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sefa_edited_conditions_run_k1_per_block(card, dtype):
    """SeFa edits on two fused blocks (``models/sefa.py``): the converter
    takes each block's own condition through K1 (one launch a fused block)
    and matches the block-by-block plain path (1e-4 of max in float32; 2e-2
    NRMSE in bf16, the K1 bf16 tolerance); an edit changes the output."""
    from music_mixing_style_transfer_tpu_torch.config import TCNConfig
    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.models.sefa import sefa_per_block_conditions
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import converter_plain
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    model = fast_init(MixFXcloner(TCNConfig(condition_dimension=16, nblocks=6)), seed=3)
    model = model.to(card, dtype).eval()
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((2, 2, 8192)) * 0.3).astype(np.float32)).to(card, dtype)
    cond = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32)).to(card, dtype)
    # strengths that keep the output inside the clamp (this FiLM's eigenvalues are ~16-30)
    conds = sefa_per_block_conditions(cond, model, {3: (0, 0.1), 5: (1, -0.1)})
    with full_float32(), torch.inference_mode():
        before = tcn_block.launches
        got = model(x, conds).float()
        assert tcn_block.launches - before == 3  # blocks 3-5
        want = converter_plain(model, x, conds).float()
        base = model(x, cond).float()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    else:
        nrmse = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
        assert nrmse < 2e-2
    assert float((got - base).abs().max()) > 1e-3


@pytest.mark.cuda
def test_normalizer_at_48k_card_matches_cpu(card):
    """``normalize_device`` at 48 kHz (the imager's Haas draw at that
    rate, K2 in the compression matching) on a short 4-stem song with one
    near-mono stem, with the shipped features (so the default FFT size):
    the card within 1e-4 of max|cpu| and the same compression choices."""
    import os

    from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
    from music_mixing_style_transfer_tpu_torch.normalize.batch import BatchedAudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.normalize.features import load_fx_features

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "music_mixing_style_transfer_tpu_torch", "weights",
                        "musdb18_fxfeatures_eqcompimagegain.npy")
    cfg = NormalizationConfig(sample_rate=48000)
    features = load_fx_features(path, stems=cfg.stems)
    rng = np.random.default_rng(48)
    stems = {inst: _music(rng, 2**15, 0.3) for inst in cfg.stems}
    stems["bass"][1] = stems["bass"][0] + 0.01 * stems["bass"][1]  # near mono: the Haas branch
    out, choice = {}, {}
    for dev in ("cuda", "cpu"):
        norm = BatchedAudioEffectsNormalizer(features, cfg, device=dev)
        before = compressor_envelope.launches
        out[dev] = norm.normalize_stems(stems)
        choice[dev] = norm.last_compression
        out[dev + "_launches"] = compressor_envelope.launches - before
    assert out["cuda_launches"] > 0 and out["cpu_launches"] == 0
    for k in ("ratio", "threshold", "active"):
        assert np.array_equal(choice["cuda"][k], choice["cpu"][k]), k
    for inst in cfg.stems:
        err = np.abs(out["cuda"][inst] - out["cpu"][inst]).max()
        assert np.isfinite(out["cuda"][inst]).all()
        assert err <= 1e-4 * np.abs(out["cpu"][inst]).max(), inst
