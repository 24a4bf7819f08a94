"""PyTorch port: the contrastive pair and style-transfer triplet datasets,
the prefetcher, the training loop and the training CLI, on the CPU, on a
tiny synthetic MUSDB-layout corpus.

The host-side numpy draws (files, starts, the crop plan) are the JAX
package's code: segments and crop plans must equal its own bit for bit.
The FX plans come from ``torch.Generator``s seeded per item, so a run
repeats from its seed. The loop and the CLI (``--device cpu``) train
``SMALL_ENC`` for 2 epochs of 2 steps and resume to a third: finite losses,
``metrics.jsonl`` records with the JAX package's keys, keep-N checkpoints.

The triplets (``augment_triplets``): A1 is content A as read, A2 and B2
one draw applied to both contents; the fast path equals the generic walk
(2e-5 of max); and one instrument's chain replayed from JAX's keys
(``test_torch_fastpath.py:jax_plan``) equals JAX's own ``augment_triplets``,
jitted, 1e-4 of max|jax|, for an eq/comp shuffle (never JAX's 4-instrument
program: minutes to compile on the CPU).
"""
import json
import os

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.data import datasets as jds
from music_mixing_style_transfer_tpu.data.wavio import write_wav
from music_mixing_style_transfer_tpu.train.loop import schedule_probs as j_schedule_probs
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TrainConfig
from music_mixing_style_transfer_tpu_torch.data import datasets as pds
from music_mixing_style_transfer_tpu_torch.data.prefetch import BatchPrefetcher
from music_mixing_style_transfer_tpu_torch.train import cli
from music_mixing_style_transfer_tpu_torch.train.fused import augment_triplets
from music_mixing_style_transfer_tpu_torch.train.loop import schedule_probs, train_fxencoder

torch.set_num_threads(2)
INSTS = ("drums", "bass", "other", "vocals")
SR = 44100
SEG = 4096
SMALL = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
JAX_RECORD_KEYS = {"model", "epoch", "loss", "lr", "probs", "wall", "time", "val_loss"}


@pytest.fixture(scope="module")
def musdb_dir(tmp_path_factory):
    """``<dir>/<mode>/<inst>_normalized_eqcompimagegain_silence_trimmed*.wav``,
    16-bit PCM, files longer and shorter than a loaded segment."""
    root = tmp_path_factory.mktemp("musdb")
    rng = np.random.default_rng(0)
    for mode in ("train", "val"):
        (root / mode).mkdir()
        for inst in INSTS:
            for part, T in enumerate((SEG * 5, SEG * 3 + 123, SEG)):
                x = (rng.standard_normal((T, 2)) * 0.2).astype(np.float32)
                write_wav(str(root / mode / f"{inst}_normalized_eqcompimagegain_silence_trimmed{part}.wav"),
                          x, SR)
    return str(root)


def _pair(musdb_dir, mode="train"):
    kw = dict(mode=mode, instruments=INSTS, segment_length=SEG, num_strong_negatives=1)
    return (jds.ContrastivePairDataset(musdb_dir, **kw),
            pds.ContrastivePairDataset(musdb_dir, **kw))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_raw_batch_segments_equal_jax_bit_for_bit(musdb_dir, mode):
    jd, pd = _pair(musdb_dir, mode)
    for epoch_seed in (None, 3):
        want, _ = jd.sample_raw_batch([0, 5, 2], epoch_seed=epoch_seed)
        got, plans = pd.sample_raw_batch([0, 5, 2], epoch_seed=epoch_seed)
        assert got.dtype == want.dtype == np.int16  # 16-bit sources travel as int16
        np.testing.assert_array_equal(got, want)
        # plans: per instrument 3 items x K = 2 draws, reproducible from the seeds
        again = pd.batch_plans([0, 5, 2], epoch_seed)
        assert plans["drums"]["stages"][0]["gate"].shape == (6,)
        assert torch.equal(plans["vocals"]["stages"][3]["fx"]["gain_db"],
                           again["vocals"]["stages"][3]["fx"]["gain_db"])
        # item 5's draws are its own, whatever the batch
        alone = pd.batch_plans([5], epoch_seed)
        assert torch.equal(plans["bass"]["stages"][0]["fx"]["stages"][0]["fx"]["low_shelf_gain"][2:4],
                           alone["bass"]["stages"][0]["fx"]["stages"][0]["fx"]["low_shelf_gain"])
    assert pd._seed_for(7, 3) == jd._seed_for(7, 3)
    np.testing.assert_array_equal(pd.files.weights["other"], jd.files.weights["other"])


def test_float_sources_and_transport_match_jax(rng):
    x = (rng.standard_normal((2, 3, 2, 2, 64)) * 0.3).astype(np.float32)
    q = np.round(x * 32768).astype(np.float32) / 32768
    for segs in (x, q):
        for transport in ("auto", "int16", "float32"):
            got, want = pds.to_transport(segs, transport), jds.to_transport(segs, transport)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pds.to_transport(x, "bf16")
    for n in (0, 4095, 4096, 9000, 131071):
        assert pds._bucket_length(n) == jds._bucket_length(n)
        assert pds._bucket_length(n, 16384) == jds._bucket_length(n, 16384)
    assert pds.PAD_B4_MANIPULATION == jds.PAD_B4_MANIPULATION


def test_crop_plan_and_collate_equal_jax(musdb_dir):
    jd, pd = _pair(musdb_dir)
    for quantum in (None, 1024):
        jr, pr = np.random.default_rng(11), np.random.default_rng(11)
        for _ in range(3):
            la, lb, sa, sb = pd.collate_plan(6, pr, quantum)
            wa, wb, wsa, wsb = jd.collate_plan(6, jr, quantum)
            assert (la, lb) == (wa, wb)
            np.testing.assert_array_equal(sa, wsa)
            np.testing.assert_array_equal(sb, wsb)
    rng = np.random.default_rng(2)
    batch_a = {i: rng.standard_normal((4, 2, SEG)).astype(np.float32) for i in INSTS}
    batch_b = {i: rng.standard_normal((4, 2, SEG)).astype(np.float32) for i in INSTS}
    got = pd.collate_random_duration(batch_a, batch_b, np.random.default_rng(5), 1024)
    want = jd.collate_random_duration(batch_a, batch_b, np.random.default_rng(5), 1024)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_missing_files_and_schedule(tmp_path):
    with pytest.raises(FileNotFoundError, match="no files match"):
        pds.ContrastivePairDataset(str(tmp_path), instruments=("drums",))
    init, tgt = {"eq": 0.9, "comp": 0.9}, {"eq": 0.1}
    for epoch in range(5):
        assert schedule_probs(init, tgt, epoch, 5) == j_schedule_probs(init, tgt, epoch, 5)


def test_batch_prefetcher_order_and_errors():
    assert list(BatchPrefetcher(lambda i: i * i, 5)) == [0, 1, 4, 9, 16]

    def boom(i):
        if i == 2:
            raise ValueError("boom")
        return i

    got = []
    with pytest.raises(ValueError, match="boom"):
        for v in BatchPrefetcher(boom, 5):
            got.append(v)
    assert got == [0, 1]


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_fxencoder_trains_resumes_and_keeps_n(musdb_dir, tmp_path):
    run = str(tmp_path / "run")
    kw = dict(encoder_cfg=FXencoderConfig(**SMALL), train_cfg=TrainConfig(segment_length=SEG),
              steps_per_epoch=2, batch_items=1, keep_ckpts=2, device="cpu")
    state = train_fxencoder(musdb_dir, run, epochs=2, prob_schedule_target={"eq": 0.5}, fused=True, **kw)
    assert state.step == 4
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["step_00000001.pt", "step_00000002.pt"]
    recs = _records(run)
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(JAX_RECORD_KEYS <= set(r) and np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
               for r in recs)
    assert recs[0]["probs"]["eq"] == 0.9 and recs[1]["probs"]["eq"] == 0.5
    assert {"step", "host", "epoch", "synced_step", "synced_augment", "synced_train_step"} <= set(recs[0]["wall"])
    # the CPU walks K2's plain version
    assert recs[0]["launches"] == {"compressor_envelope": 0, "compressor_envelope_synced_step": 0,
                                   "compressor_envelope_val": 0}

    # resume: picks up after epoch 2 and runs the third (the generic walk this time)
    state = train_fxencoder(musdb_dir, run, epochs=3, fused=False, **kw)
    assert state.step == 6
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["step_00000002.pt", "step_00000003.pt"]
    assert [r["epoch"] for r in _records(run)] == [0, 1, 2]


def test_training_cli_on_the_cpu(musdb_dir, tmp_path, capsys):
    run = str(tmp_path / "cli")
    argv = ["fxencoder", "--data_dir", musdb_dir, "--out_dir", run, "--epochs", "1",
            "--steps_per_epoch", "1", "--batch_items", "1", "--segment_length", str(SEG),
            "--fused", "--device", "cpu", "--val_every", "0", "--lr_schedule", "warmup_cosine",
            "--lr_warmup_steps", "1", "--encoder_config", json.dumps(SMALL)]
    assert cli.main(argv) == 0
    (rec,) = _records(run)
    assert JAX_RECORD_KEYS - {"val_loss"} <= set(rec) and "val_loss" not in rec
    assert rec["lr"] == pytest.approx(2e-4)  # the cosine's peak, after one warmup step
    assert os.listdir(os.path.join(run, "ckpt")) == ["step_00000001.pt"]
    with pytest.raises(SystemExit):
        cli.main(["converter", "--data_dir", musdb_dir, "--out_dir", run])
    assert "converter training requires --encoder_ckpt" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["fxencoder", "--data_dir", str(tmp_path / "absent"), "--out_dir", run])


# ---------------------------------------------------------------------------
# StyleTransferTripletDataset and augment_triplets
# ---------------------------------------------------------------------------
def _triplets(musdb_dir, mode="train"):
    kw = dict(mode=mode, instruments=INSTS, segment_length=SEG)
    return (jds.StyleTransferTripletDataset(musdb_dir, **kw),
            pds.StyleTransferTripletDataset(musdb_dir, device="cpu", **kw))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_triplet_raw_batch_segments_equal_jax_bit_for_bit(musdb_dir, mode):
    jd, pd = _triplets(musdb_dir, mode)
    assert len(pd) == len(jd) > 0
    for epoch_seed in (None, 4):
        want, _ = jd.sample_raw_batch([0, 3, 1], epoch_seed=epoch_seed)
        got, plans = pd.sample_raw_batch([0, 3, 1], epoch_seed=epoch_seed)
        assert got.dtype == want.dtype == np.int16 and got.shape == (4, 3, 2, 2, SEG + 2 * pd.pad)
        np.testing.assert_array_equal(got, want)
        # one draw per (instrument, item); item 3's is its own whatever the batch
        assert plans["drums"]["stages"][0]["gate"].shape == (3,)
        alone = pd.batch_plans([3], epoch_seed)
        assert torch.equal(plans["vocals"]["stages"][3]["fx"]["gain_db"][1:2],
                           alone["vocals"]["stages"][3]["fx"]["gain_db"])
    assert pd._seed_for(9, 4) == jd._seed_for(9, 4)


def test_triplets_share_one_draw_and_fast_equals_generic(musdb_dir):
    _, pd = _triplets(musdb_dir)
    segs, plans = pd.sample_raw_batch([0, 1], epoch_seed=2)
    x, sl = torch.from_numpy(segs), slice(pd.pad, pd.pad + SEG)
    generic = augment_triplets(pd.manipulators, INSTS, x, plans, pd.pad, SEG, fast=False)
    fast = augment_triplets(pd.manipulators, INSTS, x, plans, pd.pad, SEG, fast=True)
    for g, f in zip(generic, fast):
        assert g.shape == (8, 2, SEG) and float(g.abs().max()) <= 1.0
        scale = float(g.abs().max())
        assert float((f - g).abs().max()) <= 2e-5 * scale
    # A1: content A as read (instrument-major), trimmed of the pad
    want_a1 = (x.float() / 32768.0)[:, :, 0, :, sl].reshape(8, 2, SEG)
    assert torch.equal(generic[0], want_a1.clamp(-1.0, 1.0))
    assert not torch.equal(generic[1], generic[0])  # the draws changed A2
    # A2 and B2 come from one draw: equal contents give equal outputs
    same = x.clone()
    same[:, :, 1] = same[:, :, 0]
    for fast_path in (False, True):
        _, a2, b2 = augment_triplets(pd.manipulators, INSTS, same, plans, pd.pad, SEG, fast=fast_path)
        assert float((a2 - b2).abs().max()) <= 1e-6 * float(a2.abs().max())
    # sample_batch is the generic walk of the same raw batch, per instrument
    batch = pd.sample_batch([0, 1], epoch_seed=2)
    for i, inst in enumerate(INSTS):
        for k, v in zip(("a1", "a2", "b2"), generic):
            np.testing.assert_array_equal(batch[inst][k], v[2 * i : 2 * i + 2].numpy())


def test_triplet_chain_replayed_from_jax_keys_equals_jax(musdb_dir):
    import jax

    from music_mixing_style_transfer_tpu.fx import factory as jfactory
    from music_mixing_style_transfer_tpu.train.fused import augment_triplets as j_augment
    from music_mixing_style_transfer_tpu_torch.fx import factory as pfactory
    from test_torch_fastpath import jax_plan

    names = [("eq", 0.9, "eq"), ("comp", 0.9, "comp")]
    jchain = jfactory.create_effects_augmentation_chain(names, shuffle=True)
    pchain = pfactory.create_effects_augmentation_chain(names, shuffle=True)
    jd, pd = _triplets(musdb_dir)
    segs, keys = jd.sample_raw_batch([0, 1, 2], epoch_seed=5)
    inst = "vocals"
    i = INSTS.index(inst)
    want = jax.jit(lambda s, k: j_augment({inst: jchain}, (inst,), s, k, jd.pad, SEG, fast=False))(
        segs[i : i + 1], keys[i : i + 1])
    plan = jax_plan(jchain, np.asarray(keys[i]))
    got = augment_triplets({inst: pchain}, (inst,), torch.from_numpy(segs[i : i + 1]), {inst: plan},
                           pd.pad, SEG)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (3, 2, SEG)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * float(np.abs(w).max())
