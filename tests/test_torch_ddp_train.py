"""PyTorch port: both training loops at 2 ranks over gloo against the
one-process run, on the CPU (the workers in ``torch_ddp_workers.py``
import no JAX).

One tiny corpus, two instruments, segments of 4096 samples,
``batch_items`` 2 (each rank one item a step): ``train_fxencoder`` for an epoch of 2 steps and a resume
to a second, ``train_converter`` for an epoch of 2 steps, once at 2 ranks
and once in one process (no group), both ``fused``, both at the same time.
The encoder has no BN (JAX's ``norm="none"``), and the converter runs in
both runs with BN's training mode replaced by its affine and the RMS loss
(a product of two batch means) by the mean of its per-row terms
(``torch_ddp_workers.batch_linear_converter``): with the originals, W
ranks compute the mean of per-rank losses (JAX's ``pmean``, the
reference's DDP), which is not the one-process loss of the global batch;
per-rank batch statistics differ from the global batch's by design, and
the JAX package's mesh tests leave BN out for the same reason. The steps
with BN and the RMS loss are held against JAX's sharded steps in
``tests/test_torch_ddp.py``.

Tolerances: each epoch's loss and held-out loss within 1e-5 of the one-
process run's; every final parameter within 2*lr a step of the
one-process run's (Adam's first moves are ~lr*sign(g), and where a
gradient is ~0 the two runs' rounding picks the sign). The errors that
the world size raises match the JAX package's words.
"""
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.parallel import create_mesh as j_create_mesh
from music_mixing_style_transfer_tpu.train.fused import FusedContrastivePipeline as JaxPipeline
from music_mixing_style_transfer_tpu_torch.data.wavio import write_wav
from torch_ddp_workers import Ranks, train_runs

torch.set_num_threads(2)
INSTS = ("drums", "bass", "other", "vocals")
SEG = 4096
SMALL = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
PLAIN = dict(SMALL, norm="none")
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
LR = 2e-4  # TrainConfig's default learning rate



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_train")
    rng = np.random.default_rng(3)
    for mode in ("train", "val"):
        (root / "corpus" / mode).mkdir(parents=True)
        for inst in INSTS:
            for part, T in enumerate((SEG * 5, SEG * 3 + 123)):
                write_wav(str(root / "corpus" / mode /
                              f"{inst}_normalized_eqcompimagegain_silence_trimmed{part}.wav"),
                          (rng.standard_normal((T, 2)) * 0.2).astype(np.float32), 44100)
    args = (str(root / "corpus"), str(root), SMALL, PLAIN, TCN, SEG)
    two = Ranks(train_runs, 2, str(root), args)
    one = Ranks(train_runs, 1, str(root), args, group=False)  # at the same time
    return {"two": two.wait(240), "one": one.wait(240)[0]}


@pytest.mark.parametrize("model", ["fxencoder", "converter"])
def test_two_rank_epochs_give_the_one_process_losses(runs, model):
    one = runs["one"][model]["records"]
    two = runs["two"][0][model]["records"]
    assert [r["epoch"] for r in two] == [r["epoch"] for r in one] == list(range(len(one)))
    for got, want in zip(two, one):
        assert got["world_size"] == 2 and "world_size" not in want  # one process: JAX's keys
        assert [r["max_memory_gb"] for r in got["ranks"]] == [None, None]  # the CPU
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), got["epoch"]
        assert abs(got["val_loss"] - want["val_loss"]) <= 1e-5 * abs(want["val_loss"]), got["epoch"]
    steps = runs["one"][model]["step"]
    for rank, r in enumerate(runs["two"]):
        assert r[model]["step"] == steps, rank
        for name, want in runs["one"][model]["after"].items():
            got = r[model]["after"][name]
            if "running" in name or "num_batches" in name:
                assert np.array_equal(got, want), (rank, name)  # BN's affine stand-in: untouched
                continue
            # Adam moves each parameter ~lr*sign(g) a step: where g ~ 0, rounding picks the sign
            assert np.abs(got - want).max() <= 2 * LR * steps, (rank, name)


@pytest.mark.parametrize("model", ["fxencoder", "converter"])
def test_each_rank_reads_only_its_own_items(runs, model):
    """Item j of a batch of 2 is rank j's; the ranks together read what the
    one process reads, and no item twice."""
    one = runs["one"][model]["items"]
    per_rank = [r[model]["items"] for r in runs["two"]]
    assert sorted(per_rank[0] + per_rank[1]) == sorted(one)
    for rank, items in enumerate(per_rank):
        assert items and all(idx % 2 == rank for _, idx in items), (rank, items)


def test_rank_zero_alone_writes_checkpoints_and_the_resume_runs_on(runs):
    (r0, r1) = runs["two"]
    assert r0["fxencoder"]["saves"] == [1, 2] and r1["fxencoder"]["saves"] == []
    assert r0["converter"]["saves"] == [1] and r1["converter"]["saves"] == []
    assert r1["fxencoder"]["records"] is None  # only rank 0 read its metrics back
    # the second call resumed from epoch 1 on both ranks: 2 steps, then 2 more
    assert r0["fxencoder"]["step"] == r1["fxencoder"]["step"] == 4
    for name, v in r0["fxencoder"]["after"].items():
        assert np.array_equal(v, r1["fxencoder"]["after"][name]), name  # one model, not two


def test_world_size_errors_match_jax(runs):
    pipe = JaxPipeline(None, None, 0.1, mesh=j_create_mesh(2))
    pipe.set_chains({}, (), 0)
    with pytest.raises(ValueError, match="mesh size") as e:
        pipe.step(None, np.zeros((4, 3, 2, 2, 8), np.int16), np.zeros((4, 3, 2, 2), np.uint32),
                  np.zeros(6, np.int32), np.zeros(6, np.int32), 4, 4)
    for rank, r in enumerate(runs["two"]):
        errors = r["errors"]
        assert errors["shard"] == errors["train_fxencoder"] == str(e.value), rank
        assert "2 ranks" in errors["no_mesh"] and "never" in errors["no_mesh"], rank
