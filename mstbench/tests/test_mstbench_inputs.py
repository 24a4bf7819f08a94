"""Inputs made from the seed: the same seed gives the same inputs, and the
grids give the lengths and buckets that PERF.md reckons with."""
import json
import os

import numpy as np
import pytest
import torch

from mstbench import weights
from mstbench.harness import HERE, sub_seed
from mstbench.songs import SR, synth_song, to_pcm16


def _traffic(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def test_songs_follow_the_seed():
    seed = 2**40 + 3  # more than 32 bits, as the driver's seeds are
    a, b = synth_song(seed, SR, "cpu"), synth_song(seed, SR, "cpu")
    assert torch.equal(a, b) and a.shape == (4, 2, SR)
    assert not torch.equal(a, synth_song(seed + 1, SR, "cpu"))
    assert float(a.abs().max()) == pytest.approx(0.7)
    assert to_pcm16(a).dtype == torch.int16


def test_weights_follow_the_seed():
    m = torch.nn.Sequential(torch.nn.Conv1d(2, 4, 3), torch.nn.BatchNorm1d(4), torch.nn.Linear(5, 6))
    s1 = weights.seeded_state(m, 7, "cpu", torch.bfloat16)
    s2 = weights.seeded_state(m, 7, "cpu", torch.bfloat16)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(s1["0.weight"], weights.seeded_state(m, 8, "cpu")["0.weight"])
    assert torch.equal(s1["0.weight"], s1["0.weight"].bfloat16().float())
    assert float(s1["0.weight"].abs().max()) <= 1 / np.sqrt(6)
    weights.load(m, s1)
    assert torch.equal(m[1].running_var, s1["1.running_var"])


def test_sub_seeds_differ_by_use():
    assert sub_seed(5, "input", 0) == sub_seed(5, "input", 0)
    assert len({sub_seed(5, t, i) for t in ("input", "reference") for i in range(10)}) == 20
    assert 0 <= sub_seed(2**40, "x") < 2**63


def test_grid_is_ten_lengths_from_two_to_six_minutes():
    lengths = _traffic("full_songs")["lengths_s"]
    assert len(lengths) == 10 and lengths[0] == 120 and lengths[-1] == 360
    assert np.allclose(np.diff(lengths), 240 / 9, atol=1e-3)
    assert np.mean(lengths) == pytest.approx(240.0, abs=1e-3)


def test_grid_buckets():
    """Segments of 2^19 and the engine's buckets: a song's 4 stems go in one
    converter dispatch (three songs to bucket 64, seven to 128)."""
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import _bucket

    n = [-(-int(round(s * SR)) // 2**19) for s in _traffic("full_songs")["lengths_s"]]
    assert n == [11, 13, 15, 17, 20, 22, 24, 26, 29, 31]
    assert [_bucket(4 * k) for k in n] == [64] * 3 + [128] * 7
