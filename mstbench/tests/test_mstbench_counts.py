"""The yardstick's arithmetic against the numbers it was frozen from."""
import json
import os

import pytest

from mstbench.harness import HERE
from mstbench.metrics.counts import (
    converter_flops_per_sample, encoder_flops_per_sample, k1_bound_s, k2_bound_s)


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config", ["mst_serve_bf16", "mst_train_f32"])
def test_model_flops_a_sample(config):
    cfg = _config(config)
    assert converter_flops_per_sample(cfg["converter"]) == 6_397_952
    assert encoder_flops_per_sample(cfg["encoder"]) == 109_080


@pytest.mark.parametrize("bf16,want_ms", [(True, 1.03), (False, 6.19)])
def test_k1_bound_at_the_song_shape(bf16, want_ms):
    """The mean over blocks 3-13's dilations at [4, 2^19, 128]: chip_smoke's
    figures (PERF.md's kernel table)."""
    got = sum(k1_bound_s(4, 2**19, 2**k, bf16) for k in range(3, 14)) / 11 * 1e3
    assert got == pytest.approx(want_ms, rel=5e-3)


@pytest.mark.parametrize("L,T,R,want_ms", [(1024, 262144, 8, 0.323), (8, 655360, None, 0.0125)])
def test_k2_bound_at_the_normalizer_shapes(L, T, R, want_ms):
    assert k2_bound_s(L, T, R) * 1e3 == pytest.approx(want_ms, rel=5e-3)
