"""PyTorch port: the fused TCN block's plain version and MixFXcloner vs the
JAX package, on the CPU.

``tcn_block_reference`` is what the CUDA kernel is held against on the card,
so here it is held against the Pallas kernel (interpret mode, as the JAX
package's own tests run it) and against the flax block. Tolerance: float32,
1e-4. The kernel itself is tested on the card in ``test_torch_cuda.py``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import TCNConfig as JaxTCNConfig
from music_mixing_style_transfer_tpu.models import MixFXcloner as JaxMixFXcloner
from music_mixing_style_transfer_tpu.models import TCNBlock as JaxTCNBlock
from music_mixing_style_transfer_tpu.models.fast_init import fast_init as jax_fast_init
from music_mixing_style_transfer_tpu.ops.pallas.tcn_block import fused_tcn_block
from music_mixing_style_transfer_tpu_torch.config import TCNConfig
from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
from music_mixing_style_transfer_tpu_torch.models.weights import mixfxcloner_from_jax
from music_mixing_style_transfer_tpu_torch.ops.cuda import build
from music_mixing_style_transfer_tpu_torch.ops.cuda.k1_variants import VARIANTS, variant_source
from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import (
    block_epilogue,
    dilated_conv,
    fused_block_applicable,
    round_tf32,
    split_tf32,
    tcn_block,
    tcn_block_reference,
)

torch.set_num_threads(2)
C, K = 128, 15


def _block_inputs(rng, B, T):
    return dict(
        x=(rng.standard_normal((B, T, C)) * 0.3).astype(np.float32),
        w=(rng.standard_normal((K, C, C)) * 0.05).astype(np.float32),
        s=(rng.standard_normal(C) * 0.2 + 1).astype(np.float32),
        t=(rng.standard_normal(C) * 0.1).astype(np.float32),
        r=(rng.standard_normal((B, C)) * 0.2 + 1).astype(np.float32),
        b=(rng.standard_normal((B, C)) * 0.1).astype(np.float32),
        wr=(rng.standard_normal(C) * 0.3).astype(np.float32),
    )


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def test_reference_matches_pallas_kernel(rng):
    a = _block_inputs(rng, 2, 4096)
    want = np.asarray(
        fused_tcn_block(**{k: jnp.asarray(v) for k, v in a.items()}, d=8, interpret=True)
    )
    got = tcn_block_reference(**_torch(a), d=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_split_tf32_is_exact_and_rounds_ties_away(rng):
    w = torch.from_numpy(
        (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    )
    big, small = split_tf32(w)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(big + small, w)
    assert (small.abs() <= big.abs() * 2.0**-11).all()
    # 1 + 2^-11 is halfway between two tf32 values: ties go away from zero
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12], dtype=torch.float32)
    assert round_tf32(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1.0]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_k1_variants_apply_to_the_kernel_source(name):
    """Every edit of a timed variant still matches csrc/tcn_block.cu."""
    with open(os.path.join(build.CSRC_DIR, "tcn_block.cu")) as f:
        src = f.read()
    assert (variant_source(src, VARIANTS[name]) == src) == (name == "shipped")
    with pytest.raises(ValueError):
        variant_source(src, [("no such line", "", 1)])


@pytest.mark.parametrize("d", [8, 1024])  # 1024: T = 4096 < 7*d, edge taps all zero
def test_3xtf32_matches_pallas_kernel_and_float64(rng, d):
    """The kernel's float32 arithmetic, emulated: both operands split with
    ``split_tf32`` (small parts rounded to tf32, as the kernel takes them),
    small*big + big*small + big*big through ``F.conv1d`` (each product of
    two tf32 values is exact in float32), then the same epilogue. Within
    1e-4 of the Pallas kernel (interpret mode) and 1e-5 of max|float64|."""
    a = _block_inputs(rng, 2, 4096)
    ta = _torch(a)
    xb, xs = split_tf32(ta["x"])
    wb, ws = split_tf32(ta["w"])
    xs, ws = round_tf32(xs), round_tf32(ws)
    h = dilated_conv(xs, wb, d) + dilated_conv(xb, ws, d) + dilated_conv(xb, wb, d)
    got = block_epilogue(h, ta["x"], *(ta[k] for k in "strb"), ta["wr"])
    want = np.asarray(
        fused_tcn_block(**{k: jnp.asarray(v) for k, v in a.items()}, d=d, interpret=True)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    t64 = {k: v.double() for k, v in ta.items()}
    y64 = block_epilogue(
        dilated_conv(t64["x"], t64["w"], d), t64["x"], *(t64[k] for k in "strb"), t64["wr"]
    )
    assert (got.double() - y64).abs().max().item() <= 1e-5 * y64.abs().max().item()


def _flax_block(rng, d, cond_dim=16):
    blk = JaxTCNBlock(
        in_ch=C, out_ch=C, kernel_size=K, dilation=d, cond_dim=cond_dim,
        channels_last=True, fused="off",
    )
    v = jax_fast_init(blk, jnp.zeros((1, 64, C)), jnp.zeros((1, cond_dim)), seed=d)
    p = v["params"]
    p["bn"]["bias"] = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.float32)
    v["batch_stats"]["bn"]["mean"] = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.float32)
    v["batch_stats"]["bn"]["var"] = jnp.asarray(rng.uniform(0.5, 2.0, C), jnp.float32)
    return blk, v


@pytest.mark.parametrize(
    "d,T",
    [
        (1, 1000),   # no dilation
        (8, 4096),   # first kernel dilation, T a multiple of d
        (8, 1001),   # T not a multiple of d
        (64, 300),   # T < 7*d: both zero halos cover every tap's edge
        (64, 1000),  # T not a multiple of d, several tiles of rows
    ],
)
def test_reference_matches_flax_block(rng, d, T):
    blk, v = _flax_block(rng, d)
    B = 2
    x = (rng.standard_normal((B, T, C)) * 0.3).astype(np.float32)
    cond = (rng.standard_normal((B, 16)) * 0.5).astype(np.float32)
    want = np.asarray(blk.apply(v, jnp.asarray(x), jnp.asarray(cond)))

    p, st = v["params"], v["batch_stats"]
    s = np.asarray(p["bn"]["scale"]) / np.sqrt(np.asarray(st["bn"]["var"]) + 1e-5)
    t = np.asarray(p["bn"]["bias"]) - np.asarray(st["bn"]["mean"]) * s
    film = cond @ np.asarray(p["film"]["weight"]).T + np.asarray(p["film"]["bias"])
    got = tcn_block_reference(
        torch.from_numpy(x),
        torch.from_numpy(np.asarray(p["conv1_weight"]).transpose(2, 1, 0).copy()),
        torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(film[:, :C].copy()), torch.from_numpy(film[:, C:].copy()),
        torch.from_numpy(np.asarray(p["res_weight"])[:, 0, 0].copy()),
        d=d,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch(rng):
    a = _torch(_block_inputs(rng, 1, 256))
    before = tcn_block.launches
    torch.testing.assert_close(tcn_block(**a, d=16), tcn_block_reference(**a, d=16))
    assert tcn_block.launches == before


@pytest.mark.parametrize("nblocks,T", [(5, 2048), (5, 300)])
def test_mixfxcloner_matches_jax(rng, nblocks, T):
    """Width 128 and 5 blocks: blocks 3-4 (d = 8, 16) take the fused-block
    dispatch (its plain version on the CPU); T = 300 < 7*16."""
    cfg = dict(condition_dimension=16, nblocks=nblocks, channel_width=C)
    jmod = JaxMixFXcloner(config=JaxTCNConfig(**cfg), fused="off")
    v = jax_fast_init(jmod, jnp.zeros((1, 2, 64)), jnp.zeros((1, 16)), seed=5)
    for blk in v["batch_stats"].values():
        blk["bn"]["mean"] = jnp.asarray(rng.standard_normal(C) * 0.05, jnp.float32)
        blk["bn"]["var"] = jnp.asarray(rng.uniform(0.5, 2.0, C), jnp.float32)
    x = (rng.standard_normal((2, 2, T)) * 0.3).astype(np.float32)
    cond = (rng.standard_normal((2, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(cond)))

    port = MixFXcloner(TCNConfig(**cfg)).eval()
    port.load_state_dict(mixfxcloner_from_jax(v))
    assert [n for n, b in enumerate(port.blocks) if b.uses_kernel()] == [3, 4]
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_receptive_field_and_dispatch_rule_of_full_config():
    with torch.device("meta"):
        m = MixFXcloner().eval()
    assert m.receptive_field() == 229_363
    assert [n for n, b in enumerate(m.blocks) if b.uses_kernel()] == list(range(3, 14))
    assert [b.dilation for b in m.blocks][3:] == [2**n for n in range(3, 14)]
    m.train()
    assert not any(b.uses_kernel() for b in m.blocks)
    assert fused_block_applicable(128, 8) and fused_block_applicable(128, 8192)
    assert not fused_block_applicable(128, 4) and not fused_block_applicable(64, 8)
