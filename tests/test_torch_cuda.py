"""PyTorch port on the card: the CUDA kernels against their plain versions.

Marked ``cuda``; skips where ``torch.cuda.is_available()`` is false. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets JAX up for the CPU.)
"""
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
    "L,T,cuts",
    [(1024, 4096, None), (1000, 1000, None), (1, 1, None), (8, 1000, None), (7, 5000, [1, 1777, 4096])],
)
def test_envelope_kernel_matches_plain_version(card, L, T, cuts):
    """Ragged L and T, and slabs of unequal lengths with the envelope carried:
    1e-5 of max|plain| (log10/exp forms differ; the recurrence contracts)."""
    x, *p = _lanes(L * 7 + T, L, T, card)
    want, env_want = envelope_reference(x, *p)
    before = compressor_envelope.launches
    if cuts is None:
        got, env = compressor_envelope(x, *p)
    else:
        parts, env = [], p[-1]
        for a, b in zip([0] + cuts, cuts + [T]):
            y, env = compressor_envelope(x[:, a:b].contiguous(), *p[:-1], env)
            parts.append(y)
        got = torch.cat(parts, -1)
    torch.cuda.synchronize()
    assert compressor_envelope.launches == before + (1 if cuts is None else len(cuts) + 1)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert (env - env_want).abs().max().item() <= 1e-5 * env_want.abs().max().item() + 1e-6


@pytest.mark.cuda
def test_envelope_wrapper_raises_on_what_the_kernel_does_not_take(card):
    x, *p = _lanes(0, 4, 64, card)
    with pytest.raises(ValueError, match="contiguous"):
        compressor_envelope(x.t().contiguous().t(), *p)
    with pytest.raises(ValueError, match="float32"):
        compressor_envelope(x.double(), *p)
    with pytest.raises(ValueError, match="must be"):
        compressor_envelope(x, *p[:-1], p[-1].cpu())
