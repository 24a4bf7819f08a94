"""PyTorch port: the sox-style compander, ``lufs_normalize_compand``, the
envelope scans with the side chain given, and the blockwise compressor, vs
the JAX package, on the CPU.

Tolerances over max|oracle|: the transfer table equal byte for byte (the
same host numpy); ``compand`` and ``lufs_normalize_compand`` within 1e-5 of
JAX's jitted float32 (measured ~2e-7); ``interp`` as ``jnp.interp`` within
1e-6 absolute in dB; the chunked scan (the card's algorithm, run here) in
float32 within 1e-5 of a float64 serial walk, and in float64 within 1e-12;
the blockwise compressor within 1e-5 of JAX's (vmapped per row, as its
chains call it; measured ~6e-8), at blocks and warm-ups scaled down.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.ops import compressor as jc
from music_mixing_style_transfer_tpu.ops import loudness as jl
from music_mixing_style_transfer_tpu_torch.fx import processors as pp
from music_mixing_style_transfer_tpu_torch.fx.chain import AugmentationChain, Stage
from music_mixing_style_transfer_tpu_torch.fx.fastpath import _sig, eval_grouped
from music_mixing_style_transfer_tpu_torch.ops import compressor as pc
from music_mixing_style_transfer_tpu_torch.ops import loudness as pl
from music_mixing_style_transfer_tpu_torch.ops.cuda import envelope as penv

torch.set_num_threads(2)
SR = 44100
TOL = 1e-5


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def music(rng, shape, T):
    """Noise under a slow envelope with quiet passages, channels of unequal level."""
    env = np.abs(np.sin(np.linspace(0, rng.uniform(4, 9), T))) ** 3
    x = rng.standard_normal(shape + (T,)) * 0.6 * (0.003 + env)
    x[..., 1, :] *= 0.5
    return x.astype(np.float32)


CURVES = [
    dict(),
    dict(tf_points=((-60.0, -60.0), (-30.0, -20.0), (-10.0, -15.0), (0.0, -6.0)), soft_knee_db=6.0),
    dict(tf_points=((-80.0, -80.0), (0.0, -10.0)), soft_knee_db=0.0),
]


@pytest.mark.parametrize("curve", CURVES)
def test_transfer_table_is_jax_bytes(curve):
    for got, want in zip(pc.compand_transfer_table(**curve), jc.compand_transfer_table(**curve)):
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


def test_interp_is_jnp_interp(rng):
    grid, table = jc.compand_transfer_table()
    x = np.concatenate([rng.uniform(-130, 5, 5000), grid[::97], [grid[0], grid[-1], -200.0, 3.0]])
    x = x.astype(np.float32)
    got = pc.interp(*(torch.from_numpy(a) for a in (x, grid, table))).numpy()
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(grid), jnp.asarray(table)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [
    dict(shape=(2,), T=2**14),
    dict(shape=(3, 2), T=5000, attack_s=0.005, decay_s=0.05, **CURVES[1]),
    dict(shape=(2,), T=2**13, sample_rate=22050, attack_s=0.002, decay_s=0.002, **CURVES[2]),
])
def test_compand_matches_jax(rng, case):
    case = dict(case)
    x = music(rng, case.pop("shape"), case.pop("T"))
    got = pc.compand(torch.from_numpy(x), **case).numpy()
    want = np.asarray(jc.compand(jnp.asarray(x), **case))
    assert got.dtype == np.float32 and rel_err(got, want) <= TOL
    assert np.abs(got - x).max() > 1e-3  # the curve acts
    with pytest.raises(ValueError, match="attack_s <= decay_s"):
        pc.compand(torch.from_numpy(x), attack_s=0.02, decay_s=0.01)


def test_lufs_normalize_compand_matches_jax_and_passes_silence(rng):
    x = music(rng, (2,), 2**14)
    for target in (-14.0, -30.0):
        got = pl.lufs_normalize_compand(torch.from_numpy(x), SR, target).numpy()
        want = np.asarray(jl.lufs_normalize_compand(jnp.asarray(x), SR, target))
        assert rel_err(got, want) <= TOL
    silent = np.zeros((2, 2**14), np.float32)
    got = pl.lufs_normalize_compand(torch.from_numpy(silent), SR, -14.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.lufs_normalize_compand(jnp.asarray(silent), SR, -14.0)))
    assert not got.any()


@pytest.mark.parametrize("T,chunk", [(4096, 64), (5000, 64), (3001, 512), (700, 16), (1, 16)])
def test_chunked_scan_equals_the_serial_walk(rng, T, chunk):
    """The card's compand scan, run on the CPU: float32 within 1e-5 of a
    float64 serial walk, float64 within 1e-12, for max lanes (attack faster
    than decay), min lanes (slower) and carried envelopes."""
    L = 6
    v = np.abs(music(rng, (L // 2, 2), T)).reshape(L, T)
    a = np.exp(-1.0 / (SR * np.array([0.001, 0.001, 0.005, 0.0002, 0.02, 0.001])))
    c = np.exp(-1.0 / (SR * np.array([0.01, 0.1, 0.005, 0.05, 0.002, 0.001])))
    env0 = np.array([0.0, 0.3, 0.0, 0.01, 0.2, 0.0])
    args64 = [torch.from_numpy(np.asarray(u, np.float64)) for u in (v, a, c, env0)]
    want = penv.serial_scan(*args64).numpy()
    got64 = penv.chunked_scan(*args64, chunk).numpy()
    assert rel_err(got64, want) <= 1e-12
    got32 = penv.chunked_scan(*(u.float() for u in args64), chunk).numpy()
    assert got32.dtype == np.float32 and rel_err(got32, want) <= TOL
    serial32 = penv.serial_scan(*(u.float() for u in args64)).numpy()
    assert rel_err(serial32, want) <= TOL
    # the serial walk is JAX's _envelope_scan
    jax_scan = np.asarray(jc._envelope_scan(jnp.asarray(v), jnp.asarray(a, jnp.float32),
                                            jnp.asarray(c, jnp.float32), jnp.asarray(env0, jnp.float32)))
    assert rel_err(serial32, jax_scan) <= TOL


@pytest.mark.parametrize("T,block,warmup", [(3000, 256, 512), (4096, 1024, 1024), (700, 256, 0)])
def test_blockwise_compressor_matches_jax_in_one_launch(rng, monkeypatch, T, block, warmup):
    n = 4
    x = music(rng, (n, 2), T)
    th = rng.uniform(-50, -10, n).astype(np.float32)
    att = rng.uniform(1, 20, n).astype(np.float32)
    rel = rng.uniform(50, 500, n).astype(np.float32)
    ratio = np.array([4.0, 20.0, 0.25, 1.0], np.float32)  # compress, hard, expand, identity

    def jax_one(xx, t, a, r, q):
        return jc.compressor_process(xx, t, a, r, q, 0.0, blockwise=True, block=block, warmup=warmup)

    want = np.asarray(jax.jit(jax.vmap(jax_one))(jnp.asarray(x), th, att, rel, ratio))
    calls = []
    launch = pc.compressor_envelope

    def counted(xl, *p):
        calls.append(tuple(xl.shape))
        return launch(xl, *p)

    monkeypatch.setattr(pc, "compressor_envelope", counted)
    got = pc.compressor_process(
        torch.from_numpy(x), *(torch.from_numpy(v)[:, None] for v in (th, att, rel, ratio)),
        blockwise=True, block=block, warmup=warmup,
    ).numpy()
    assert rel_err(got, want) <= TOL
    nb = -(-T // block)
    assert calls == [(n * 2 * nb, warmup + block)]  # one launch, the blocks as lanes
    with pytest.raises(ValueError, match="rows"):
        pc.compressor_process(torch.from_numpy(x[0]), -20.0, 5.0, 50.0, 4.0, blockwise=True,
                              rows=torch.zeros(2, dtype=torch.int64))


def test_fast_path_keeps_blockwise_compressors_apart(rng):
    """A blockwise and an exact compressor differ in their signature, so the
    batched walk never merges them into one stage; it equals the generic
    walk of each chain."""
    exact, blockwise = pp.Compressor(SR), pp.Compressor(SR, blockwise=True)
    assert _sig(exact) != _sig(blockwise)
    chains = [AugmentationChain([Stage(fx, 1.0), Stage(pp.Gain(), 0.5)]) for fx in (exact, blockwise)]
    gen = torch.Generator().manual_seed(3)
    plans = [c.draw(gen, 2) for c in chains]
    x = torch.from_numpy(music(rng, (4, 1, 2), 9000))
    got = eval_grouped(chains, [2, 2], plans, x)
    want = torch.cat([chains[0].apply(plans[0], x[:2]), chains[1].apply(plans[1], x[2:])])
    assert torch.equal(got, want)
    assert not torch.equal(got[2:], chains[0].apply(plans[1], x[2:]))
