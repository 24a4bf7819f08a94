"""PyTorch port: the data-parallel and FSDP train steps and the gathered
NT-Xent against the JAX package's mesh steps and the one-process step, on
the CPU (gloo, one process a rank; the workers in ``torch_ddp_workers.py``
import no JAX, the JAX oracles run here on the 8-device CPU mesh).

Small sizes as ``tests/test_train.py`` (``SMALL_ENC``, ``SMALL_TCN``, T =
4096). Tolerances:

- NT-Xent at W = 2 and 4: the loss within 1e-5 of JAX's ``nt_xent_loss``
  under ``shard_map`` (``axis_name``); each rank's rows receive W times
  their one-process gradient on the concatenated batch (the backward sums
  the cotangent over the ranks, and DDP's mean divides by W), within 1e-5
  of its max.
- Contrastive DDP at W = 2, Adam, no BN (JAX's ``norm="none"``: per-rank
  batch statistics differ from the global batch's by design): the
  averaged gradients left before Adam's update within 1e-5 of each
  tensor's max of the one-process gradients.
- Contrastive DDP and FSDP at W = 2, with BN, one SGD step of lr 1 (the update is
  ``-lr * grad``, so the comparison is gradient-level: Adam's scale
  invariance would hide a factor of W): the loss, the parameters, BN's
  running statistics (averaged over the ranks, as JAX's ``pmean``) and
  the gradients within 1e-4 of JAX's ``make_sharded_contrastive_step`` /
  ``make_fsdp_contrastive_step``; the conv biases ahead of a BN (gradient
  0 in exact arithmetic) under 1e-5 of the largest gradient in both. FSDP
  within 1e-5 of the replicated step; each rank holds half of every
  parameter and of its Adam moments (odd sizes: one more element).
- Converter DDP at W = 2, one SGD step (lr 0.05): the loss and BN's
  running statistics within 1e-4 of JAX's ``make_sharded_converter_step``,
  each parameter's update (the averaged gradient) within 1e-3 of its
  tensor's max (the spectral loss's float32 conditioning: the one-device
  step holds its gradients to JAX's at 1e-3 too,
  ``tests/test_torch_converter.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from music_mixing_style_transfer_tpu.config import FXencoderConfig as JEncCfg
from music_mixing_style_transfer_tpu.config import TCNConfig as JTcnCfg
from music_mixing_style_transfer_tpu.losses import nt_xent_loss as j_nt_xent
from music_mixing_style_transfer_tpu.models import FXencoder as JFXencoder
from music_mixing_style_transfer_tpu.parallel import create_mesh as j_create_mesh
from music_mixing_style_transfer_tpu.train import (
    create_train_state,
    init_contrastive,
    init_converter,
    make_sharded_contrastive_step,
    make_sharded_converter_step,
)
from music_mixing_style_transfer_tpu.train.contrastive import make_fsdp_contrastive_step, shard_train_state
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
from music_mixing_style_transfer_tpu_torch.losses import nt_xent_loss
from music_mixing_style_transfer_tpu_torch.models import FXencoder
from music_mixing_style_transfer_tpu_torch.models.weights import fxencoder_from_jax, mixfxcloner_from_jax
from music_mixing_style_transfer_tpu_torch.parallel import Ranks, create_mesh
from music_mixing_style_transfer_tpu_torch.train.contrastive import contrastive_loss_fn
from torch_ddp_workers import Ranks as SpawnedRanks, _plain_weights, nt_xent_case, several

torch.set_num_threads(2)
SMALL = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
PLAIN = dict(SMALL, norm="none")
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
T = 4096
LR = 1.0  # SGD: a large step keeps the float32 rounding of p - lr*g out of the effective gradient
LR_CONV = 0.05  # the converter's gradients agree to 1e-3 (below), so its step stays small
TEMP = 0.1


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def _numpy_sd(sd):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX oracles and every rank's results (one 2-rank
    group for the steps and NT-Xent, one 4-rank group for NT-Xent)."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    rng = np.random.default_rng(7)
    zi = rng.standard_normal((8, 32)).astype(np.float32)
    zj = (zi + 0.5 * rng.standard_normal((8, 32))).astype(np.float32)
    a = (rng.standard_normal((2, 4, 2, T)) * 0.2).astype(np.float32)
    b = (0.7 * rng.standard_normal((2, 4, 2, T)) * 0.2 + a).astype(np.float32)

    # the weights (JAX's seeded ones); the ranks start on them while JAX compiles its steps
    enc, state0, _ = init_contrastive(JEncCfg(**SMALL), example_length=T, seed=3)
    tx = optax.sgd(LR)
    jstate = create_train_state(state0.variables(), tx)
    enc_sd = _numpy_sd(fxencoder_from_jax(_variables(jstate)))
    a1, a2, b2 = ((rng.standard_normal((4, 2, T)) * 0.2).astype(np.float32) for _ in range(3))
    a2 = (0.5 * a1 + 0.5 * a2).astype(np.float32)
    jenc = JFXencoder(config=JEncCfg(**SMALL))
    jenc_vars = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, T)))
    conv, cstate0, _ = init_converter(JTcnCfg(**TCN), example_length=T)
    ctx = optax.sgd(LR_CONV)
    cstate = create_train_state(cstate0.variables(), ctx)
    calls = [
        ("nt_xent", "nt_xent_case", (zi, zj, TEMP)),
        ("contrastive", "contrastive_steps", (SMALL, enc_sd, a, b, LR, PLAIN)),
        ("converter", "converter_step", (SMALL, _numpy_sd(fxencoder_from_jax(jenc_vars)), TCN,
                                         _numpy_sd(mixfxcloner_from_jax(_variables(cstate))),
                                         a1, a2, b2, LR_CONV)),
    ]
    group2 = SpawnedRanks(several, 2, tmp, (calls,))
    group4 = SpawnedRanks(nt_xent_case, 4, tmp, (zi, zj, TEMP))

    # JAX's sharded and FSDP contrastive steps (BN on) and sharded converter step, with SGD
    mesh = j_create_mesh(2)
    jddp, jddp_loss = make_sharded_contrastive_step(enc, tx, mesh, TEMP)(jstate, jnp.asarray(a), jnp.asarray(b))
    fstate = shard_train_state(jstate, mesh, min_size=1)
    jfsdp, jfsdp_loss = make_fsdp_contrastive_step(enc, tx, mesh, jstate, TEMP, min_size=1)(
        fstate, jnp.asarray(a), jnp.asarray(b))
    jconv, jconv_loss = make_sharded_converter_step(conv, jenc, ctx, mesh)(
        cstate, jenc_vars, jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(b2))
    ranks2, ranks4 = group2.wait(150), group4.wait(150)
    return dict(
        zi=zi, zj=zj, a=a, b=b, enc_sd=enc_sd, ranks={2: ranks2, 4: ranks4},
        jax_ddp=(_numpy_sd(fxencoder_from_jax(_variables(jddp))), float(jddp_loss)),
        jax_fsdp=(_numpy_sd(fxencoder_from_jax(_variables(jfsdp))), float(jfsdp_loss)),
        jax_conv=(_numpy_sd(mixfxcloner_from_jax(_variables(jconv))), float(jconv_loss),
                  _numpy_sd(mixfxcloner_from_jax(_variables(cstate)))),
    )


@pytest.mark.parametrize("world", [2, 4])
def test_nt_xent_gathered_matches_jax_and_one_process(case, world):
    zi, zj = case["zi"], case["zj"]
    fn = jax.shard_map(lambda x, y: j_nt_xent(x, y, TEMP, axis_name="data"), mesh=j_create_mesh(world),
                       in_specs=(P("data"), P("data")), out_specs=P())
    want = float(fn(jnp.asarray(zi), jnp.asarray(zj)))
    ti, tj = (torch.from_numpy(v).requires_grad_(True) for v in (zi, zj))
    one = nt_xent_loss(ti, tj, TEMP)
    one.backward()
    assert abs(float(one) - want) <= 1e-5 * abs(want)
    results = case["ranks"][world] if world == 4 else [r["nt_xent"] for r in case["ranks"][2]]
    n = len(zi) // world
    for rank, r in enumerate(results):
        assert abs(r["loss"] - want) <= 1e-5 * abs(want), rank  # the global loss on every rank
        rows = slice(rank * n, (rank + 1) * n)
        for got, full in ((r["grad_i"], ti.grad), (r["grad_j"], tj.grad)):
            # W times the one-process gradient: DDP's mean over the W ranks brings it back
            assert rel_err(got / world, full[rows].numpy()) <= 1e-5, rank


def test_contrastive_ddp_gradients_equal_one_process(case):
    """No BN, Adam: the averaged gradients before the update equal the
    one-process gradients of the global batch, on both ranks."""
    model = FXencoder(FXencoderConfig(**PLAIN))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _plain_weights(PLAIN).items()})
    loss = contrastive_loss_fn(model.train(), torch.from_numpy(case["a"]), torch.from_numpy(case["b"]), TEMP)
    loss.backward()
    for r in case["ranks"][2]:
        got = r["contrastive"]["plain_adam"]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for name, p in model.named_parameters():
            assert rel_err(got["grads"][name], p.grad.numpy()) <= 1e-5, name


def _check_step(after, loss, want_sd, want_loss, before, grads=None, tol=1e-4):
    assert abs(loss - want_loss) <= tol * abs(want_loss)
    g_max = max(float(np.abs(before[n] - want_sd[n]).max()) / LR for n in before if "running" not in n
                and "num_batches" not in n)
    for name, want in want_sd.items():
        if "num_batches" in name:
            continue
        assert rel_err(after[name], want) <= tol, name
        if "running" in name:
            assert not np.array_equal(after[name], before[name]), name  # averaged new statistics
            continue
        g_want = (before[name] - want) / LR
        g_got = grads[name] if grads is not None else (before[name] - after[name]) / LR
        if name.endswith("conv1d.conv1d.bias"):  # ahead of a training-mode BN: 0 in exact arithmetic
            assert max(np.abs(g_got).max(), np.abs(g_want).max()) <= 1e-5 * g_max, name
            continue
        assert rel_err(g_got, g_want) <= tol, name


def test_contrastive_ddp_step_matches_jax_sharded_step(case):
    want_sd, want_loss = case["jax_ddp"]
    for r in case["ranks"][2]:
        got = r["contrastive"]["ddp"]
        _check_step(got["after"], got["loss"], want_sd, want_loss, case["enc_sd"], got["grads"])


def test_fsdp_step_matches_replicated_and_jax_fsdp_step(case):
    """One FSDP step equals the replicated step and JAX's FSDP step, and
    each rank holds its half of every parameter and of Adam's moments."""
    want_sd, want_loss = case["jax_fsdp"]
    for rank, r in enumerate(case["ranks"][2]):
        got, ddp = r["contrastive"]["fsdp"], r["contrastive"]["ddp"]
        _check_step(got["after"], got["loss"], want_sd, want_loss, case["enc_sd"])
        assert abs(got["loss"] - ddp["loss"]) <= 1e-6 * abs(ddp["loss"])
        for name in ddp["after"]:
            assert rel_err(got["after"][name], ddp["after"][name]) <= 1e-5, name

        shares = r["contrastive"]["fsdp_shares"]
        assert shares and set(shares) == {k for k in case["enc_sd"] if "running" not in k
                                          and "num_batches" not in k}
        total_local = sum(s[0] for s in shares.values())
        total = sum(s[1] for s in shares.values())
        for name, (local, full, m1, m2, rows) in shares.items():
            assert m1 == m2 == local, name  # Adam's moments live on the shard only
            assert local <= -(-rows // 2) * (full // rows), name  # dim 0 split in two
        assert abs(total_local - total / 2) <= 0.05 * total, (rank, total_local, total)


def test_converter_ddp_step_matches_jax_sharded_step(case):
    want_sd, want_loss, before = case["jax_conv"]
    for r in case["ranks"][2]:
        got = r["converter"]
        assert abs(got["loss"] - want_loss) <= 1e-4 * abs(want_loss)
        for name, want in want_sd.items():
            if "num_batches" in name:
                continue
            if "running" in name:
                assert rel_err(got["after"][name], want) <= 1e-4, name
                continue
            # the update, -lr * grad: the gradients agree to 1e-3 (the module docstring)
            g_got, g_want = ((before[name] - v) / LR_CONV for v in (got["after"][name], want))
            assert rel_err(g_got, g_want) <= 1e-3, name


def test_mesh_and_ranks_refuse_what_they_cannot_split():
    mesh = create_mesh(3, ["cpu"] * 4)
    assert mesh.size == 3 and mesh.distinct == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="requested a 5-device mesh but only 4 device"):
        create_mesh(5, ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            create_mesh(2, ["cuda:0"] * 2)
        with pytest.raises(ValueError, match="at least one device"):
            create_mesh()
    r = Ranks(rank=1, world_size=2)
    assert not r.is_main and r.parallel
    assert Ranks.current() == Ranks()  # no process group in this process
