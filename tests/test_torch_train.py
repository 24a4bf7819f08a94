"""PyTorch port: NT-Xent, the learning-rate schedules, one contrastive train
step, remat and checkpoints vs the JAX package, on the CPU.

One step of ``make_contrastive_train_step`` on ``SMALL_ENC`` (as in
``tests/test_train.py``, T = 4096) starts both packages from the same
weights (``models/weights.py:train_state_from_jax``): the loss within 1e-5,
every gradient within 1e-4 of its tensor's max|g| (the conv biases ahead
of a training-mode BN, whose gradient is 0 in exact arithmetic, under 1e-5
of the largest gradient in both), BN's running statistics within 1e-5 of
their max; after Adam's first step, every parameter within 2*lr of JAX's,
and within 1e-6 wherever the two gradients agree in sign (Adam's first
update is ~lr*sign(g) away from tiny gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import FXencoderConfig as JaxEncCfg
from music_mixing_style_transfer_tpu.config import TrainConfig as JaxTrainCfg
from music_mixing_style_transfer_tpu.losses import nt_xent_loss as j_nt_xent
from music_mixing_style_transfer_tpu.train.contrastive import contrastive_loss_fn as j_loss_fn
from music_mixing_style_transfer_tpu.train.contrastive import init_contrastive as j_init
from music_mixing_style_transfer_tpu.train.contrastive import make_contrastive_train_step as j_make_step
from music_mixing_style_transfer_tpu.train.state import current_lr as j_current_lr
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TrainConfig
from music_mixing_style_transfer_tpu_torch.losses import nt_xent_loss
from music_mixing_style_transfer_tpu_torch.models.weights import fxencoder_from_jax, train_state_from_jax
from music_mixing_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
from music_mixing_style_transfer_tpu_torch.train.contrastive import (
    contrastive_loss_fn,
    init_contrastive,
    make_contrastive_train_step,
)
from music_mixing_style_transfer_tpu_torch.train.state import current_lr, make_lr_schedule

torch.set_num_threads(2)
SMALL = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
J_SMALL, P_SMALL = JaxEncCfg(**SMALL), FXencoderConfig(**SMALL)
T = 4096
LR = 2e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def test_nt_xent_matches_jax(rng):
    for B, D in ((4, 16), (7, 2048)):
        zi = rng.standard_normal((B, D)).astype(np.float32)
        zj = (zi + 0.3 * rng.standard_normal((B, D))).astype(np.float32)
        zj[0] = 0.0  # a zero embedding: the 1e-8 floor of ||a||*||b||
        for temp in (0.1, 0.5):
            want = float(j_nt_xent(jnp.asarray(zi), jnp.asarray(zj), temp))
            got = float(nt_xent_loss(torch.from_numpy(zi), torch.from_numpy(zj), temp))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


SCHEDULES = [
    {},
    {"lr_warmup_steps": 10},
    {"lr_schedule": "warmup_cosine", "lr_warmup_steps": 5, "lr_decay_steps": 50, "lr_end_factor": 0.1},
    {"lr_schedule": "warmup_cosine", "lr_decay_steps": 40},
    {"lr_schedule": "step", "lr_step_size": 7, "lr_gamma": 0.5},
    {"lr_schedule": "step", "lr_step_size": 7, "lr_gamma": 0.3, "lr_warmup_steps": 3},
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw.get("lr_schedule", "constant") + (
    "_warmup" if kw.get("lr_warmup_steps") else ""))
def test_lr_schedules_match_jax(kw):
    jcfg, pcfg = JaxTrainCfg(learning_rate=3e-4, **kw), TrainConfig(learning_rate=3e-4, **kw)
    sched = make_lr_schedule(pcfg)
    for step in list(range(0, 70)) + [500, 10_000]:
        want = j_current_lr(jcfg, step)
        # optax evaluates in float32: 1e-6 of the peak rate
        assert current_lr(pcfg, step) == pytest.approx(want, rel=1e-6, abs=3e-10), step
        assert sched(step) == pytest.approx(want, rel=1e-6, abs=3e-10), step
    with pytest.raises(ValueError, match="lr_schedule"):
        make_lr_schedule(TrainConfig(lr_schedule="linear"))


def _views(seed, Tb=T):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((2, 4, 2, T)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((2, 4, 2, Tb)) * 0.2).astype(np.float32)
    b[..., : min(T, Tb)] = 0.7 * b[..., : min(T, Tb)] + a[..., : min(T, Tb)]
    return a, b


@pytest.fixture(scope="module")
def jax_step():
    """JAX's fresh state, one batch, the loss and gradients at the state, and
    the state after one jitted train step."""
    enc, state, tx = j_init(J_SMALL, example_length=T)
    a, b = _views(0)

    def loss_fn(params):
        return j_loss_fn(enc, params, state.batch_stats, jnp.asarray(a), jnp.asarray(b), 0.1)

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    new_state, step_loss = jax.jit(j_make_step(enc, tx, 0.1))(state, jnp.asarray(a), jnp.asarray(b))
    return dict(enc=enc, state=state, a=a, b=b, loss=float(loss), grads=grads,
                new_state=new_state, step_loss=float(step_loss))


def _jax_state_dict(params, stats):
    return {k: v.numpy() for k, v in fxencoder_from_jax({"params": params, "batch_stats": stats}).items()}


def test_one_contrastive_step_matches_jax(jax_step):
    j = jax_step
    state = train_state_from_jax(j["state"], P_SMALL)
    assert state.step == 0 and state.model.training
    step = make_contrastive_train_step(0.1)
    state, loss = step(state, torch.from_numpy(j["a"]), torch.from_numpy(j["b"]))
    assert state.step == 1
    assert abs(float(loss) - j["loss"]) <= 1e-5 * abs(j["loss"]) and j["step_loss"] == pytest.approx(j["loss"])

    stats = j["new_state"].batch_stats
    jgrads = _jax_state_dict(j["grads"], stats)
    jafter = _jax_state_dict(j["new_state"].params, stats)
    before = _jax_state_dict(j["state"].params, j["state"].batch_stats)
    names = dict(state.model.named_parameters())
    sd = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    g_max = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in names.items():
        g, gj = p.grad.numpy(), jgrads[name]
        after, want = sd[name], jafter[name]
        assert np.max(np.abs(after - want)) <= 2 * LR, name
        assert not np.array_equal(after, before[name]), name  # every tensor moved
        if name.endswith("conv1d.conv1d.bias"):
            # a conv bias ahead of a training-mode BN: its gradient is 0 in exact
            # arithmetic, rounding noise in both packages (so are Adam's signs)
            assert max(np.abs(g).max(), np.abs(gj).max()) <= 1e-5 * g_max, name
            continue
        assert rel_err(g, gj) <= 1e-4, name
        agree = np.sign(g) == np.sign(gj)
        assert np.max(np.abs(after - want)[agree], initial=0.0) <= 1e-6, name
    for name in sd:
        if "running_" in name:
            assert rel_err(sd[name], jafter[name]) <= 1e-5, name
            assert not np.array_equal(sd[name], before[name]), name  # updated in training mode


def test_unequal_view_lengths_match_jax(jax_step):
    j = jax_step
    a, b = _views(1, Tb=T // 2)
    want = float(j_loss_fn(j["enc"], j["state"].params, j["state"].batch_stats,
                           jnp.asarray(a), jnp.asarray(b), 0.1)[0])
    state = train_state_from_jax(j["state"], P_SMALL)
    got = contrastive_loss_fn(state.model, torch.from_numpy(a), torch.from_numpy(b), 0.1)
    assert abs(float(got.detach()) - want) <= 1e-5 * abs(want)
    state, loss = make_contrastive_train_step(0.1)(state, torch.from_numpy(a), torch.from_numpy(b))
    assert np.isfinite(float(loss)) and state.step == 1


def test_remat_gives_the_same_step():
    """Recomputing the blocks in the backward pass changes neither the
    gradients nor BN's running statistics (they update once a forward)."""
    a, b = (torch.from_numpy(v) for v in _views(2))
    outs = []
    for remat in (False, True):
        _, state, _ = init_contrastive(P_SMALL, TrainConfig(remat=remat), seed=3, device="cpu")
        assert state.model.remat is remat
        state, loss = make_contrastive_train_step(0.1)(state, a, b)
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        outs.append((float(loss), grads, {k: v.clone() for k, v in state.model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = outs
    assert l0 == pytest.approx(l1, rel=1e-6)
    for n in g0:
        assert rel_err(g1[n].numpy(), g0[n].numpy()) <= 1e-5, n
    for n in s0:
        assert rel_err(s1[n].numpy(), s0[n].numpy()) <= 1e-6, n


def test_bfloat16_step_keeps_float32_state():
    a, b = (torch.from_numpy(v) for v in _views(3))
    _, state, _ = init_contrastive(P_SMALL, TrainConfig(compute_dtype="bfloat16"), seed=0, device="cpu")
    state, loss = make_contrastive_train_step(0.1, "bfloat16")(state, a, b)
    assert np.isfinite(float(loss)) and loss.dtype == torch.float32
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.model.state_dict().values())
    assert all(s["exp_avg"].dtype == torch.float32 for s in state.optimizer.state.values())


def test_warmup_starts_from_the_schedules_first_value():
    """The first update uses sched(0): 0 under a linear warmup (as optax)."""
    a, b = (torch.from_numpy(v) for v in _views(4))
    _, state, _ = init_contrastive(P_SMALL, TrainConfig(lr_warmup_steps=4), seed=0, device="cpu")
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    state, _ = make_contrastive_train_step(0.1)(state, a, b)
    assert all(torch.equal(before[k], v) for k, v in state.model.named_parameters())
    state, _ = make_contrastive_train_step(0.1)(state, a, b)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4 / 4)
    assert not all(torch.equal(before[k], v) for k, v in state.model.named_parameters())


def test_checkpoint_save_keep_and_restore(tmp_path):
    a, b = (torch.from_numpy(v) for v in _views(5))
    step = make_contrastive_train_step(0.1)
    _, state, _ = init_contrastive(P_SMALL, TrainConfig(), seed=1, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for epoch in (1, 2, 3):
        state, _ = step(state, a, b)
        mgr.save(epoch, state)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000002.pt", "step_00000003.pt"]

    _, fresh, _ = init_contrastive(P_SMALL, TrainConfig(), seed=9, device="cpu")
    fresh = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert fresh.step == state.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    so, fo = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in so["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(fo["state"][i][k]), torch.as_tensor(s[k])), (i, k)
    # both continue identically
    s1, l1 = step(state, a, b)
    s2, l2 = step(fresh, a, b)
    assert float(l1) == float(l2)
    for k, v in s1.model.state_dict().items():
        assert torch.equal(s2.model.state_dict()[k], v), k
    # an older step restores on request; the file loads as an encoder
    from music_mixing_style_transfer_tpu_torch.models.checkpoints import load_model_state
    from music_mixing_style_transfer_tpu_torch.models.fx_encoder import FXencoder

    assert CheckpointManager(str(tmp_path / "ckpt")).restore(fresh, step=2).step == 2
    load_model_state(str(tmp_path / "ckpt" / "step_00000003.pt"), FXencoder(P_SMALL))


def test_orbax_directories_raise(tmp_path):
    (tmp_path / "ckpt" / "3").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax step directories.*flatten_dict"):
        CheckpointManager(str(tmp_path / "ckpt"))
