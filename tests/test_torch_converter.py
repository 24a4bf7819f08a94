"""PyTorch port: converter (MixFXcloner) training against the JAX package,
on the CPU, at small sizes (``SMALL_ENC`` / ``SMALL_TCN`` as in
``tests/test_train.py``, T = 4096).

- The TCN in training mode (JAX ``MixFXcloner(train=True,
  channels_last=False)``): the output within 1e-5 of its max and the
  updated BN running statistics within 1e-5 of theirs; ``remat`` gives the
  same gradients (1e-5) and statistics (1e-6) as without it.
- The converter's backward from one cotangent (JAX's ``vjp``), so from the
  same point: every parameter's gradient within 1e-4 of its tensor's max,
  block 0's grouped residual among them.
- One ``make_converter_train_step``, both packages from the same weights,
  with ``ori_weight`` 0 and 0.5: the loss within 1e-5, BN's running
  statistics within 1e-5, every parameter after Adam's first step within
  2*lr of JAX's, and within 1e-6 where the two gradients agree in sign and
  clear the gradients' noise (2e-3 of the max; Adam's first update is
  ~lr*sign(g), so noise near g = 0 moves it by up to 2*lr). The
  gradients themselves within 1e-3 of each tensor's max: the spectral
  loss's log-magnitude term makes dL/dpred ill-conditioned in float32 (both
  packages' float32 dL/dpred sit 2.6e-3 of its max from the float64 one on
  these inputs, ``tests/test_torch_spectral.py``), and each package's
  float32 rounding of it reaches the weights differently.
- ``train_converter`` and ``train.cli converter`` on a tiny corpus, from
  the checkpoint that ``train.cli fxencoder`` writes; the held-out loss is
  the training-mode loss and leaves the BN buffers as they were;
  ``tools/train_bench.py --tiny --device cpu``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.config import FXencoderConfig as JEncCfg
from music_mixing_style_transfer_tpu.config import TCNConfig as JTcnCfg
from music_mixing_style_transfer_tpu.data.wavio import write_wav
from music_mixing_style_transfer_tpu.models import FXencoder as JFXencoder
from music_mixing_style_transfer_tpu.models import MixFXcloner as JMixFXcloner
from music_mixing_style_transfer_tpu.models.fast_init import fast_init as j_fast_init
from music_mixing_style_transfer_tpu.train.converter import converter_loss_fn as j_loss_fn
from music_mixing_style_transfer_tpu.train.converter import init_converter as j_init
from music_mixing_style_transfer_tpu.train.converter import make_converter_train_step as j_make_step
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig, TrainConfig
from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
from music_mixing_style_transfer_tpu_torch.models.weights import (
    fxencoder_from_jax,
    mixfxcloner_from_jax,
    train_state_from_jax,
)
from music_mixing_style_transfer_tpu_torch.tools import train_bench
from music_mixing_style_transfer_tpu_torch.train import cli
from music_mixing_style_transfer_tpu_torch.train.converter import (
    converter_loss_fn,
    frozen,
    make_converter_train_step,
)
from music_mixing_style_transfer_tpu_torch.train.loop import train_converter

torch.set_num_threads(2)
ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
T = 4096
LR = 2e-4
INSTS = ("drums", "bass", "other", "vocals")
SR = 44100
JAX_RECORD_KEYS = {"model", "epoch", "loss", "lr", "wall", "time", "val_loss"}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def _triplet(seed, B=4):
    rng = np.random.default_rng(seed)
    a1, a2, b2 = ((rng.standard_normal((B, 2, T)) * 0.2).astype(np.float32) for _ in range(3))
    return a1, (0.5 * a1 + 0.5 * a2).astype(np.float32), b2


@pytest.fixture(scope="module")
def jax_case():
    """A JAX encoder's variables, a fresh JAX converter state, one triplet."""
    jenc = JFXencoder(config=JEncCfg(**ENC))
    enc_vars = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, T)))
    conv, state, tx = j_init(JTcnCfg(**TCN), example_length=T)
    return dict(jenc=jenc, enc_vars=enc_vars, conv=conv, state=state, tx=tx, batch=_triplet(0))


def _port(jc, train_cfg=None):
    state = train_state_from_jax(jc["state"], TCNConfig(**TCN), train_cfg, model="converter")
    enc = FXencoder(FXencoderConfig(**ENC))
    enc.load_state_dict(fxencoder_from_jax(jc["enc_vars"]))
    return state, frozen(enc)


def _jax_sd(params, stats):
    return {k: v.numpy() for k, v in mixfxcloner_from_jax({"params": params, "batch_stats": stats}).items()}


def test_tcn_training_mode_matches_jax(rng):
    """Batch statistics (float32, unbiased into the running variance,
    momentum 0.1), the channels-first training layout, block 0's grouped
    2 -> 8 residual; three blocks of kernel 15 (dilations 1, 2, 4)."""
    cfg = dict(condition_dimension=16, nblocks=3, channel_width=8, kernel_size=15)
    jm = JMixFXcloner(JTcnCfg(**cfg), train=True, channels_last=False)
    variables = j_fast_init(jm, jnp.zeros((2, 2, T)), jnp.zeros((2, 16)), seed=1)
    x = (rng.standard_normal((3, 2, T)) * 0.3).astype(np.float32)
    c = rng.standard_normal((3, 16)).astype(np.float32)
    want, upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(c), mutable=["batch_stats"])
    model = MixFXcloner(TCNConfig(**cfg))
    model.load_state_dict(mixfxcloner_from_jax(variables))
    got = model.train()(torch.from_numpy(x), torch.from_numpy(c))
    assert rel_err(got.detach().numpy(), want) <= 1e-5
    after = _jax_sd(variables["params"], upd["batch_stats"])
    for name, v in model.state_dict().items():
        if "running_" in name:
            assert rel_err(v.numpy(), after[name]) <= 1e-5, name
            assert not np.array_equal(v.numpy(), mixfxcloner_from_jax(variables)[name].numpy()), name


def test_converter_backward_matches_jax(jax_case):
    j = jax_case
    a1, _, b2 = j["batch"]
    emb = j["jenc"].apply(j["enc_vars"], jnp.asarray(b2))
    cot = np.random.default_rng(5).standard_normal((a1.shape[0], 2, T)).astype(np.float32)

    def fwd(params):
        return j["conv"].apply({"params": params, "batch_stats": j["state"].batch_stats},
                               jnp.asarray(a1), emb, mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(fwd, j["state"].params)
    want = _jax_sd(vjp(jnp.asarray(cot))[0], j["state"].batch_stats)
    state, enc = _port(j)
    with torch.no_grad():
        pemb = enc(torch.from_numpy(b2))
    assert rel_err(pemb.numpy(), emb) <= 1e-5
    state.model.train()(torch.from_numpy(a1), pemb).backward(torch.from_numpy(cot))
    for name, p in state.model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        assert rel_err(p.grad.numpy(), want[name]) <= 1e-4, name


@pytest.mark.parametrize("ori_weight", [0.0, 0.5])
def test_one_converter_step_matches_jax(jax_case, ori_weight):
    j = jax_case
    a1, a2, b2 = (jnp.asarray(v) for v in j["batch"])

    def loss_fn(params):
        return j_loss_fn(j["conv"], j["jenc"], params, j["state"].batch_stats, j["enc_vars"],
                         a1, a2, b2, ori_weight=ori_weight)

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(j["state"].params)
    step = jax.jit(j_make_step(j["conv"], j["jenc"], j["tx"], ori_weight=ori_weight))
    new_state, step_loss = step(j["state"], j["enc_vars"], a1, a2, b2)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)

    state, enc = _port(j)
    state, got = make_converter_train_step(ori_weight=ori_weight)(
        state, enc, *(torch.from_numpy(v) for v in j["batch"]))
    assert state.step == 1
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    stats = new_state.batch_stats
    jgrads, jafter = _jax_sd(grads, stats), _jax_sd(new_state.params, stats)
    before = _jax_sd(j["state"].params, j["state"].batch_stats)
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        g, gj = p.grad.numpy(), jgrads[name]
        assert rel_err(g, gj) <= 1e-3, name
        assert np.max(np.abs(sd[name] - jafter[name])) <= 2 * LR, name
        assert not np.array_equal(sd[name], before[name]), name
        # Adam's first step is ~lr * sign(g): compared where g clears the
        # gradients' float32 noise (1e-3 of the max, above) in both packages
        clear = np.minimum(np.abs(g), np.abs(gj)) > 2e-3 * np.abs(gj).max()
        agree = (np.sign(g) == np.sign(gj)) & clear
        assert np.max(np.abs(sd[name] - jafter[name])[agree], initial=0.0) <= 1e-6, name
    for name in sd:
        if "running_" in name:
            assert rel_err(sd[name], jafter[name]) <= 1e-5, name
    # the encoder stays frozen: eval mode, no gradients, buffers unchanged
    assert not enc.training and all(p.grad is None for p in enc.parameters())


def test_remat_gives_the_same_converter_step(jax_case):
    outs = []
    for remat in (False, True):
        state, enc = _port(jax_case, TrainConfig(remat=remat))
        assert state.model.remat is remat
        state, loss = make_converter_train_step()(state, enc, *(torch.from_numpy(v) for v in _triplet(1)))
        outs.append((float(loss), {n: p.grad.clone() for n, p in state.model.named_parameters()},
                     {k: v.clone() for k, v in state.model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = outs
    assert l0 == pytest.approx(l1, rel=1e-6)
    for n in g0:
        assert rel_err(g1[n].numpy(), g0[n].numpy()) <= 1e-5, n
    for n in s0:
        assert rel_err(s1[n].numpy(), s0[n].numpy()) <= 1e-6, n


def test_bfloat16_converter_step_keeps_float32_state(jax_case):
    state, enc = _port(jax_case, TrainConfig(compute_dtype="bfloat16"))
    state, loss = make_converter_train_step(compute_dtype="bfloat16")(
        state, enc, *(torch.from_numpy(v) for v in _triplet(2)))
    assert np.isfinite(float(loss)) and loss.dtype == torch.float32
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.model.state_dict().values())
    assert all(s["exp_avg"].dtype == torch.float32 for s in state.optimizer.state.values())


def test_bfloat16_training_keeps_every_block_output_in_bfloat16():
    """Under bf16 autocast each training block's output is bf16, block 0's
    grouped residual (a float32 input times a float32 weight) included: a
    float32 residual would promote the whole stream, and so the activations
    the backward keeps, to float32."""
    from music_mixing_style_transfer_tpu_torch.train.contrastive import compute_context

    model = MixFXcloner(TCNConfig(**TCN)).train()
    gen = torch.Generator().manual_seed(0)
    h, cond = torch.randn(2, 2, 1024, generator=gen), torch.randn(2, 16, generator=gen)
    with compute_context("bfloat16", "cpu"):
        for n, block in enumerate(model.blocks):
            h = block.forward_nch(h, cond)
            assert h.dtype == torch.bfloat16, n


# ---------------------------------------------------------------------------
# the loop, the CLI and the bench
# ---------------------------------------------------------------------------
SEG = 4096


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``<dir>/{train,val}/<inst>_normalized_eqcompimagegain_silence_trimmed*.wav``,
    16-bit PCM."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for mode in ("train", "val"):
        (root / mode).mkdir()
        for inst in INSTS:
            for part, n in enumerate((SEG * 4, SEG * 2 + 77)):
                x = (rng.standard_normal((n, 2)) * 0.2).astype(np.float32)
                write_wav(str(root / mode / f"{inst}_normalized_eqcompimagegain_silence_trimmed{part}.wav"),
                          x, SR)
    return str(root)


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _small_encoder(seed=0):
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init

    return fast_init(FXencoder(FXencoderConfig(**ENC)), seed=seed)


def test_train_converter_trains_resumes_and_validates_in_training_mode(corpus, tmp_path):
    run = str(tmp_path / "run")
    kw = dict(converter_cfg=TCNConfig(**TCN), train_cfg=TrainConfig(segment_length=SEG),
              steps_per_epoch=2, batch_items=1, device="cpu")
    encoder = _small_encoder()
    state = train_converter(corpus, run, encoder, epochs=1, fused=True, **kw)
    assert state.step == 2 and os.listdir(os.path.join(run, "ckpt_conv")) == ["step_00000001.pt"]
    (rec,) = _records(run)
    assert set(rec) == JAX_RECORD_KEYS | {"launches", "reader"} and rec["model"] == "converter"
    assert rec["reader"] == {"train": "native", "val": "native"}  # the native wav bank
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["val_loss"])
    assert {"step", "host", "epoch", "synced_step", "synced_augment", "synced_train_step"} <= set(rec["wall"])
    assert rec["launches"] == {"compressor_envelope": 0, "compressor_envelope_synced_step": 0,
                               "compressor_envelope_val": 0}  # the CPU walks K2's plain version
    assert not encoder.training and not any(p.requires_grad for p in encoder.parameters())

    # the held-out loss: training-mode BN on the batch, buffers left as they were
    from music_mixing_style_transfer_tpu_torch.data.datasets import StyleTransferTripletDataset
    from music_mixing_style_transfer_tpu_torch.train.fused import augment_triplets

    ds = StyleTransferTripletDataset(corpus, mode="val", instruments=INSTS, segment_length=SEG)
    segs, plans = ds.sample_raw_batch([0, 1])
    a1, a2, b2 = augment_triplets(ds.manipulators, INSTS, torch.from_numpy(segs), plans, ds.pad, SEG)
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedConverterPipeline

    pipe = FusedConverterPipeline(encoder, device="cpu")
    pipe.set_chains(ds.manipulators, INSTS, ds.pad, SEG)
    buffers = {k: v.clone() for k, v in state.model.state_dict().items()}
    val = float(pipe.loss(state, segs, plans))
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in buffers.items())
    with torch.no_grad():
        want = float(converter_loss_fn(state.model.train(), encoder, a1, a2, b2))
        evaluated = float(converter_loss_fn(state.model.eval(), encoder, a1, a2, b2))
    state.model.load_state_dict(buffers)
    assert val == pytest.approx(want, rel=1e-6)
    assert abs(evaluated - val) > 1e-4 * abs(val)  # running statistics give another number

    # resume: picks up after epoch 1 and runs the second (the generic walk this time)
    state = train_converter(corpus, run, encoder, epochs=2, fused=False, **kw)
    assert state.step == 4
    assert sorted(os.listdir(os.path.join(run, "ckpt_conv"))) == ["step_00000001.pt", "step_00000002.pt"]
    assert [r["epoch"] for r in _records(run)] == [0, 1]
    with pytest.raises(ValueError, match="condition_dimension"):
        train_converter(corpus, run, encoder, converter_cfg=TCNConfig(), device="cpu")


def test_converter_cli_trains_from_the_fxencoder_checkpoint(corpus, tmp_path, capsys):
    enc_run, conv_run = str(tmp_path / "enc"), str(tmp_path / "conv")
    common = ["--data_dir", corpus, "--epochs", "1", "--steps_per_epoch", "1", "--batch_items", "1",
              "--segment_length", str(SEG), "--fused", "--device", "cpu", "--val_every", "0",
              "--encoder_config", json.dumps(ENC)]
    assert cli.main(["fxencoder", "--out_dir", enc_run, *common]) == 0
    ckpt = os.path.join(enc_run, "ckpt", "step_00000001.pt")
    assert os.path.isfile(ckpt)
    assert cli.main(["converter", "--out_dir", conv_run, "--encoder_ckpt", ckpt, "--remat",
                     "--ori_weight", "0.5", "--dtype", "bfloat16",
                     "--converter_config", json.dumps(TCN), *common]) == 0
    (rec,) = _records(conv_run)
    assert rec["model"] == "converter" and np.isfinite(rec["loss"]) and "val_loss" not in rec
    assert os.listdir(os.path.join(conv_run, "ckpt_conv")) == ["step_00000001.pt"]
    with pytest.raises(SystemExit):
        cli.main(["converter", "--out_dir", conv_run, *common])
    assert "converter training requires --encoder_ckpt" in capsys.readouterr().err
    os.makedirs(os.path.join(tmp_path, "orbax", "3"))
    with pytest.raises(ValueError, match="orbax checkpoint directory.*flatten_dict"):
        cli.main(["converter", "--out_dir", conv_run, "--encoder_ckpt", str(tmp_path / "orbax"),
                  *common])


def test_train_bench_tiny_prints_its_json_line(capsys):
    assert train_bench.main(["--tiny", "--device", "cpu", "--steps", "1", "--batch", "1",
                             "--length", "4096"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    for key in ("contrastive_step_s", "contrastive_audio_s_per_s", "converter_step_s",
                "converter_steps_per_s", "converter_audio_s_per_s"):
        assert out[key] > 0, key
