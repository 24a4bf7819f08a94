"""PyTorch port: JAX-trained weights in the port, on the CPU.

- ``models/torch_import.py`` (numpy and torch only) maps a state dict to
  the JAX package's flax variables bit for bit as the JAX package does;
- the JAX package's orbax artifacts (a ``convert_ckpt`` directory, a
  trainer directory) exported by the recipe the port's error message
  carries load into the port through the ``.npz`` archive, and the port's
  forward then equals JAX's within 1e-4;
- the port's own ``ckpt/`` directory loads its newest step (the loader,
  the engine that ``serve.py`` builds, and ``train.cli converter``);
- ``models/convert_ckpt.py`` turns an archive into a ``.pt`` that both
  packages read back bit for bit.

Small widths: an encoder of 2 blocks, a converter of 4 blocks at width 128
(block 3 takes the fused block's dispatch: its plain version here).
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_mixing_style_transfer_tpu.config import FXencoderConfig as JaxEncCfg
from music_mixing_style_transfer_tpu.config import TCNConfig as JaxTCNCfg
from music_mixing_style_transfer_tpu.models import FXencoder as JaxFXencoder
from music_mixing_style_transfer_tpu.models import MixFXcloner as JaxMixFXcloner
from music_mixing_style_transfer_tpu.models import torch_import as jti
from music_mixing_style_transfer_tpu.models.fast_init import fast_init as jax_fast_init
from music_mixing_style_transfer_tpu.train.checkpoint import CheckpointManager as JaxCkptManager
from music_mixing_style_transfer_tpu.train.state import create_train_state
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig
from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine
from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
from music_mixing_style_transfer_tpu_torch.models import convert_ckpt
from music_mixing_style_transfer_tpu_torch.models import torch_import as pti
from music_mixing_style_transfer_tpu_torch.models.checkpoints import (
    is_flax_archive,
    load_flax_archive,
    load_model_state,
    save_flax_archive,
)
from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
from music_mixing_style_transfer_tpu_torch.models.weights import (
    fxencoder_from_jax,
    load_torch_state_dict,
    mixfxcloner_from_jax,
)
from music_mixing_style_transfer_tpu_torch.train import cli
from music_mixing_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
from music_mixing_style_transfer_tpu_torch.train.state import TrainState, make_optimizer

torch.set_num_threads(2)
ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
TCN = dict(condition_dimension=16, nblocks=4, channel_width=128)
MODELS = {
    # name: (port class, port config, JAX class, JAX config, port from_jax, blocks)
    "fxencoder": (FXencoder, FXencoderConfig(**ENC), JaxFXencoder, JaxEncCfg(**ENC),
                  fxencoder_from_jax, 2),
    "mixfxcloner": (MixFXcloner, TCNConfig(**TCN), JaxMixFXcloner, JaxTCNCfg(**TCN),
                    mixfxcloner_from_jax, 4),
}
JAX_FROM_TORCH = {"fxencoder": jti.fxencoder_from_torch, "mixfxcloner": jti.mixfxcloner_from_torch}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def assert_bit_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def port_model(name, seed):
    """A small port model with random weights and BN statistics."""
    cls, cfg = MODELS[name][:2]
    m = fast_init(cls(cfg), seed=seed).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.copy_(torch.rand(mod.running_mean.shape, generator=g) - 0.5)
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
    return m


def jax_variables(name, seed):
    """Random JAX variables of the small model, BN statistics included."""
    _, _, jcls, jcfg, _, _ = MODELS[name]
    args = (jnp.zeros((1, 2, 2048)),) + ((jnp.zeros((1, 16)),) if name == "mixfxcloner" else ())
    v = jax_fast_init(jcls(config=jcfg), *args, seed=seed)  # no init program to compile
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
                         v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def forwards(name, variables, module, rng):
    """JAX's forward of ``variables`` and the port module's, on one input."""
    _, _, jcls, jcfg, _, _ = MODELS[name]
    x = (rng.standard_normal((2, 2, 4096)) * 0.3).astype(np.float32)
    args = [x] + ([(rng.standard_normal((2, 16)) * 0.5).astype(np.float32)]
                  if name == "mixfxcloner" else [])
    want = np.asarray(jcls(config=jcfg).apply(variables, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = module.eval()(*map(torch.from_numpy, args)).numpy()
    return got, want


def run_recipe(message: str, ckpt_dir: str, name: str, out: str, monkeypatch) -> None:
    """The export command that the port's error message carries, run here
    (in this process, which has JAX) on ``ckpt_dir``."""
    code = re.search(r'python -c "(.*?)" <orbax dir>', message).group(1)
    monkeypatch.setattr(sys, "argv", ["-c", ckpt_dir, name, out])
    exec(code, {})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_torch_import_twin_is_jaxs_bit_for_bit(tmp_path, name):
    m = port_model(name, seed=3)
    sd = m.state_dict()
    pt = str(tmp_path / "ref.pt")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, pt)
    want = JAX_FROM_TORCH[name](jti.load_torch_state_dict(pt), n_blocks=MODELS[name][5])
    got = getattr(pti, f"load_{name}_variables")(pt)
    assert_bit_equal(got, want)
    assert_bit_equal(getattr(pti, f"{name}_from_torch")(sd), want)  # the live state dict
    back = MODELS[name][4](got)  # and the inverse is the port's own mapping
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("kind", ["convert_ckpt", "trainer"])
def test_jax_orbax_exported_by_the_recipe_gives_jaxs_forward(tmp_path, rng, kind, monkeypatch):
    import orbax.checkpoint as ocp

    for seed, name in enumerate(sorted(MODELS)):
        variables = jax_variables(name, seed)
        ckpt = str(tmp_path / f"{kind}_{name}")
        if kind == "convert_ckpt":  # what JAX's models/convert_ckpt.py writes
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(os.path.join(ckpt, "variables"), variables, force=True)
            ckptr.wait_until_finished()
        else:  # JAX train/checkpoint.py: two steps, the newest holds the weights
            mgr = JaxCkptManager(ckpt)
            old = jax.tree.map(jnp.zeros_like, variables)
            for step, v in ((1, old), (2, variables)):
                mgr.save(step, create_train_state(v, optax.adam(1e-3)).replace(step=jnp.asarray(step)))
        module = MODELS[name][0](MODELS[name][1])
        with pytest.raises(ValueError, match="orbax") as err:
            load_model_state(ckpt, module)
        npz = str(tmp_path / f"{kind}_{name}.npz")
        run_recipe(str(err.value), ckpt, name, npz, monkeypatch)
        assert is_flax_archive(npz)
        assert_bit_equal(load_flax_archive(npz), jax.tree.map(np.asarray, variables))
        got, want = forwards(name, variables, load_model_state(npz, module), rng)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_trainer_directory_loads_its_newest_step(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "run" / "ckpt")
    mgr = CheckpointManager(ckpt, keep=2)
    models = [port_model("fxencoder", seed) for seed in (1, 2)]
    for step, m in enumerate(models, 1):
        mgr.save(step, TrainState(step, m, make_optimizer(m.parameters(), 1e-3)))
    newest = models[1].state_dict()

    def same(module):
        return all(torch.equal(module.state_dict()[k], v) for k, v in newest.items())

    assert same(load_model_state(ckpt, FXencoder(FXencoderConfig(**ENC))))
    # the engine that serve.py and the CLIs build
    eng = StyleTransferEngine(encoder_cfg=FXencoderConfig(**ENC), converter_cfg=TCNConfig(**TCN),
                              ckpt_path_enc=ckpt, device="cpu")
    assert same(eng.encoder)
    # train.cli converter --encoder_ckpt <dir>: the encoder handed to the trainer
    seen = {}
    monkeypatch.setattr(cli, "train_converter",
                        lambda data_dir, out_dir, encoder, **kw: seen.setdefault("enc", encoder))
    assert cli.main(["converter", "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "c"),
                     "--encoder_ckpt", ckpt, "--device", "cpu",
                     "--encoder_config", '{"channels": [8, 16], "kernels": [25, 15], '
                     '"strides": [4, 4], "dilation": [1, 1]}']) == 0
    assert same(seen["enc"])


def test_convert_ckpt_round_trip(tmp_path, capsys):
    """.npz -> convert_ckpt -> .pt, read by both packages."""
    for seed, name in enumerate(sorted(MODELS)):
        variables = getattr(pti, f"{name}_from_torch")(port_model(name, seed).state_dict())
        npz, pt = str(tmp_path / f"{name}.npz"), str(tmp_path / "out" / f"{name}.pt")
        save_flax_archive(variables, npz)
        assert convert_ckpt.main(["--model", name, "--flax_npz", npz, "--out", pt]) == 0
        assert f"converted {name}" in capsys.readouterr().out
        raw = torch.load(pt, weights_only=True)["model"]
        assert all(k.startswith("module.") for k in raw)  # the published layout
        assert_bit_equal(JAX_FROM_TORCH[name](jti.load_torch_state_dict(pt),
                                              n_blocks=MODELS[name][5]), variables)
        assert_bit_equal(getattr(pti, f"load_{name}_variables")(pt), variables)
        assert not is_flax_archive(pt)  # a torch.save file is a zip too
        cls, cfg = MODELS[name][:2]
        a, b = load_model_state(pt, cls(cfg)), load_model_state(npz, cls(cfg))
        sd = load_torch_state_dict(pt)
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]) and torch.equal(v, sd[k]), k


def test_orbax_directories_raise_with_the_recipe(tmp_path):
    (tmp_path / "conv" / "variables").mkdir(parents=True)
    (tmp_path / "trainer" / "3").mkdir(parents=True)
    for d in ("conv", "trainer"):
        with pytest.raises(ValueError, match=r"orbax checkpoint directory.*flatten_dict.*np\.savez"):
            load_model_state(str(tmp_path / d), FXencoder(FXencoderConfig(**ENC)))
    with pytest.raises(ValueError, match="orbax step directories.*flatten_dict"):
        CheckpointManager(str(tmp_path / "trainer"))
    with pytest.raises(FileNotFoundError, match="step_<n>.pt"):
        load_model_state(str(tmp_path / "missing"), FXencoder(FXencoderConfig(**ENC)))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_model_state(str(tmp_path / "empty"), FXencoder(FXencoderConfig(**ENC)))
