"""PyTorch port: the parity harness, the card checks, the demo and the
reference import, on the CPU.

- ``tools/parity_check.py``'s functional forwards (raw state dict,
  ``F.conv1d``) equal the port's modules and the JAX package's own
  functional forwards within 1e-4 (the models' tolerance); its report on
  a small synthetic ``.pt`` reads cosine ~1 and NRMSE ~0;
- ``tools/card_checks.py`` and the demo raise without a card unless asked
  for the CPU; the card checks then run at a short segment and write their
  JSON only where asked;
- the reference's own classes are imported only when called; the check
  against them skips where no reference checkout is present, as
  ``tests/test_reference_parity.py`` does.
"""
import json
import os

import numpy as np
import pytest
import torch

from music_mixing_style_transfer_tpu.tools import parity_check as jparity
from music_mixing_style_transfer_tpu.tools.reference_import import (
    DEFAULT_REFERENCE_ROOT,
    reference_available,
)
from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig
from music_mixing_style_transfer_tpu_torch.examples import demo_style_transfer as demo
from music_mixing_style_transfer_tpu_torch.infer.pipeline import MixingStyleTransfer
from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
from music_mixing_style_transfer_tpu_torch.tools import card_checks, parity_check
from music_mixing_style_transfer_tpu_torch.tools import reference_import

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 12 blocks (the JAX tool's functional forward takes the published strides), narrow
ENC = dict(channels=(4, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16))
TCN = dict(condition_dimension=16, nblocks=5, channel_width=128)  # blocks 3-4 take K1's dispatch
NO_CARD = not torch.cuda.is_available()


def randomized(module, seed):
    """``module`` with random weights and BN statistics, in eval mode."""
    fast_init(module, seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) - 0.5)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
    return module.eval()


def save_pt(module, path):
    """The published checkpoints' layout: ``{"model": {"module." + name: tensor}}``."""
    torch.save({"model": {"module." + k: v for k, v in module.state_dict().items()}}, path)
    return path


def test_functional_forwards_equal_the_modules_and_jaxs(rng):
    enc = randomized(FXencoder(FXencoderConfig(**ENC)), 1)
    conv = randomized(MixFXcloner(TCNConfig(**TCN)), 2)
    assert [n for n, b in enumerate(conv.blocks) if b.uses_kernel()] == [3, 4]
    x = (rng.standard_normal((2, 2, 2**14)) * 0.2).astype(np.float32)
    cond = (rng.standard_normal((2, 16)) * 0.5).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    with torch.no_grad():
        for got, module_out, jax_tool in (
            (parity_check.functional_fxencoder_forward(enc.state_dict(), xt, FXencoderConfig(**ENC)),
             enc(xt), jparity.torch_fxencoder_forward(
                 {k: v.numpy() for k, v in enc.state_dict().items()}, x)),
            (parity_check.functional_mixfxcloner_forward(conv.state_dict(), xt, ct, TCNConfig(**TCN)),
             conv(xt, ct), jparity.torch_mixfxcloner_forward(
                 {k: v.numpy() for k, v in conv.state_dict().items()}, x, cond, n_blocks=5)),
        ):
            np.testing.assert_allclose(got.numpy(), module_out.numpy(), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), jax_tool, rtol=1e-4, atol=1e-5)


def test_parity_report_on_a_synthetic_checkpoint(tmp_path, rng, capsys):
    enc_pt = save_pt(randomized(FXencoder(FXencoderConfig(**ENC)), 3), str(tmp_path / "enc.pt"))
    conv = randomized(MixFXcloner(TCNConfig(**TCN)), 4)
    with torch.no_grad():  # keep the output inside the clamp: a saturated comparison proves nothing
        conv.output.weight.mul_(0.01)
    conv_pt = save_pt(conv, str(tmp_path / "conv.pt"))
    x = (rng.standard_normal((2, 2, 2**14)) * 0.1).astype(np.float32)
    cond = rng.standard_normal((2, 16)).astype(np.float32)
    rep_e = parity_check.check_encoder(enc_pt, x, device="cpu", config=FXencoderConfig(**ENC))
    rep_c = parity_check.check_converter(conv_pt, x, cond, device="cpu", config=TCNConfig(**TCN))
    assert rep_e["embedding_cosine_min"] >= 0.99999
    assert rep_c["nrmse"] < 1e-5 and rep_c["max_abs_ref"] < 1.0
    out = capsys.readouterr().out
    assert "FXencoder embedding cosine: 1.0000" in out and "MixFXcloner waveform NRMSE" in out
    with pytest.raises(SystemExit):
        parity_check.main(["--device", "cpu"])  # neither --enc nor --conv
    if NO_CARD:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            parity_check.main(["--enc", enc_pt])


def test_card_checks_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch, capsys):
    tpu_checks = os.path.join(REPO, "TPU_CHECKS.json")
    with open(tpu_checks, "rb") as f:
        before = f.read()
    if NO_CARD:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            card_checks.main([])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(card_checks, "SEG", 1024)  # production's 2^19 takes minutes on the CPU
    # with no root, or a root without the reference's samples, the audio is seeded noise
    noise = card_checks.load_sample_segments(3, 64)
    assert noise.shape == (3, 2, 64) and np.array_equal(
        noise, card_checks.load_sample_segments(3, 64, str(tmp_path)))
    assert card_checks.main(["--device", "cpu", "--reference_root", ""]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("\n{") + 1 :])["all_pass"]
    assert os.listdir(tmp_path) == []  # without --out it prints, and writes nothing
    out = str(tmp_path / "report.json")
    assert card_checks.main(["--device", "cpu", "--reference_root", "", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["all_pass"] and report["device"] == "cpu" and report["segment_length"] == 1024
    assert set(report["kernel_blocks"]) == {"8", "64", "512", "4096", "8192", "pass"}
    assert report["full_model"]["float32"]["max_abs_err"] == 0.0  # the plain version on both sides
    assert report["bf16_fidelity"]["embedding_cosine_min"] >= 0.999
    with open(tpu_checks, "rb") as f:
        assert f.read() == before


def test_demo_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if NO_CARD:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            demo.main(["--out", str(tmp_path / "card")])
        assert not os.path.exists(tmp_path / "card")  # it raises before writing anything
    seen = {}

    def run_directory(self, target_dir, output_dir=None):
        """Stands in for the CPU run (tens of seconds: the normalizer's plain
        envelope); the card runs the whole demo (``chip_smoke.py``)."""
        seen.update(cfg=self.cfg, device=self.engine.device, norm=self.normalizer.device,
                    target=target_dir)
        return []

    monkeypatch.setattr(MixingStyleTransfer, "run_directory", run_directory)
    assert demo.main(["--device", "cpu", "--seconds", "0.5", "--out", str(tmp_path)]) == 0
    cfg = seen["cfg"]
    assert (cfg.dtype, cfg.segment_length, cfg.segment_length_ref) == ("bfloat16", 2**17, 2**17)
    assert cfg.normalize_input and cfg.do_not_separate and cfg.save_each_inst
    assert str(seen["device"]) == str(seen["norm"]) == "cpu"
    for name in ("input", "reference"):
        assert sorted(os.listdir(tmp_path / "song1" / "separated" / name)) == [
            f"{i}.wav" for i in sorted(demo.INSTRUMENTS)]
    defaults = demo.build_parser().parse_args([])
    assert (defaults.seconds, defaults.dtype, defaults.device) == (15.0, "bfloat16", "cuda")


def test_reference_import_is_lazy(tmp_path):
    import subprocess
    import sys

    probe = ("import sys; import music_mixing_style_transfer_tpu_torch.tools.reference_import as r; "
             "print(sorted(m for m in ('torchaudio', 'pytorch_lightning', 'networks') "
             "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"
    assert not reference_import.reference_available(str(tmp_path))
    with pytest.raises(ImportError, match="reference repo not found"):
        reference_import.import_reference_networks(str(tmp_path))


@pytest.mark.skipif(not reference_available(DEFAULT_REFERENCE_ROOT),
                    reason="reference repo not available")
def test_parity_check_against_the_reference_classes(tmp_path, rng):
    enc_pt = save_pt(randomized(FXencoder(), 5), str(tmp_path / "enc.pt"))
    conv = randomized(MixFXcloner(), 6)
    with torch.no_grad():
        conv.output.weight.mul_(0.01)
        conv.output.bias.mul_(0.01)
    conv_pt = save_pt(conv, str(tmp_path / "conv.pt"))
    x = (rng.standard_normal((1, 2, 2**15)) * 0.1).astype(np.float32)
    cond = rng.standard_normal((1, 2048)).astype(np.float32)
    rep_e = parity_check.check_encoder(enc_pt, x, DEFAULT_REFERENCE_ROOT, device="cpu")
    rep_c = parity_check.check_converter(conv_pt, x[..., : 2**13], cond, DEFAULT_REFERENCE_ROOT,
                                         device="cpu")
    assert rep_e["embedding_cosine_min"] >= 0.999 and rep_c["nrmse"] < 1e-4
