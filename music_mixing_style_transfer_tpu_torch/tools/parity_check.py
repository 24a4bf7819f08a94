"""Checkpoint parity harness: the port's models against an independent
forward on the same weights.

Counterpart of ``music_mixing_style_transfer_tpu/tools/parity_check.py``.
Given a checkpoint (a published ``.pt`` or anything
``models/checkpoints.py:load_model_state`` reads), the port's
``FXencoder`` / ``MixFXcloner`` (K1 in the converter's blocks 3-13 on the
card) run against a functional forward written here from the raw state
dict with ``F.conv1d`` / ``F.batch_norm`` (no port module involved), or,
with ``--reference_root``, against the reference's own classes
(``tools/reference_import.py``). Both sides run on ``--device`` (the card
by default) with TF32 off. It prints the FXencoder embedding cosine and the
MixFXcloner waveform NRMSE and max error, then one JSON line.

    python -m music_mixing_style_transfer_tpu_torch.tools.parity_check \
        --enc weights/FXencoder_ps.pt [--conv weights/MixFXcloner_ps.pt] \
        [--wav song.wav] [--seconds 5] [--reference_root ../reference] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FXencoderConfig, TCNConfig
from ..utils.device import full_float32, resolve_device


def _conv_bn(t, sd, base: str, stride: int) -> torch.Tensor:
    """Reflect SAME pad -> conv -> eval BN -> ReLU (one ``Conv1d_layer``)."""
    w = sd[f"{base}.conv1d.weight"]
    pad = w.shape[-1] - 1
    t = F.pad(t, (pad // 2, pad - pad // 2), mode="reflect")
    t = F.conv1d(t, w, sd[f"{base}.conv1d.bias"], stride=stride)
    t = F.batch_norm(
        t, sd[f"{base}.batch_norm.running_mean"], sd[f"{base}.batch_norm.running_var"],
        sd[f"{base}.batch_norm.weight"], sd[f"{base}.batch_norm.bias"], training=False,
    )
    return F.relu(t)


def functional_fxencoder_forward(
    sd: Dict[str, torch.Tensor], x: torch.Tensor, config: Optional[FXencoderConfig] = None
) -> torch.Tensor:
    """FXencoder eval forward from a raw state dict: each block
    ``conv2(conv1(x) + x)``, conv2 strided, then the mean over time."""
    strides = (config or FXencoderConfig()).strides
    t = x
    with torch.no_grad():
        for i, stride in enumerate(strides):
            t = _conv_bn(t, sd, f"encoder.{i}.conv1.conv1d", 1) + t
            t = _conv_bn(t, sd, f"encoder.{i}.conv2.conv1d", stride)
        return t.mean(-1)


def functional_mixfxcloner_forward(
    sd: Dict[str, torch.Tensor], x: torch.Tensor, cond: torch.Tensor,
    config: Optional[TCNConfig] = None,
) -> torch.Tensor:
    """MixFXcloner eval forward from a raw state dict: each block
    ``FiLM(lrelu(BN(conv_d(x)))) + res(x)`` with ``d = growth ** (n % stack)``,
    then the 1x1 output conv and the clamp."""
    cfg = config or TCNConfig()
    t = x
    with torch.no_grad():
        for n in range(cfg.nblocks):
            base = f"blocks.{n}"
            w = sd[f"{base}.conv1.weight"]
            d = cfg.dilation_growth ** (n % cfg.stack_size)
            h = F.conv1d(t, w, None, padding=((w.shape[-1] - 1) * d) // 2, dilation=d)
            h = F.batch_norm(
                h, sd[f"{base}.bn.running_mean"], sd[f"{base}.bn.running_var"],
                sd[f"{base}.bn.weight"], sd[f"{base}.bn.bias"], training=False,
            )
            h = F.leaky_relu(h, 0.01)
            film = F.linear(cond, sd[f"{base}.film.film_fc.weight"],
                            sd[f"{base}.film.film_fc.bias"]).unsqueeze(-1)
            r, b = torch.split(film, film.shape[1] // 2, dim=1)
            t = r * h + b + F.conv1d(t, sd[f"{base}.res.weight"], None, groups=t.shape[1])
        out = F.conv1d(t, sd["output.weight"], sd["output.bias"])
        return torch.clamp(out, -1, 1)


def _reference_forward(kind: str, sd, args, reference_root: str, device) -> torch.Tensor:
    """The reference's own ``FXencoder`` or ``TCNModel`` on ``device``."""
    from .reference_import import (
        build_reference_fxencoder,
        build_reference_tcn,
        import_reference_networks,
    )

    arch = import_reference_networks(reference_root)
    build = build_reference_fxencoder if kind == "fxencoder" else build_reference_tcn
    model = build(arch, reference_root)
    model.load_state_dict({k: v.cpu() for k, v in sd.items()})
    model = model.to(device).eval()
    with torch.no_grad():
        return model(*args)


def _state_dict(ckpt: str, device) -> Dict[str, torch.Tensor]:
    from ..models.weights import load_torch_state_dict

    return {k: v.to(device) for k, v in load_torch_state_dict(ckpt).items()}


def _port_model(cls, config, ckpt: str, device):
    from ..models.checkpoints import load_model_state

    return load_model_state(ckpt, cls(config)).to(device).eval()


def check_encoder(
    enc_ckpt: str, x: np.ndarray, reference_root: Optional[str] = None, device="cuda",
    config: Optional[FXencoderConfig] = None,
) -> dict:
    """Embedding cosine of the port's FXencoder against the independent
    forward, on ``x [B, 2, T]``."""
    from ..models import FXencoder

    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    with full_float32(), torch.inference_mode():
        sd = _state_dict(enc_ckpt, dev)
        if reference_root:
            ref = _reference_forward("fxencoder", sd, (xt,), reference_root, dev)
        else:
            ref = functional_fxencoder_forward(sd, xt, config)
        ours = _port_model(FXencoder, config, enc_ckpt, dev)(xt)
        cos = F.cosine_similarity(ours.double(), ref.double(), dim=-1, eps=1e-12)
    out = {"embedding_cosine": float(cos.mean()), "embedding_cosine_min": float(cos.min()),
           "max_abs_err": float((ours - ref).abs().max()), "max_abs_ref": float(ref.abs().max())}
    print(f"FXencoder embedding cosine: {out['embedding_cosine']:.8f}  (target >= 0.999)")
    return out


def check_converter(
    conv_ckpt: str, x: np.ndarray, cond: np.ndarray, reference_root: Optional[str] = None,
    device="cuda", config: Optional[TCNConfig] = None,
) -> dict:
    """Waveform NRMSE and max error of the port's MixFXcloner against the
    independent forward, on ``x [B, 2, T]`` under ``cond [B, D]``."""
    from ..models import MixFXcloner

    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    ct = torch.from_numpy(np.ascontiguousarray(cond, np.float32)).to(dev)
    with full_float32(), torch.inference_mode():
        sd = _state_dict(conv_ckpt, dev)
        if reference_root:
            ref = _reference_forward("mixfxcloner", sd, (xt, ct), reference_root, dev)
        else:
            ref = functional_mixfxcloner_forward(sd, xt, ct, config)
        ours = _port_model(MixFXcloner, config, conv_ckpt, dev)(xt, ct)
        diff = (ours - ref).double()
        nrmse = float(diff.pow(2).mean().sqrt() / (ref.double().pow(2).mean().sqrt() + 1e-12))
    out = {"nrmse": nrmse, "max_abs_err": float(diff.abs().max()),
           "max_abs_ref": float(ref.abs().max())}
    print(f"MixFXcloner waveform NRMSE: {nrmse:.3e}, max error {out['max_abs_err']:.3e}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--enc", type=str, default=None)
    p.add_argument("--conv", type=str, default=None)
    p.add_argument("--wav", type=str, default=None)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--reference_root", type=str, default=None,
                   help="a checkout of the reference repository: the independent side then "
                        "runs its own model classes instead of the functional forward")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of both sides: cuda (default) or cpu")
    args = p.parse_args(argv)
    if not (args.enc or args.conv):
        p.error("provide --enc and/or --conv checkpoint paths")

    n = int(44100 * args.seconds)
    if args.wav:
        from ..data.wavio import read_wav_stereo_ct

        x = read_wav_stereo_ct(args.wav)[None, :, :n]
    else:
        x = np.random.default_rng(0).standard_normal((1, 2, n)) * 0.1
    x = np.asarray(x, np.float32)
    report = {"device": args.device}
    if args.enc:
        report["fxencoder"] = check_encoder(args.enc, x, args.reference_root, args.device)
    if args.conv:
        cond = np.random.default_rng(1).standard_normal((1, 2048)).astype(np.float32)
        report["mixfxcloner"] = check_converter(args.conv, x, cond, args.reference_root,
                                                args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
