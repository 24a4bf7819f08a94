"""Acceptance checks on the card, at production shapes.

Counterpart of ``music_mixing_style_transfer_tpu/tools/tpu_checks.py``:
its three model checks, for the H100 (the envelope kernel's check is
``chip_smoke.py``'s ``envelope_vs_plain``). Weights are random, from a seed
(``models/fast_init.py``); the audio is the reference's shipped samples
from ``--reference_root`` (default ``tools/reference_import.py``'s
``DEFAULT_REFERENCE_ROOT``) when they are there, else seeded noise. Called
as functions, the checks take seeded noise unless given a root.

1. **K1 against its plain version**, per dilation, bf16, at
   ``[2, SEG, 128]`` (``ops/cuda/tcn_block.py``).
2. **The whole MixFXcloner, kernel path against plain path**: the same
   weights and input, every fused block once through K1 and once through
   its plain version (float32 and bf16).
3. **bf16 against float32 fidelity**: the FXencoder embedding cosine (min
   and mean over 8 segments) and the converter's waveform NRMSE (2
   segments, conditioned on the float32 embeddings).

It prints one line a check and writes the JSON report to ``--out``, or
prints it. It runs on ``--device`` (the card by default).

    python -m music_mixing_style_transfer_tpu_torch.tools.card_checks [--out FILE] \
        [--reference_root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..models.fast_init import seeded_model
from ..ops.cuda.tcn_block import converter_plain
from ..utils.device import full_float32, resolve_device
from .reference_import import DEFAULT_REFERENCE_ROOT

SEG = 2**19  # production segment length (reference style_transfer.py:362)
DILATIONS = (8, 64, 512, 4096, 8192)
BF16_TOL = 2e-2   # K1 bf16 vs its plain version, and the bf16 model paths: over max|plain|, NRMSE
F32_TOL = 1e-4    # the float32 model paths: max error over max|plain|
COSINE_MIN = 0.999  # the north star's embedding cosine (BASELINE.md)


def load_sample_segments(n: int, length: int, reference_root: Optional[str] = None) -> np.ndarray:
    """``[n, 2, length]`` float32: the shipped sample stems of the reference
    checkout at ``reference_root``, tiled, when it holds them, then seeded
    noise (all of it with no root)."""
    segs = []
    path = reference_root and os.path.join(reference_root, "samples", "style_transfer", "#0",
                                           "separated", "mdx_extra", "input")
    if path and os.path.isdir(path):
        from ..data.wavio import read_wav_stereo_ct

        for inst in ("drums", "bass", "other", "vocals"):
            x = read_wav_stereo_ct(os.path.join(path, inst + ".wav"))
            reps = int(np.ceil(n / 4 * length / max(x.shape[1], 1))) + 1
            tiled = np.tile(x, (1, reps))
            for i in range(max(1, n // 4)):
                segs.append(tiled[:, i * length : (i + 1) * length])
    rng = np.random.default_rng(0)
    while len(segs) < n:
        segs.append((rng.standard_normal((2, length)) * 0.1).astype(np.float32))
    return np.stack(segs[:n]).astype(np.float32)


def _nrmse(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / (b.pow(2).mean().sqrt() + 1e-12))


def check_kernel_blocks(device="cuda", length: Optional[int] = None) -> dict:
    """K1 (bf16) against its plain version per dilation, at ``[2, length, 128]``
    (``length`` defaults to ``SEG``)."""
    from ..ops.cuda.tcn_block import tcn_block, tcn_block_reference

    dev = resolve_device(device)
    length = length or SEG
    B, C, K = 2, 128, 15
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, scale=1.0, lo=None):
        if lo is not None:
            return (lo + (2 - 2 * lo) * torch.rand(*shape, generator=gen)).to(dev)
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    results = {}
    with full_float32(), torch.inference_mode():
        for d in DILATIONS:
            x = rnd(B, length, C, scale=0.5).bfloat16()
            w = rnd(K, C, C, scale=0.05).bfloat16()
            s, t = rnd(C, lo=0.5), rnd(C, scale=0.1)
            r, b, wr = rnd(B, C), rnd(B, C, scale=0.1), rnd(C, scale=0.5)
            got = tcn_block(x, w, s, t, r, b, wr, d).float()
            want = tcn_block_reference(x.float(), w.float(), s, t, r, b, wr, d)
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-12)
            results[str(d)] = {"max_abs_err": err, "rel_err": rel}
            print(f"K1 bf16 d={d}: max_abs_err={err:.3e} rel={rel:.3e}", flush=True)
    results["pass"] = all(v["rel_err"] < BF16_TOL for v in results.values())
    return results


def check_full_model(device="cuda", length: Optional[int] = None,
                     reference_root: Optional[str] = None) -> dict:
    """The whole MixFXcloner: the kernel path (K1 in the fused blocks)
    against the plain path (``ops/cuda/tcn_block.py:converter_plain``) on
    the same weights and input, float32 and bf16."""
    from ..models import MixFXcloner

    dev = resolve_device(device)
    x = torch.from_numpy(load_sample_segments(2, length or SEG, reference_root)).to(dev)
    cond = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 2048)).astype(np.float32)).to(dev)
    out = {}
    with full_float32(), torch.inference_mode():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tcn = seeded_model(MixFXcloner, 1, dev, dtype)
            got = tcn(x.to(dtype), cond.to(dtype)).float()
            want = converter_plain(tcn, x.to(dtype), cond.to(dtype)).float()
            err = float((got - want).abs().max())
            out[name] = {"max_abs_err": err, "max_abs_ref": float(want.abs().max()),
                         "nrmse": _nrmse(got, want)}
            print(f"full model kernel vs plain ({name}): max_abs_err={err:.3e} "
                  f"nrmse={out[name]['nrmse']:.3e}", flush=True)
            del tcn, got, want
    f32, bf16 = out["float32"], out["bfloat16"]
    out["pass"] = bool(f32["max_abs_err"] <= F32_TOL * max(f32["max_abs_ref"], 1e-6)
                       and bf16["nrmse"] < BF16_TOL)
    return out


def check_bf16_fidelity(device="cuda", length: Optional[int] = None,
                        reference_root: Optional[str] = None) -> dict:
    """bf16 against float32: FXencoder embedding cosine over 8 segments,
    converter waveform NRMSE over 2."""
    from ..models import FXencoder, MixFXcloner

    dev = resolve_device(device)
    x = torch.from_numpy(load_sample_segments(8, length or SEG, reference_root)).to(dev)
    with full_float32(), torch.inference_mode():
        enc = seeded_model(FXencoder, 0, dev)
        e32 = enc(x)
        e16 = enc.to(torch.bfloat16)(x.bfloat16()).float()
        cos = torch.nn.functional.cosine_similarity(e32.double(), e16.double(), dim=-1)
        del enc
        tcn = seeded_model(MixFXcloner, 1, dev)
        cond = e32[:2]
        y32 = tcn(x[:2], cond)
        y16 = tcn.to(torch.bfloat16)(x[:2].bfloat16(), cond.bfloat16()).float()
        nrmse = _nrmse(y16, y32)
        del tcn
    out = {
        "embedding_cosine_min": float(cos.min()),
        "embedding_cosine_mean": float(cos.mean()),
        "converter_nrmse": nrmse,
        # the north star is cosine >= 0.999 against the reference; bf16 against
        # float32 is the margin bf16 serving leaves against it
        "pass": bool(cos.min() >= COSINE_MIN),
    }
    print(f"bf16 fidelity: cosine min={out['embedding_cosine_min']:.6f} "
          f"mean={out['embedding_cosine_mean']:.6f} converter nrmse={nrmse:.3e}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, default=None, help="write the JSON report here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--reference_root", type=str, default=DEFAULT_REFERENCE_ROOT,
                   help="a reference checkout whose samples are the audio (seeded noise "
                        "where it has none; an empty value: seeded noise)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    report = {"device": str(dev), "segment_length": SEG}
    if dev.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(dev)
    report["kernel_blocks"] = check_kernel_blocks(dev)
    report["full_model"] = check_full_model(dev, reference_root=args.reference_root)
    report["bf16_fidelity"] = check_bf16_fidelity(dev, reference_root=args.reference_root)
    report["all_pass"] = all(report[k]["pass"] for k in ("kernel_blocks", "full_model",
                                                         "bf16_fidelity"))
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"report -> {args.out}  all_pass={report['all_pass']}")
    else:
        print(text)
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
