"""Inference-path profile of the PyTorch port: the FX normalizer's seconds
per stage and the whole-song path's split into phases (upload / normalize /
embed / convert / download), each phase ending in a wait for the card.

Counterpart of ``music_mixing_style_transfer_tpu/tools/infer_prof.py``,
with the same JSON keys. It attributes the wall time of
``MixingStyleTransfer.transfer_song_pcm``, phase by phase, with the
pipeline's own steps.

Run: ``python -m music_mixing_style_transfer_tpu_torch.tools.infer_prof
[--seconds 60] [--dtype bfloat16] [--stems /path/to/stem_dir]
[--skip_normalize] [--inference_device cpu]`` (default stems: synthetic
music-like noise from a seed; the card unless ``--inference_device cpu``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import sync

SR = 44100
INSTS = ("drums", "bass", "other", "vocals")


def _stems(args) -> np.ndarray:
    """``[4, 2, T]`` int16 stems of ``args.seconds`` (rounded to samples)."""
    rng = np.random.default_rng(1)
    T = int(round(args.seconds * SR))
    if args.stems:
        from ..data.wavio import read_wav_stereo_ct_i16

        out = []
        for inst in INSTS:
            x = read_wav_stereo_ct_i16(os.path.join(args.stems, inst + ".wav"))
            out.append(np.tile(x, (1, -(-T // x.shape[1])))[:, :T])
        return np.stack(out)
    env = (np.sin(2 * np.pi * np.arange(T) / 22050) > 0.7).astype(np.float32)
    return (rng.standard_normal((4, 2, T)) * (0.05 + 0.4 * env) * 20000).astype(np.int16)


def profile_normalize(args, normalizer, stems_pcm: np.ndarray) -> dict:
    """Seconds of each stage of the batched normalizer (second of two runs)."""
    b = normalizer.batched()
    cfg = b.cfg
    insts = list(INSTS)
    T = stems_pcm.shape[-1]
    x = torch.from_numpy(stems_pcm.astype(np.float32) / 32768.0).to(b.device)
    x = F.pad(x, (cfg.fft_size, cfg.fft_size))
    stages = {
        "loudness": lambda cur: b._stage_loudness(cur, insts),
        "eq": lambda cur: b._stage_eq(cur, insts, [T] * len(insts)),
        "compression": lambda cur: b._stage_compression(cur, insts),
        "imager": lambda cur: b._stage_imager(cur, insts),
    }
    out = {}
    for _ in range(2):
        cur = x
        for effect in cfg.effects:
            t0 = time.perf_counter()
            cur = stages[effect](cur)
            sync(cur)
            out[f"norm_{effect}_s"] = round(time.perf_counter() - t0, 3)
    return out


def profile_transfer(args, pipe, normalizer) -> dict:
    """Phase split of one whole song, the steps of ``transfer_song_pcm``
    (second of two runs, after a warm-up call)."""
    from ..infer.pipeline import _bucket

    cfg = pipe.cfg
    insts = list(cfg.instruments)
    S, L = len(insts), cfg.segment_length
    dev = pipe.engine.device
    inp, ref = _stems(args), _stems(args)
    T = inp.shape[-1]
    pipe.transfer_song_pcm(inp, ref)  # warm-up: kernel builds, cuDNN's choices

    out = {}
    for _ in range(2):
        t0 = time.perf_counter()
        in_dev = torch.from_numpy(inp).to(dev)
        ref_dev = torch.from_numpy(ref).to(dev)
        sync([in_dev, ref_dev])
        out["upload_s"] = round(time.perf_counter() - t0, 3)

        Tb = -(-T // L) * L
        t0 = time.perf_counter()
        x = in_dev.float() * (1.0 / 32768.0)
        if normalizer is not None:
            fft = normalizer.cfg.fft_size
            x = normalizer.batched().normalize_device(F.pad(x, (fft, fft + Tb - T)), insts, [T] * S)
            y_in = x[:, :, fft : fft + Tb].clamp(-1.0, 1.0) * (torch.arange(Tb, device=dev) < T)
        else:
            y_in = F.pad(x, (0, Tb - T))
        sync(y_in)
        out["normalize_s"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        embs = pipe._embed_group_pcm(ref_dev, T)
        sync(embs)
        out["embed_s"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        n = Tb // L
        cond = embs.repeat_interleave(n, dim=0)
        segs = y_in.reshape(S, 2, n, L).permute(0, 2, 1, 3).reshape(S * n, 2, L)
        B_in = _bucket(S * n)
        segs = F.pad(segs, (0, 0, 0, 0, 0, B_in - S * n))
        cond = F.pad(cond, (0, 0, 0, B_in - S * n))
        y = pipe.engine._convert_multi(segs, cond)
        y = y[: S * n].reshape(S, n, 2, L).permute(0, 2, 1, 3).reshape(S, 2, n * L)
        pcm16 = torch.round(y[:, :, :T].sum(0) * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)
        sync(pcm16)
        out["convert_s"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        pcm16.cpu().numpy()
        out["download_s"] = round(time.perf_counter() - t0, 3)
    total = sum(v for k, v in out.items() if k.endswith("_s"))
    out["total_s"] = round(total, 3)
    out["rtf"] = round(args.seconds / total, 1)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--stems", type=str, default=None,
                   help="dir with {drums,bass,other,vocals}.wav (tiled to --seconds)")
    p.add_argument("--skip_normalize", action="store_true")
    p.add_argument("--inference_device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


@torch.inference_mode()
def run(args) -> dict:
    """The profile as a dict: the published widths, the default inference
    and normalization settings, the port's copy of the MUSDB18 features."""
    from ..config import InferenceConfig, NormalizationConfig
    from ..infer.pipeline import MixingStyleTransfer, StyleTransferEngine
    from ..normalize import AudioEffectsNormalizer

    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")
    engine = StyleTransferEngine(dtype=args.dtype, device=args.inference_device)
    normalizer = None
    if not args.skip_normalize:
        normalizer = AudioEffectsNormalizer(
            os.path.join(here, "musdb18_fxfeatures_eqcompimagegain.npy"),
            NormalizationConfig(), device=args.inference_device,
        )
    cfg = InferenceConfig(dtype=args.dtype, normalize_input=normalizer is not None)
    pipe = MixingStyleTransfer(engine, cfg, normalizer=normalizer)
    dev = engine.device
    out = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": args.dtype, "seconds": args.seconds,
    }
    if normalizer is not None:
        out.update(profile_normalize(args, normalizer, _stems(args)))
    out.update(profile_transfer(args, pipe, normalizer))
    return out


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
