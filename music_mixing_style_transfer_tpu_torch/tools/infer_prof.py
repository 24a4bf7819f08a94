"""Inference-path profile of the PyTorch port: one whole song through
``MixingStyleTransfer.transfer_song_pcm`` under ``utils/profiling.trace``,
its phases read from the program's own spans.

Counterpart of ``music_mixing_style_transfer_tpu/tools/infer_prof.py``,
with the same JSON keys: ``upload_s`` (span ``infer.upload``),
``normalize_s`` (``normalize.batch``) and ``norm_<stage>_s``
(``normalize.<stage>``), ``embed_s`` (``models.fx_encoder``), ``convert_s``
(``models.tcn``) and ``download_s`` (``infer.finish``: sum, quantization
and download), each summed over the span's calls: on the card the device
seconds of the operations launched inside it, on the CPU its host seconds.
``total_s`` is the request's host seconds (``infer.request``), and ``rtf``
the song's seconds over ``total_s``. The traced call follows a warm-up call
(kernel builds, cuDNN's choices).

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
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType

from ..utils.profiling import trace

SR = 44100
INSTS = ("drums", "bass", "other", "vocals")
PHASES = {"upload_s": "infer.upload", "normalize_s": "normalize.batch",
          "embed_s": "models.fx_encoder", "convert_s": "models.tcn", "download_s": "infer.finish"}


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


def profile_transfer(args, pipe) -> dict:
    """The phases of one traced ``transfer_song_pcm`` call, from its spans."""
    inp, ref = _stems(args), _stems(args)
    pipe.transfer_song_pcm(inp, ref)  # warm-up
    with trace() as prof:
        pipe.transfer_song_pcm(inp, ref)
    spans = dict(PHASES)
    if pipe.normalizer is not None:
        spans.update({f"norm_{stage}_s": "normalize." + stage
                      for stage in pipe.normalizer.batched().cfg.effects})
    names = set(spans.values()) | {"infer.request"}
    host = defaultdict(float)
    # the raw events: on the CPU the plain envelope's loop makes ~10^5 host
    # operations, too many for events()' tree
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names:
            host[e.name()] += e.duration_ns() * 1e-9
    seconds = host
    if pipe.engine.device.type == "cuda":
        seconds = defaultdict(float)
        for e in prof.events():  # a range's host side holds its kernels' time
            if e.device_type == DeviceType.CPU and e.name in names:
                seconds[e.name] += e.device_time_total * 1e-6
    out = {key: seconds[name] for key, name in spans.items()}
    out["total_s"] = host["infer.request"]
    out["rtf"] = args.seconds / out["total_s"]
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
    out.update(profile_transfer(args, pipe))
    return out


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
