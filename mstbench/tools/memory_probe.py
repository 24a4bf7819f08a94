"""Peak device memory of the converter's one whole-song dispatch
(``StyleTransferEngine._convert_multi`` over ``[B, 2, 2^19]``, as
``transfer_song_pcm`` sends it) at segment buckets 32, 64 and 128, in
bfloat16 and float32, with the port's own weights. A bucket that does not
fit reports the peak reached before ``torch.OutOfMemoryError``.

    python3 -m mstbench.tools.memory_probe

Prints one JSON line per (dtype, bucket) and the card's name.
"""
from __future__ import annotations

import json
import sys

import torch


def main() -> int:
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine

    dev = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "total_bytes": torch.cuda.get_device_properties(dev).total_memory}))
    for dtype in ("bfloat16", "float32"):
        eng = StyleTransferEngine(dtype=dtype, device=dev)
        for B in (32, 64, 128):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            x = 0.1 * torch.randn(B, 2, 2**19, device=dev)
            cond = torch.randn(B, eng.converter_cfg.condition_dimension, device=dev)
            fits = True
            try:
                out = eng._convert_multi(x, cond)
                torch.cuda.synchronize()
                del out
            except torch.OutOfMemoryError:
                fits = False
            peak = torch.cuda.max_memory_allocated()
            del x, cond
            print(json.dumps({"dtype": dtype, "bucket": B, "fits": fits, "peak_bytes": peak,
                              "weights_bytes": base, "activation_bytes": B * 128 * 2**19 *
                              (2 if dtype == "bfloat16" else 4)}), flush=True)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
