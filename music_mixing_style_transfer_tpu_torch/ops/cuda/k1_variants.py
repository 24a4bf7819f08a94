"""Variants of the fused TCN-block kernel (``csrc/tcn_block.cu``), built and
timed beside the shipped source on one card, to show what each design
choice buys:

    python -m music_mixing_style_transfer_tpu_torch.ops.cuda.k1_variants

Each variant is the shipped source with a few lines replaced. Every
replacement must match the source exactly as often as it says, so a source
that has drifted fails here instead of measuring something else.

For each variant: ptxas registers and spills; the float32 error against a
float64 plain run at [2, 16384, 128], d = 64, and the bfloat16 error
against the float32 plain version there (over max|reference|); per-launch
ms at [4, 2^19, 128] (d = 8, 1024, 8192) and [128, 17477, 128] (d = 8,
8192) in both types. The variants are timed in the order given, then in
reverse. Prints the card's name and power limit, then one JSON line per
variant and pass.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build
from . import tcn_block as k1

# name -> [(old, new, count)]
VARIANTS = {
    "shipped": [],
    # float32 tiles of 256 rows (128 a warpgroup), as bf16; 3 stages so the
    # ring fits shared memory
    "f32_bm256": [
        ("static constexpr int BM = 128;", "static constexpr int BM = 256;", 1),
        ("static constexpr int STAGES = 4;\n  static constexpr int CH = 32;",
         "static constexpr int STAGES = 3;\n  static constexpr int CH = 32;", 1),
    ],
    # setmaxnreg: 240 for the consumers, 24 for the producer
    "regs_240_24": [
        ("CONSUMER_REGS = 232;", "CONSUMER_REGS = 240;", 1),
        ("PRODUCER_REGS = 40;", "PRODUCER_REGS = 24;", 1),
    ],
    # float32 products summed in the tensor cores across every stage, with
    # no float32 sum per stage
    "f32_tc_sums": [
        ("wgmma_tf32(part, ", "wgmma_tf32(acc[h], ", 3),
        ("for (int q = 0; q < 64; ++q) acc[h][q] += part[q];", "", 1),
    ],
}
SHAPES = {"main": (4, 2**19, (8, 1024, 8192)), "interp": (128, 17477, (8, 8192))}
C, K = 128, 15


def variant_source(src: str, edits) -> str:
    """``src`` with each ``(old, new, count)`` applied; raises unless
    ``old`` occurs exactly ``count`` times."""
    for old, new, count in edits:
        if src.count(old) != count:
            raise ValueError(f"{old!r} occurs {src.count(old)} times in tcn_block.cu, not {count}")
        src = src.replace(old, new)
    return src


def _build(name: str, src: str, out_dir: str) -> dict:
    cu, so = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=build.NVCC_TIMEOUT_S,
    )
    lines = [s.strip() for s in proc.stdout.splitlines() if "registers" in s or "spill" in s]
    return {
        "so": so if proc.returncode == 0 else None, "ptxas": lines,
        "spill_bytes": sum(int(b) for s in lines for b in re.findall(r"(\d+) bytes spill", s)),
        "error": None if proc.returncode == 0 else proc.stdout[-2000:],
    }


@contextlib.contextmanager
def _using(so: str):
    """The wrapper ``tcn_block`` launching the library at ``so``."""
    lib = ctypes.CDLL(so)

    def kernel(dtype):
        fn = getattr(lib, k1._DTYPES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        return fn

    saved = k1._kernel
    k1._kernel = kernel
    try:
        yield
    finally:
        k1._kernel = saved


def _inputs(gen, B: int, T: int, dtype) -> dict:
    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + shift

    return dict(
        x=rnd(B, T, C, scale=0.3).to(dtype), w=rnd(K, C, C, scale=0.05).to(dtype),
        s=rnd(C, scale=0.2, shift=1.0), t=rnd(C, scale=0.1),
        r=rnd(B, C, scale=0.2, shift=1.0), b=rnd(B, C, scale=0.1), wr=rnd(C, scale=0.3),
    )


def _ms(fn, reps: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _measure(acc: dict, timed: dict) -> dict:
    a32, y64, a16, y16 = acc["f32"], acc["y64"], acc["bf16"], acc["y16"]
    out = {
        "f32_err_vs_f64": ((k1.tcn_block(**a32, d=64).double() - y64).abs().max()
                           / y64.abs().max()).item(),
        "bf16_err_vs_plain": ((k1.tcn_block(**a16, d=64).float() - y16).abs().max()
                              / y16.abs().max()).item(),
        "ms": {},
    }
    for (shape, dtype), a in timed.items():
        for d in SHAPES[shape][2]:
            key = f"{str(dtype).replace('torch.', '')}_{shape}_d{d}"
            out["ms"][key] = _ms(lambda: k1.tcn_block(**a, d=d))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with open(os.path.join(build.CSRC_DIR, "tcn_block.cu")) as f:
        src = f.read()
    sources = {name: variant_source(src, edits) for name, edits in VARIANTS.items()}
    torch.backends.cudnn.allow_tf32 = False  # the plain versions in full float32
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
            built = dict(zip(sources, pool.map(lambda n: _build(n, sources[n], out_dir), sources)))
        gen = torch.Generator(device="cuda").manual_seed(0)
        a32 = _inputs(gen, 2, 16384, torch.float32)
        a64 = {k: v.double() for k, v in a32.items()}
        a16 = _inputs(gen, 2, 16384, torch.bfloat16)
        acc = {
            "f32": a32, "bf16": a16,
            "y64": k1.block_epilogue(k1.dilated_conv(a64["x"], a64["w"], 64), a64["x"],
                                     *(a64[k] for k in "strb"), a64["wr"]),
            "y16": k1.tcn_block_reference(**a16, d=64).float(),
        }
        timed = {
            (shape, dtype): _inputs(gen, B, T, dtype)
            for shape, (B, T, _) in SHAPES.items() for dtype in (torch.float32, torch.bfloat16)
        }
        order = list(VARIANTS)
        for n_pass, names in enumerate((order, order[::-1])):
            for name in names:
                rec = {"variant": name, "pass": n_pass}
                if n_pass == 0:
                    rec.update({k: v for k, v in built[name].items() if k != "so"})
                if built[name]["so"] is not None:
                    with _using(built[name]["so"]):
                        rec.update(_measure(acc, timed))
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
