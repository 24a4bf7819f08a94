"""Variants of the compressor-envelope kernel (``csrc/envelope.cu``), built
and timed beside the shipped source on one card, to show what each design
choice buys and where a launch's time goes:

    python -m music_mixing_style_transfer_tpu_torch.ops.cuda.k2_variants

Each variant is the shipped source with a few lines replaced. Every
replacement must match the source exactly as often as it says, so a source
that has drifted fails here instead of measuring something else.

For each variant: ptxas registers and spills; the error against a float64
run of the plain version at [1024, 65536] (8 shared rows) and [8, 65536],
over max|float64|; per-launch ms at the main path's two shapes, the sweep's
[1024, 262144] slab reading 8 rows and the final [8, 655360], and at the
per-channel normalizer's sweep, [96, 655360] reading one row, each at the
chunk the variant's source takes for its lane count (the chunk variants
change that choice), and at training's fast-path launch, [128, 135168]
with a signal per lane. The variants are timed in the order given, then in
reverse. ``traced`` is the shipped kernel with a %globaltimer stamp per warp at the
phase boundaries; for it each shape also gets the median (10th, 50th, 90th
percentile) ns of phase A, of the wait for the carry, of phase B, of phase
C and the store, of the hand-off (carry published to carry seen), and the
chain's ns per window. Prints the card's name and power limit, then one JSON
line per variant and pass.
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

import numpy as np
import torch

from . import build
from . import envelope as k2

STAMP = (  # slot (window, lane): the ticket's order, window * groups * 8 + lane
    "#define STAMP(J) if (k == 0) { unsigned long long tt; "
    'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tt)); '
    "g_trace[(win * ((n_lanes + 7) / 8 * 8) + lane) * 5 + (J)] = tt; }\n"
)
TRACE_WORDS = 1 << 22  # stamps kept: 5 per warp, enough for [1024, 262144] at chunk 16

# name -> [(old, new, count)]
VARIANTS = {
    "shipped": [],
    # every warp stages its lane's row and takes its log10s, even where the
    # block's 8 lanes read one row
    "no_shared_row": [
        ("static constexpr bool SHARE = C <= 32;", "static constexpr bool SHARE = false;", 1),
    ],
    # phase B's max always on the order-preserving key, whatever the lane's sign
    "key_redux": [
        ("  const int cls = x_sign >= 0.0f && z_in >= 0.0f ? 1 : (x_sign <= 0.0f && z_in <= 0.0f ? -1 : 0);",
         "  const int cls = 0 * x_sign;", 1),
    ],
    # three blocks an SM at the shortest chunk (85 registers a thread, not 64)
    "three_blocks": [
        ("MIN_BLOCKS = C <= 16 ? 4 :", "MIN_BLOCKS = C <= 16 ? 3 :", 1),
    ],
    # chunk 32 at both shapes (the shipped source: 16 from 128 lanes on, 64 below)
    "chunk32": [
        ("constexpr int MANY_LANES_CHUNK = 16;", "constexpr int MANY_LANES_CHUNK = 32;", 1),
        ("constexpr int FEW_LANES_CHUNK = 64;", "constexpr int FEW_LANES_CHUNK = 32;", 1),
    ],
    # chunk 64 from 128 lanes on too: training's fast-path launch [128, 135168]
    "many_lanes_chunk64": [
        ("constexpr int MANY_LANES_CHUNK = 16;", "constexpr int MANY_LANES_CHUNK = 64;", 1),
    ],
    # chunk 16 for few lanes too: the final compression's chain at its longest
    "final_chunk16": [
        ("constexpr int FEW_LANES_CHUNK = 64;", "constexpr int FEW_LANES_CHUNK = 16;", 1),
    ],
    # the slopes rounded to float alone, no lo part
    "float_slopes": [
        ("s_lo[m] = static_cast<float>(v - static_cast<double>(s_hi[m]));", "s_lo[m] = 0.0f;", 1),
    ],
    # each thread loads and stores its own chunk (float4 at a stride of C
    # floats across the warp) instead of the coalesced pass through the tile
    "strided_io": [
        ("    if (vec_win) {\n      const float4* src = reinterpret_cast<const float4*>(xr + w0);\n"
         "#pragma unroll\n      for (int q = k; q < S::WINDOW / 4; q += 32) {\n"
         "        const float4 v = __ldg(src + q);\n"
         "        float* d = tile + (4 * q / C) * P + 4 * q % C;\n",
         "    if (vec_win) {\n      const float4* src = reinterpret_cast<const float4*>(xr + t0);\n"
         "#pragma unroll\n      for (int q = 0; q < C / 4; ++q) {\n"
         "        const float4 v = __ldg(src + q);\n"
         "        float* d = tile + k * P + 4 * q;\n", 1),
        ("    float4* dst = reinterpret_cast<float4*>(yr + w0);\n#pragma unroll\n"
         "    for (int q = k; q < S::WINDOW / 4; q += 32) {\n"
         "      const float* d = tile + (4 * q / C) * P + 4 * q % C;\n",
         "    float4* dst = reinterpret_cast<float4*>(yr + t0);\n#pragma unroll\n"
         "    for (int q = 0; q < C / 4; ++q) {\n"
         "      const float* d = tile + k * P + 4 * q;\n", 1),
    ],
    "traced": [
        ("namespace {\n", f"namespace {{\n__device__ unsigned long long g_trace[{TRACE_WORDS}];\n" + STAMP, 1),
        ("  const bool last_win = win == n_win - 1;\n",
         "  const bool last_win = win == n_win - 1;\n  STAMP(0)\n", 1),
        ("  __syncwarp();\n\n  // ---- (B)", "  __syncwarp();\n  STAMP(1)\n\n  // ---- (B)", 1),
        ("  float my_z = z;  // the carry into this thread's chunk\n",
         "  float my_z = z;  // the carry into this thread's chunk\n  STAMP(2)\n", 1),
        ("  if (k == n_eval) my_z = z;\n", "  if (k == n_eval) my_z = z;\n  STAMP(3)\n", 1),
        ("yr[w0 + e] = tile[(e / C) * P + e % C];\n  }\n}",
         "yr[w0 + e] = tile[(e / C) * P + e % C];\n  }\n  STAMP(4)\n}", 1),
        ('extern "C" long long compressor_envelope_scratch_words',
         'extern "C" int trace_copy(void* dst, long long n) {\n'
         "  return (int)cudaMemcpyFromSymbol(dst, g_trace, n * 8);\n}\n"
         'extern "C" long long compressor_envelope_scratch_words', 1),
    ],
}
SR = 44100


def variant_source(src: str, edits) -> str:
    """``src`` with each ``(old, new, count)`` applied; raises unless
    ``old`` occurs exactly ``count`` times."""
    for old, new, count in edits:
        if src.count(old) != count:
            raise ValueError(f"{old!r} occurs {src.count(old)} times in envelope.cu, not {count}")
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
    """The wrapper ``compressor_envelope`` launching the library at ``so``."""
    lib = ctypes.CDLL(so)
    saved = k2._library
    k2._library = lambda: k2._bind(lib)
    try:
        yield lib
    finally:
        k2._library = saved


def _lanes(L: int, T: int, seed: int, shared: bool, n_rows: int = 8):
    """Noise under slow envelopes on ``n_rows`` channels at -10 dB peak, each
    over L/n_rows lanes with the compressor settings of the normalizer's
    stems (ratio 4 to 20 and expanders, every fourth lane), one lane whose
    attack is slower than its release; x [n_rows, T] with ``rows`` when
    ``shared``, else [L, T]."""
    rng = np.random.default_rng(seed)
    env = np.abs(np.sin(np.linspace(0, 1, T)[None, :] * rng.uniform(3, 30, (n_rows, 1))))
    chans = rng.standard_normal((n_rows, T)) * (0.2 + env)
    chans *= 10 ** (-10 / 20) / np.abs(chans).max(-1, keepdims=True)
    rows = np.arange(L) * n_rows // L
    ratio = np.where(np.arange(L) % 4 == 3, 0.5, 4.0 + np.arange(L) % 17)
    th = -10.0 - 40.0 * rng.uniform(size=L)
    settings = np.asarray([(7.5, 400.0), (10.0, 180.0), (10.0, 500.0), (15.0, 666.0)])
    att, rel = settings[rows // 2 % 4].T.copy()
    att[-1], rel[-1] = 400.0, 20.0
    vals = [chans if shared else chans[rows], th, ratio, np.exp(-1.0 / (0.001 * SR * att)),
            np.exp(-1.0 / (0.001 * SR * rel)), np.zeros(L)]
    out = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda() for v in vals]
    return out, (torch.from_numpy(rows).cuda() if shared else None)


def _ms(fn, reps: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _phases(lib, args, rows) -> dict:
    """Per-phase ns of one traced launch (see the module docstring)."""
    x, *p = args
    k2.compressor_envelope(x, *p, rows=rows)
    torch.cuda.synchronize()
    L, T = p[0].shape[0], x.shape[1]
    chunk = k2.kernel_chunk(L)
    n_win, groups = -(-T // (32 * chunk)), -(-L // 8)
    n = n_win * groups * 8 * 5
    if n > TRACE_WORDS:
        return {}
    buf = np.zeros(n, np.uint64)
    lib.trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    if lib.trace_copy(buf.ctypes.data, n) != 0:
        raise RuntimeError("k2_variants: reading the trace failed")
    t = buf.reshape(n_win, groups, 8, 5).astype(np.int64)  # ticket = window * groups + group
    t -= t[..., 0].min()

    def q(a):
        return [float(np.percentile(a, v)) for v in (10, 50, 90)]

    return {
        "phase_a_ns": q(t[..., 1] - t[..., 0]), "wait_ns": q(t[..., 2] - t[..., 1]),
        "phase_b_ns": q(t[..., 3] - t[..., 2]), "phase_c_ns": q(t[..., 4] - t[..., 3]),
        "hand_off_ns": q(t[1:, ..., 2] - np.maximum(t[:-1, ..., 3], t[1:, ..., 1])),
        "chain_ns_per_window": float((t[-1, ..., 3] - t[0, ..., 3]).mean() / max(n_win - 1, 1)),
        "launch_ns": int(t[..., 4].max()),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with open(os.path.join(build.CSRC_DIR, "envelope.cu")) as f:
        src = f.read()
    sources = {name: variant_source(src, edits) for name, edits in VARIANTS.items()}
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
            built = dict(zip(sources, pool.map(lambda n: _build(n, sources[n], out_dir), sources)))
        acc = {}
        for name, (L, shared) in (("1024x65536_rows", (1024, True)), ("8x65536", (8, False))):
            args, rows = _lanes(L, 2**16, 1, shared)
            want = k2.envelope_reference(*(a.double() for a in args), rows=rows)[0]
            acc[name] = (args, rows, want)
        timed = {"sweep": _lanes(1024, 2**18, 2, True), "final": _lanes(8, 655360, 3, False),
                 "channel_sweep": _lanes(96, 655360, 4, True, n_rows=1),
                 "fastpath": _lanes(128, 2**17 + 4096, 5, False)}
        order = list(VARIANTS)
        for n_pass, names in enumerate((order, order[::-1])):
            for name in names:
                rec = {"variant": name, "pass": n_pass}
                if n_pass == 0:
                    rec.update({k: v for k, v in built[name].items() if k != "so"})
                if built[name]["so"] is None:
                    print(json.dumps(rec), flush=True)
                    continue
                with _using(built[name]["so"]) as lib:
                    rec["err_vs_float64"] = {
                        key: ((k2.compressor_envelope(*args, rows=rows)[0].double() - want)
                              .abs().max() / want.abs().max()).item()
                        for key, (args, rows, want) in acc.items()
                    }
                    rec["ms"] = {
                        f"{shape}_chunk{k2.kernel_chunk(args[1].shape[0])}": _ms(
                            lambda: k2.compressor_envelope(*args, rows=rows))
                        for shape, (args, rows) in timed.items()
                    }
                    if name == "traced" and n_pass == 0:
                        rec["phases"] = {
                            shape: _phases(lib, args, rows) for shape, (args, rows) in timed.items()
                        }
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
