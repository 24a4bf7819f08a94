#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds; any failure exits
non-zero:

1. device + build: the card's name and power limit (``nvidia-smi``), and
   the hand-written CUDA kernels built from ``csrc/``, one nvcc per source,
   all started together; it fails if ``-Xptxas -v`` reports a register
   spill in any of them.
2. K1 vs plain: the fused TCN-block kernel against its plain PyTorch version
   on the card, TF32 off, with kernel, plain and library (``F.conv1d``)
   times, at the main path's shapes (every dilation at the interpolation
   dispatch's [128, 17477, 128]) and at edge cases; and its float32 path
   (3xTF32) against a float64 run of the plain version at [2, 16384, 128].
   Each timed case also gives, under ``derived``, figures computed rather
   than measured: the bound on the CUDA cores' float32 rate and the L2 ->
   shared-memory bytes of the kernel's tiling over its time.
3. K2 vs plain: the compressor-envelope kernel against a float64 run of its
   plain version (and the float32 plain version's own error beside it) at
   [1024, 65536] and [8, 65536] with per-lane parameters from the
   normalizer's candidate grids, ragged L and T, slabs carried, lanes that
   read shared rows, and the main path's own launches: the sweep's three
   slabs [1024, 262144], [1024, 262144], [1024, 131072] reading 8 rows with
   the carry, and the final [8, 655360]; and the per-channel normalizer's
   launches: 96 candidates reading one channel [96, 655360] and the chosen
   one [1, 655360]; kernel times at those four shapes, the plain version's
   at [1024, 262144].
4. main path at full width: ``MixingStyleTransfer.transfer_song_pcm`` with
   the default FXencoder and MixFXcloner (random weights from a seed): with
   ``normalize_input=False`` in float32, bfloat16 and interpolation mode,
   then with FX normalization (the default ``NormalizationConfig`` and the
   port's feature file) in float32 and interpolation mode, under PyTorch's
   default TF32 flags as the CLI runs it (the engine turns TF32 off in its
   own forward passes); each run's kernel launches are counted, and each
   float32 run's converter dispatch is held against the same weights and
   inputs run block by block through K1's plain version.
5. normalizer, card vs CPU: ``normalize_device`` on the main path's
   2^19-sample song on the card (K2, cuFFT) and on the CPU (plain
   versions): the same compression choices, stems within 1e-4.
6. per-channel normalizer: ``AudioEffectsNormalizer.normalize_audio`` of the
   main path's 4 stems (2^19 samples, default config) on the card, timed,
   with its K2 launches, held against the card's batched normalizer within
   the JAX package's bound between its two paths (NRMSE 0.05); and one stem
   of 2^17 samples on the card against the CPU (same choices, 1e-4).
7. serve: the port's HTTP server on 127.0.0.1 (any free port) at full width
   in bfloat16 with FX normalization: ``/warmup`` at 2^19 samples,
   ``/health``, ``/embed``, a timed ``/transfer`` of a song directory; three
   queued ``/transfer``s served in FIFO order, one more refused with 429,
   ``/warmup`` while busy refused with 409; the written mixture
   byte-equal to the same engine's in-process ``run_directory``.
8. infer_prof: ``tools/infer_prof.py``'s phase split of the main
   configuration, normalized, in float32 and bfloat16 (one line each).
9. CLI: ``python -m music_mixing_style_transfer_tpu_torch.infer.style_transfer``
   on a synthetic song directory, without and with FX normalization.
10. the ``kernels`` line (launches of the main path, and per path under
   ``launches_by_path``: each path runs with the counts set to 0 just
   before it and read just after), then the last line
   ``{"ok": true, "device": {...}}``.

It needs the card and the package beside it: without either it exits
non-zero and prints no result. It imports nothing of JAX. Every case of
every phase is in the phase lines on stdout; redirect stdout to keep them.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SR = 44100
T_SEG = 2**19          # segment length of the main path
MAIN_B = 4             # converter batch of the main path: 4 stems x 1 segment
INTERP_B = 128         # interpolation dispatch: bucket(4 stems x 30 chunks)
INTERP_T = T_SEG // 30 + 1  # its chunk length, 17477 samples
DILATIONS = [2**n for n in range(3, 14)]  # the fused blocks 3-13
F32_PEAK = 67e12       # H100 SXM float32 (non-tensor-core), NVIDIA data sheet
TF32_PEAK = 495e12     # H100 SXM TF32 dense tensor core: K1's float32 runs 3 TF32 passes
BF16_PEAK = 989e12     # H100 SXM bf16 dense tensor core
HBM_RATE = 3.35e12     # H100 SXM HBM3 bytes/s
F32_TOL = 1e-4         # max|kernel - plain| / max|plain|, float32
F64_TOL = 1e-5         # K1 float32 (3xTF32) vs float64, over max|float64|
BF16_TOL = 2e-2        # same, bf16 kernel vs float32 plain on bf16-rounded inputs
CONVERTER_TOL = 1e-4   # converter dispatch, kernel path vs block-by-block plain, float32
# K2: max|kernel - float64| / max|float64|, for y and env_out, against a
# float64 run of the plain version on the same inputs. Both float32 versions
# are held to float64, not to each other: the serial float32 walk's rounding
# errors decay as slowly as the envelope (a_rel ~ 0.99994) and add up with T,
# and the kernel takes another order of roundings (chunk summaries).
ENVELOPE_TOL = 1e-5
NORMALIZER_TOL = 1e-4  # normalize_device, card vs CPU, over max|cpu|
SWEEP_SHAPE = (1024, 2**18)        # one slab of the normalizer's candidate sweep
FINAL_SHAPE = (8, T_SEG + 2**17)   # its final compression: 8 channels, fft-padded
CHANNEL_SWEEP_SHAPE = (96, T_SEG + 2**17)  # per-channel matching: 96 candidates of one channel
CHANNEL_FINAL_SHAPE = (1, T_SEG + 2**17)   # and the chosen candidate
PATH_NRMSE = 0.05      # per-channel vs batched normalizer, the JAX package's bound
FEATURES = os.path.join(
    ROOT, "music_mixing_style_transfer_tpu_torch", "weights",
    "musdb18_fxfeatures_eqcompimagegain.npy",
)


def emit(phase: str, t0: float, **fields) -> None:
    rec = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}
    print(json.dumps(rec), flush=True)


def cuda_time_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, after one warm-up
    call unless ``fn`` is warm already, from CUDA events."""
    import torch

    if warm_up:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def block_bound(B: int, T: int, d: int, dtype) -> dict:
    """Least time for one fused block: operations of the taps that land in
    [0, T) (2 per multiply-add) plus the epilogue, over the peak of the
    route the kernel takes (bf16 tensor cores; float32 as 3 TF32 passes);
    bytes of x and y once and w once, over the HBM rate. For float32,
    ``derived`` holds the bound on the CUDA cores' float32 rate beside it."""
    import torch

    C, K = 128, 15
    valid_rows = sum(max(0, T - abs(k - 7) * d) for k in range(K))
    ops = B * (2 * valid_rows * C * C + 7 * T * C)
    f32 = dtype == torch.float32
    esize = 4 if f32 else 2
    nbytes = 2 * B * T * C * esize + K * C * C * esize + (3 * C + 2 * B * C) * 4
    t_ops = (3 * ops / TF32_PEAK if f32 else ops / BF16_PEAK) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    out = {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    if f32:
        out["derived"] = {"bound_fp32_cuda_cores_ms": max(ops / F32_PEAK * 1e3, t_bytes)}
    return out


def l2_to_sm_bytes(B: int, T: int, d: int, dtype) -> int:
    """Bytes K1's TMA loads bring from L2 into shared memory in one launch:
    for each tile and each live tap, the x box and the w box(es) of every
    channel chunk (w_big and w_small in float32). Derived from the tiling
    that the built kernel reports (``tcn_block_tiling``), not measured."""
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tiling

    C, K = 128, 15
    bm, parts = tiling(dtype)
    esize = dtype.itemsize
    t0 = np.arange(0, T, bm, dtype=np.int64)[:, None]
    shift = (np.arange(K, dtype=np.int64)[None, :] - 7) * d
    live = int(((t0 + shift + bm > 0) & (t0 + shift < T)).sum())
    return B * live * (bm * C + parts * C * C) * esize


def block_case(B: int, T: int, d: int, dtype, gen, time_it: bool, reps: int = 3) -> dict:
    """Kernel vs plain version on random inputs with distinct FiLM rows."""
    import torch
    import torch.nn.functional as F

    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import (
        tcn_block,
        tcn_block_reference,
    )

    dev = "cuda"
    C = 128

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale + shift

    x = rnd(B, T, C, scale=0.3).to(dtype)
    w = rnd(15, C, C, scale=0.05).to(dtype)
    s, t = rnd(C, scale=0.2, shift=1.0), rnd(C, scale=0.1)
    r, b = rnd(B, C, scale=0.2, shift=1.0), rnd(B, C, scale=0.1)
    wr = rnd(C, scale=0.3)
    got = tcn_block(x, w, s, t, r, b, wr, d)
    want = tcn_block_reference(x.float(), w.float(), s, t, r, b, wr, d)
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    out = {
        "B": B, "T": T, "d": d, "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err, "max_abs_ref": scale, "rel_err": err / scale, "tol": tol,
        **block_bound(B, T, d, dtype),
    }
    del got, want
    if time_it:
        w_oik = w.permute(2, 1, 0).contiguous()
        x_ncl = x.transpose(1, 2).contiguous()
        out["kernel_ms"] = cuda_time_ms(lambda: tcn_block(x, w, s, t, r, b, wr, d), reps)
        out["plain_ms"] = cuda_time_ms(
            lambda: tcn_block_reference(x, w, s, t, r, b, wr, d), max(1, reps - 1)
        )
        out["library_ms"] = cuda_time_ms(
            lambda: F.conv1d(x_ncl, w_oik, padding=7 * d, dilation=d), max(1, reps - 1)
        )
        l2_gb = l2_to_sm_bytes(B, T, d, dtype) / 1e9
        out.setdefault("derived", {}).update(
            l2_to_sm_gb=l2_gb, l2_to_sm_tb_s=l2_gb / out["kernel_ms"]
        )
    if not err <= tol * scale:
        raise AssertionError(f"tcn_block disagrees with its plain version: {out}")
    return out


def float64_case(B: int, T: int, d: int, gen) -> dict:
    """K1's float32 path (3xTF32) and the float32 plain version (cuDNN, TF32
    off), each against the plain version run in float64 on the same inputs:
    max abs error over max|float64|."""
    import torch

    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import (
        block_epilogue,
        dilated_conv,
        tcn_block,
        tcn_block_reference,
    )

    C = 128

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + shift

    a = dict(
        x=rnd(B, T, C, scale=0.3), w=rnd(15, C, C, scale=0.05),
        s=rnd(C, scale=0.2, shift=1.0), t=rnd(C, scale=0.1),
        r=rnd(B, C, scale=0.2, shift=1.0), b=rnd(B, C, scale=0.1), wr=rnd(C, scale=0.3),
    )
    a64 = {k: v.double() for k, v in a.items()}
    want = block_epilogue(
        dilated_conv(a64["x"], a64["w"], d), a64["x"], *(a64[k] for k in "strb"), a64["wr"]
    )
    scale = want.abs().max().item()
    kernel_err = (tcn_block(**a, d=d).double() - want).abs().max().item()
    plain_err = (tcn_block_reference(**a, d=d).double() - want).abs().max().item()
    out = {
        "B": B, "T": T, "d": d, "max_abs_ref_float64": scale,
        "kernel_err": kernel_err, "kernel_rel_err": kernel_err / scale,
        "plain_float32_err": plain_err, "plain_float32_rel_err": plain_err / scale,
        "tol": F64_TOL,
    }
    if not kernel_err <= F64_TOL * scale:
        raise AssertionError(f"tcn_block float32 is not float32-accurate against float64: {out}")
    return out


def converter_plain(model, x, cond):
    """MixFXcloner forward composed block by block here, with every fused
    block through the kernel's plain version (never the kernel)."""
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block_reference

    h = x.transpose(1, 2).contiguous()
    for blk in model.blocks:
        if blk.uses_kernel():
            s, t = blk.bn.fold()
            r, b = blk.film.rb(cond)
            h = tcn_block_reference(
                h, blk.conv1.weight.permute(2, 1, 0), s, t, r, b, blk.res.weight[:, 0, 0],
                blk.dilation,
            )
        else:
            h = blk(h, cond)
    out = h @ model.output.weight[:, :, 0].T + model.output.bias
    return out.transpose(1, 2).clamp(-1.0, 1.0)


def synthetic_stems(rng, S: int, T: int) -> np.ndarray:
    """``[S, 2, T]`` int16 stems: noise under a slow random envelope."""
    env = np.abs(np.sin(np.linspace(0, rng.uniform(3, 30), T)))[None, None, :]
    x = rng.standard_normal((S, 2, T)) * 0.15 * (0.2 + env)
    return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)


def phase_device_and_build():
    """Builds every source; fails on a register spill in nvcc's ``-Xptxas
    -v`` output (a library already built from the same source and flags is
    loaded as it is, with no output to check)."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    names = ("tcn_block", "envelope")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        built = dict(zip(names, pool.map(build.build, names)))
    ptxas = {
        n: [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]
        for n, (_, out) in built.items()
    }
    emit(
        "device_and_build", t0, nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        libraries={n: os.path.basename(p) for n, (p, _) in built.items()}, ptxas=ptxas,
    )
    spilled = {
        n: lines for n, lines in ptxas.items()
        if any(int(b) for line in lines for b in re.findall(r"(\d+) bytes spill", line))
    }
    if spilled:
        raise AssertionError(f"ptxas reports register spills: {spilled}")
    return smi


def phase_kernel_vs_plain():
    """Returns the cases at the interpolation dispatch's shape and the
    float64 case."""
    t0 = time.perf_counter()
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases, interp = [], []
    f64 = float64_case(2, 16384, 64, gen)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 64, 512, 4096, 8192):
            cases.append(block_case(2, T_SEG, d, dtype, gen, time_it=True))
        # the interpolation dispatch: every dilation, T < 7d from d = 4096 on
        for d in DILATIONS:
            interp.append(block_case(INTERP_B, INTERP_T, d, dtype, gen, time_it=True, reps=2))
        cases.append(block_case(4, 2**16 + 3, 8, dtype, gen, time_it=False))  # B = 4
        cases.append(block_case(1, 1, 64, dtype, gen, time_it=False))  # one row
    emit("kernel_vs_plain", t0, cases=cases + interp, float64=f64)
    return interp, f64


def envelope_bound(L: int, T: int, R: int = None) -> dict:
    """Least time for one K2 launch: x read once (R rows when lanes share
    them, else L) and y written once (plus the five per-lane vectors and
    env_out) over the HBM rate, against ~12 float32 operations a sample of
    the serial recurrence (side chain, two FMAs and a max, gain) over the
    CUDA cores' peak; bytes bound it at every shape here."""
    t_bytes = ((L if R is None else R) * T + L * T + 6 * L) * 4 / HBM_RATE * 1e3
    t_ops = 12 * L * T / F32_PEAK * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def envelope_lanes(L: int, T: int, seed: int, shared: bool = False):
    """``x [L, T]`` and per-lane (threshold, ratio, a_att, a_rel, env0) on
    the card, laid out like the normalizer's sweep: 8 channels of synthetic
    music, each broadcast over its candidates, the candidates from the real
    grids (the downward grid of ratio 4, its expander grid), with an
    identity lane and a lane whose attack is slower than its release. With
    ``shared``, x is the 8 channels [8, T] and the last entry ``rows`` [L]
    maps each lane to its channel, as the sweep feeds the kernel; else x is
    [L, T] and ``rows`` is None."""
    import torch

    from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
    from music_mixing_style_transfer_tpu_torch.normalize.matching import _comp_grid

    rng = np.random.default_rng(seed)
    cfg = NormalizationConfig()
    chans = synthetic_stems(rng, 4, T).reshape(8, T).astype(np.float32) / 32768.0
    chans *= 10 ** (-10 / 20) / np.maximum(np.abs(chans).max(-1, keepdims=True), 1e-30)
    rows = np.arange(L) * 8 // L
    Rd, Td = _comp_grid(4.0, cfg.comp_min_th, cfg.comp_max_ratio, expander=False)
    Ru, Tu = _comp_grid(4.0, cfg.comp_min_th, cfg.comp_max_ratio, expander=True)
    pick = np.arange(L)
    ratio = np.where(pick % 4 == 3, 1.0 / Ru[pick % len(Ru)], Rd[pick % len(Rd)])
    th = np.where(pick % 4 == 3, Tu[pick % len(Tu)], Td[pick % len(Td)])
    settings = [cfg.comp_settings[s] for s in cfg.stems]
    att = np.asarray([settings[(c * 8 // L) // 2 % 4][0] for c in pick])
    rel = np.asarray([settings[(c * 8 // L) // 2 % 4][1] for c in pick])
    ratio[L // 2] = 1.0                       # identity lane
    att[-1], rel[-1] = 400.0, 20.0            # attack slower than release: the min branch
    a_att = np.exp(-1.0 / (0.001 * SR * att))
    a_rel = np.exp(-1.0 / (0.001 * SR * rel))
    env0 = np.zeros(L)
    dev = "cuda"
    x = chans if shared else chans[rows]
    out = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
           for v in (x, th, ratio, a_att, a_rel, env0)]
    return out + [torch.from_numpy(rows).to(dev) if shared else None]


def channel_lanes(L: int, T: int, seed: int, shared: bool = False):
    """One channel ``[1, T]`` of synthetic music peak-normalized to -10 dB,
    as ``comp_match`` feeds it, and L lanes that all read it (``rows`` all
    zeros, as ``_grid_compress`` passes them): the first L candidates of the
    downward grid of ratio 4 (one lane: the candidate at threshold -20 dB,
    since the first, at -10 dB, leaves a -10 dB peak untouched) with a
    ratio-4 stem's attack and release. Returns the same list as
    :func:`envelope_lanes`."""
    import torch

    from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
    from music_mixing_style_transfer_tpu_torch.normalize.matching import _comp_grid

    rng = np.random.default_rng(seed)
    cfg = NormalizationConfig()
    ch = synthetic_stems(rng, 1, T)[0, :1].astype(np.float32) / 32768.0
    ch *= 10 ** (-10 / 20) / max(float(np.abs(ch).max()), 1e-30)
    R, Th = _comp_grid(4.0, cfg.comp_min_th, cfg.comp_max_ratio, expander=False)
    if L == 1:
        R, Th = R[Th == -20.0], Th[Th == -20.0]
    att, rel = cfg.comp_settings["vocals"][:2]
    a = [np.full(L, np.exp(-1.0 / (0.001 * SR * v))) for v in (att, rel)]
    dev = "cuda"
    out = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
           for v in (ch, Th[:L], R[:L], a[0], a[1], np.zeros(L))]
    return out + [torch.zeros(L, dtype=torch.int64, device=dev)]


def phase_envelope_vs_plain():
    """K2 against a float64 run of its plain version, and its times at the
    main path's two shapes. Returns the summary for the kernels line."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import (
        compressor_envelope,
        envelope_reference,
        kernel_chunk,
    )

    cases = []

    def check(name, L, T, cuts=None, shared=False, make=envelope_lanes):
        x, *p, rows = make(L, T, SEED + L + T, shared)
        want, env_want = envelope_reference(x.double(), *(v.double() for v in p), rows=rows)
        t_plain = time.perf_counter()
        plain, env_plain = envelope_reference(x, *p, rows=rows)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t_plain
        if cuts is None:
            got, env = compressor_envelope(x, *p, rows=rows)
        else:
            parts, env = [], p[-1]
            for a, b in zip([0] + cuts, cuts + [T]):
                y, env = compressor_envelope(x[:, a:b].contiguous(), *p[:-1], env, rows=rows)
                parts.append(y)
            got = torch.cat(parts, -1)
        torch.cuda.synchronize()
        scale, env_scale = want.abs().max().item(), env_want.abs().max().item()

        def err(a, b):
            return (a.double() - b.double()).abs().max().item()

        case = {
            "case": name, "L": L, "T": T, "slabs": None if cuts is None else len(cuts) + 1,
            "rows": None if rows is None else int(x.shape[0]), "chunk": kernel_chunk(L),
            "max_abs_ref_float64": scale, "env_ref_float64": env_scale, "tol": ENVELOPE_TOL,
            "max_abs_err": err(got, want), "rel_err": err(got, want) / max(scale, 1e-30),
            "env_err": err(env, env_want),
            "plain_float32_err": err(plain, want),
            "plain_float32_rel_err": err(plain, want) / max(scale, 1e-30),
            "plain_float32_env_err": err(env_plain, env_want),
            "kernel_vs_plain_float32_err": err(got, plain),
            "plain_s": plain_s,
            "lanes_expander": int((p[1] < 1).sum()), "lanes_identity": int((p[1] == 1).sum()),
            "lanes_min_branch": int((p[2] > p[3]).sum()),
        }
        cases.append(case)
        # the third condition follows from the first (|got - plain| <= |got -
        # want| + |plain - want|); it is kept as the figure that compares the
        # two float32 walks
        if not (case["max_abs_err"] <= ENVELOPE_TOL * scale
                and case["env_err"] <= ENVELOPE_TOL * env_scale + 1e-6
                and case["kernel_vs_plain_float32_err"] <= case["plain_float32_err"] + ENVELOPE_TOL * scale):
            raise AssertionError(f"compressor_envelope is not within its float64 bar: {case}")
        del want, plain, got

    check("sweep_lanes", 1024, 2**16)
    check("final_lanes", 8, 2**16)
    check("ragged_L", 1000, 2**16)
    check("one_lane", 1, 2**16)
    check("one_sample", 1024, 1)
    check("ragged_T", 1024, 1000)
    check("carried_slabs", 1024, 2**16, cuts=[1000, 30001])  # three unequal, unaligned slabs
    check("shared_rows", 1024, 2**16 + 3, shared=True)
    # the main path's launches: the sweep's three slabs of 2^18 reading the 8
    # channels with the carry (as CompressorStream feeds them), and the final
    # compression
    L, T = SWEEP_SHAPE
    check("main_sweep_slabs", L, FINAL_SHAPE[1], cuts=[T, 2 * T], shared=True)
    check("main_final", *FINAL_SHAPE)
    # the per-channel normalizer's launches: 96 candidates of one channel
    # (chunk 64, below 128 lanes) and the chosen candidate alone
    check("channel_sweep", *CHANNEL_SWEEP_SHAPE, make=channel_lanes)
    check("channel_final", *CHANNEL_FINAL_SHAPE, make=channel_lanes)

    times = {}
    for name, (L, T), make in (
        ("sweep", SWEEP_SHAPE, envelope_lanes), ("final", FINAL_SHAPE, envelope_lanes),
        ("channel_sweep", CHANNEL_SWEEP_SHAPE, channel_lanes),
        ("channel_final", CHANNEL_FINAL_SHAPE, channel_lanes),
    ):
        x, *p, rows = make(L, T, SEED + 1, shared=name == "sweep")
        ms = cuda_time_ms(lambda: compressor_envelope(x, *p, rows=rows), 5)
        times[name] = {
            "shape": [L, T], "rows": None if rows is None else int(x.shape[0]),
            "chunk": kernel_chunk(L), "ms": ms, "ns_per_step": ms * 1e6 / T,
            **envelope_bound(L, T, None if rows is None else int(x.shape[0])),
        }
        if name == "sweep":  # the plain version at the same shape, warm from the checks
            plain_ms = cuda_time_ms(lambda: envelope_reference(x, *p, rows=rows), 1, warm_up=False)
        del x, p, rows
    emit("envelope_vs_plain", t0, cases=cases, times=times,
         plain_ms={"shape": list(SWEEP_SHAPE), "ms": plain_ms})
    return {
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err_float64": max(c["rel_err"] for c in cases),
        "plain_ms": plain_ms, "times": times,
    }


def phase_main_path():
    t0 = time.perf_counter()
    import torch
    import torch.nn.functional as F

    from music_mixing_style_transfer_tpu_torch.config import InferenceConfig
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
        MixingStyleTransfer,
        StyleTransferEngine,
    )
    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    rng = np.random.default_rng(SEED)
    S = 4
    song = synthetic_stems(rng, S, T_SEG)
    ref = synthetic_stems(rng, S, 3 * T_SEG)
    ref_b = synthetic_stems(rng, S, T_SEG)
    norm = AudioEffectsNormalizer(FEATURES)  # default NormalizationConfig, on the card
    runs, launches, env_launches, outputs, engines, checks = [], 0, 0, {}, {}, []
    for name, dtype, ref_b_in, normalizer in (
        ("float32", "float32", None, None),
        ("bfloat16", "bfloat16", None, None),
        ("interpolation_float32", "float32", ref_b, None),
        ("normalized_float32", "float32", None, norm),
        ("normalized_interpolation_float32", "float32", ref_b, norm),
    ):
        t_init = time.perf_counter()
        eng = engines.get(dtype) or StyleTransferEngine(dtype=dtype, seed=SEED)
        engines[dtype] = eng
        init_s = time.perf_counter() - t_init
        seen = []  # per converter dispatch: finite output, TF32 flag, (x, cond, out)

        def hook(m, args, out):
            io = tuple(a.clone() for a in (*args, out)) if dtype == "float32" else None
            seen.append((bool(torch.isfinite(out).all()), torch.backends.cudnn.allow_tf32, io))

        handle = eng.converter.register_forward_hook(hook)
        cfg = InferenceConfig(normalize_input=normalizer is not None)
        pipe = MixingStyleTransfer(eng, cfg, normalizer=normalizer)
        pipe.transfer_song_pcm(song[:, :, :8192], ref[:, :, :8192])  # warm-up, not counted
        seen.clear()
        torch.cuda.synchronize()
        tcn_block.launches = 0
        compressor_envelope.launches = 0
        t_run = time.perf_counter()
        mix, _ = pipe.transfer_song_pcm(song, ref, reference_pcm_b=ref_b_in)
        run_s = time.perf_counter() - t_run
        n, n_env = tcn_block.launches, compressor_envelope.launches
        handle.remove()
        launches += n
        env_launches += n_env
        finite = [f for f, _, _ in seen]
        ok = (
            mix.dtype == np.int16 and mix.shape == (2, T_SEG) and finite == [True]
            and np.abs(mix).max() > 0 and n == 11 and not any(tf32 for _, tf32, _ in seen)
            and (n_env >= 4 if normalizer is not None else n_env == 0)
        )
        run = {
            "run": name, "engine_init_s": init_s, "transfer_song_pcm_s": run_s,
            "audio_s": T_SEG / SR, "converter_dispatches": len(seen),
            "tcn_block_launches": n, "compressor_envelope_launches": n_env,
            "mix_shape": list(mix.shape),
            "mix_peak": int(np.abs(mix.astype(np.int32)).max()), "finite": finite,
            "process_cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "engine_cudnn_tf32": [tf32 for _, tf32, _ in seen],
        }
        if normalizer is not None:
            # normalize_device alone on the run's own input (warm by now)
            fft = normalizer.cfg.fft_size
            with torch.inference_mode():
                x = torch.from_numpy(song).cuda().float() * (1.0 / 32768.0)
                x = F.pad(x, (fft, fft))
                torch.cuda.synchronize()
                t_norm = time.perf_counter()
                normalizer.batched().normalize_device(x, list(cfg.instruments), [T_SEG] * S)
                torch.cuda.synchronize()
                run["normalize_device_s"] = time.perf_counter() - t_norm
                del x
            choice = normalizer.batched().last_compression
            run["compression"] = {k: np.asarray(v).tolist() for k, v in choice.items()}
        runs.append(run)
        if not ok:
            raise AssertionError(f"main path run failed its checks: {runs[-1]}")
        outputs[name] = mix
        # the dispatch's own inputs: kernel path vs block-by-block plain
        for _, _, io in seen:
            if io is None:
                continue
            x, cond, got = io
            with torch.inference_mode(), full_float32():
                want = converter_plain(eng.converter, x, cond)
                torch.cuda.synchronize()
            checks.append({
                "run": name, "shape": list(x.shape),
                "max_abs_err": (got - want).abs().max().item(),
                "max_abs_ref": want.abs().max().item(), "tol": CONVERTER_TOL,
            })
            del x, cond, got, want
        seen.clear()

    bf = outputs["bfloat16"].astype(np.float64)
    fp = outputs["float32"].astype(np.float64)
    nrmse = float(np.sqrt(np.mean((bf - fp) ** 2) / max(np.mean(fp**2), 1e-12)))
    emit("main_path", t0, runs=runs, launches=launches, envelope_launches=env_launches,
         converter_checks=checks, bf16_vs_f32_mix_nrmse=nrmse)
    bad = [c for c in checks if not c["max_abs_err"] <= CONVERTER_TOL * max(c["max_abs_ref"], 1e-6)]
    if len(checks) != 4 or bad:
        raise AssertionError(f"converter disagrees with the block-by-block plain run: {checks}")
    return launches, env_launches


def phase_normalizer_card_vs_cpu():
    """``normalize_device`` on one input on the card and on the CPU: the
    compression choices must be identical, the stems within NORMALIZER_TOL.
    The song is the main path's 2^19 samples (11.9 s), padded by the default
    fft_size on both sides, so the card runs every K2 launch of the main
    path on it; the CPU side walks the envelope in a Python loop."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.normalize.batch import (
        BatchedAudioEffectsNormalizer,
    )

    T = T_SEG
    card = AudioEffectsNormalizer(FEATURES)
    cpu = BatchedAudioEffectsNormalizer(card.features, card.cfg, device="cpu")
    fft = card.cfg.fft_size
    insts = list(card.cfg.stems)
    song = synthetic_stems(np.random.default_rng(SEED + 3), len(insts), T) / 32768.0
    x = torch.from_numpy(np.pad(song.astype(np.float32), ((0, 0), (0, 0), (fft, fft))))
    with torch.inference_mode():
        t_card = time.perf_counter()
        got = card.batched().normalize_device(x.cuda(), insts, [T] * len(insts)).cpu()
        card_s = time.perf_counter() - t_card
        t_cpu = time.perf_counter()
        want = cpu.normalize_device(x, insts, [T] * len(insts))
        cpu_s = time.perf_counter() - t_cpu
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    a, b = card.batched().last_compression, cpu.last_compression
    same = all(np.array_equal(a[k], b[k]) for k in ("ratio", "threshold", "active", "fallback"))
    emit(
        "normalizer_card_vs_cpu", t0, song_samples=T, shape=list(x.shape), card_s=card_s,
        cpu_s=cpu_s, cpu_threads=torch.get_num_threads(), max_abs_err=err, max_abs_ref=scale,
        tol=NORMALIZER_TOL, same_choices=same,
        card_choice={k: np.asarray(v).tolist() for k, v in a.items()},
        cpu_choice={k: np.asarray(v).tolist() for k, v in b.items()},
    )
    if not (same and err <= NORMALIZER_TOL * scale and torch.isfinite(got).all()):
        raise AssertionError("normalize_device on the card disagrees with the CPU")


@contextlib.contextmanager
def recorded_choices():
    """The (ratio, threshold) each per-channel compression matching
    compresses with, in call order (``matching._grid_one`` wrapped)."""
    from music_mixing_style_transfer_tpu_torch.normalize import matching

    picks, orig = [], matching._grid_one

    def record(x, r, t, *a):
        picks.append((float(r), float(t)))
        return orig(x, r, t, *a)

    matching._grid_one = record
    try:
        yield picks
    finally:
        matching._grid_one = orig


def phase_normalizer_per_channel():
    """``normalize_audio`` stem by stem on the card against the card's
    batched path, and one shorter stem against the CPU. Returns the K2
    launches of the per-channel run."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block

    card = AudioEffectsNormalizer(FEATURES)  # default NormalizationConfig
    insts = list(card.cfg.stems)
    song = synthetic_stems(np.random.default_rng(SEED + 5), len(insts), T_SEG) / 32768.0
    stems = {inst: song[s].astype(np.float32) for s, inst in enumerate(insts)}
    t_b = time.perf_counter()
    batched = card.normalize_stems(stems)
    batched_s = time.perf_counter() - t_b
    choice = card.batched().last_compression

    tcn_block.launches = compressor_envelope.launches = 0
    per_stem_s, nrmse = {}, {}
    with recorded_choices() as picks:
        for inst in insts:
            t_s = time.perf_counter()
            y = card.normalize_audio(stems[inst], inst)  # ends in the download
            per_stem_s[inst] = time.perf_counter() - t_s
            ref = batched[inst]
            nrmse[inst] = float(np.sqrt(np.mean((y - ref) ** 2)) / (np.sqrt(np.mean(ref**2)) + 1e-12))
            if not (y.shape == ref.shape and np.isfinite(y).all()):
                raise AssertionError(f"normalize_audio({inst}) gave {y.shape}, non-finite values")
    n_env, n_k1 = compressor_envelope.launches, tcn_block.launches
    active = [(float(r), float(t)) for r, t, a in
              zip(choice["ratio"], choice["threshold"], choice["active"]) if a]

    # one stem of 2^17 samples, card against CPU (the CPU walks the plain
    # envelope in a Python loop over time)
    cpu = AudioEffectsNormalizer(FEATURES, card.cfg, device="cpu")
    short = stems[insts[0]][:, : 2**17]
    out, short_picks, short_s = {}, {}, {}
    for name, norm in (("card", card), ("cpu", cpu)):
        with recorded_choices() as pk:
            t_s = time.perf_counter()
            out[name] = norm.normalize_audio(short, insts[0])
            short_s[name] = time.perf_counter() - t_s
        short_picks[name] = pk
    err = float(np.abs(out["card"] - out["cpu"]).max())
    scale = float(np.abs(out["cpu"]).max())
    emit(
        "normalizer_per_channel", t0, stems=insts, song_samples=T_SEG,
        per_channel_s=sum(per_stem_s.values()), per_stem_s=per_stem_s, batched_s=batched_s,
        compressor_envelope_launches=n_env, tcn_block_launches=n_k1,
        per_channel_choices=picks, batched_active_choices=active,
        same_choices_as_batched=picks == active, nrmse_vs_batched=nrmse, nrmse_tol=PATH_NRMSE,
        short={"stem": insts[0], "samples": int(short.shape[-1]), "card_s": short_s["card"],
               "cpu_s": short_s["cpu"], "choices": short_picks, "max_abs_err": err,
               "max_abs_ref": scale, "tol": NORMALIZER_TOL},
    )
    if not (n_env > 0 and n_k1 == 0 and all(v < PATH_NRMSE for v in nrmse.values())
            and short_picks["card"] == short_picks["cpu"] and err <= NORMALIZER_TOL * scale
            and np.isfinite(out["card"]).all()):
        raise AssertionError("the per-channel normalizer failed its checks")
    return {"compressor_envelope": n_env, "tcn_block": n_k1}


def _http(url: str, payload=None):
    """GET (no payload) or POST JSON; returns (status, headers, body dict),
    HTTP errors included."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def phase_serve():
    """The port's server at full width, bf16 and normalized, on 127.0.0.1.
    Returns the kernels' launches over its requests."""
    t0 = time.perf_counter()
    import threading

    from music_mixing_style_transfer_tpu_torch.config import InferenceConfig
    from music_mixing_style_transfer_tpu_torch.data.wavio import write_wav
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
        MixingStyleTransfer,
        StyleTransferEngine,
    )
    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.serve import StyleTransferService, serve

    eng = StyleTransferEngine(dtype="bfloat16", seed=SEED)  # serve's default dtype
    norm = AudioEffectsNormalizer(FEATURES)
    cfg = InferenceConfig(do_not_separate=True, normalize_input=True, dtype="bfloat16")
    service = StyleTransferService(eng, cfg, norm, max_queue=3)
    httpd = serve(service, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rec = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(SEED + 7)
            for name in ("input", "reference"):
                for inst, x in zip(cfg.instruments, synthetic_stems(rng, 4, T_SEG)):
                    write_wav(os.path.join(tmp, "songs", "s0", "separated", name, inst + ".wav"),
                              x.T, SR)
            target = os.path.join(tmp, "songs") + "/"
            tcn_block.launches = compressor_envelope.launches = 0
            code, _, rec["warmup"] = _http(url + "/warmup", {"seconds": T_SEG / SR})
            rec["warmup_status"] = code
            rec["health_status"], _, rec["health"] = _http(url + "/health")
            t_e = time.perf_counter()
            code, _, emb = _http(url + "/embed", {
                "wav": os.path.join(tmp, "songs", "s0", "separated", "reference", "drums.wav")})
            rec["embed"] = {"status": code, "s": time.perf_counter() - t_e,
                            "dim": len(emb.get("embedding", [])),
                            "finite": bool(np.isfinite(emb.get("embedding", [np.nan])).all())}
            t_t = time.perf_counter()
            code, _, first = _http(url + "/transfer", {"target_dir": target,
                                                       "output_dir": os.path.join(tmp, "out0") + "/"})
            rec["transfer"] = {"status": code, "s": time.perf_counter() - t_t,
                               "audio_s": T_SEG / SR, "written": len(first.get("written", []))}

            # FIFO: hold the card's slot, queue three transfers one by one,
            # then a fourth (429) and a warmup (409), then let them run
            service.admission.acquire()
            done, threads = [], []
            try:
                for i in range(3):
                    def run(i=i):
                        code, _, body = _http(url + "/transfer", {
                            "target_dir": target, "output_dir": os.path.join(tmp, f"out{i + 1}") + "/"})
                        done.append((i, code, len(body.get("written", []))))

                    threads.append(threading.Thread(target=run))
                    threads[-1].start()
                    for _ in range(2000):
                        if service.admission.snapshot()["queue_depth"] == i + 1:
                            break
                        time.sleep(0.005)
                rec["queued_depth"] = service.admission.snapshot()["queue_depth"]
                code, headers, _ = _http(url + "/transfer", {"target_dir": target})
                rec["overflow"] = {"status": code, "retry_after": headers.get("Retry-After")}
                rec["warmup_while_busy_status"] = _http(url + "/warmup", {"seconds": 0.5})[0]
            finally:
                service.admission.release()
            for th in threads:
                th.join(timeout=600)
            rec["fifo_order"] = [i for i, _, _ in done]
            rec["fifo_status"] = [c for _, c, _ in done]
            launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}

            # the same engine and normalizer in-process
            inproc = MixingStyleTransfer(eng, cfg, normalizer=norm).run_directory(
                target, os.path.join(tmp, "inproc") + "/")
            served = first.get("written", [None])[0]
            same = False
            if served and inproc:
                with open(served, "rb") as a, open(inproc[0], "rb") as b:
                    same = a.read() == b.read()
            rec["byte_equal_to_run_directory"] = same
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    emit("serve", t0, dtype="bfloat16", normalize_input=True, max_queue=3, **rec,
         tcn_block_launches=launches["tcn_block"],
         compressor_envelope_launches=launches["compressor_envelope"])
    ok = (
        rec["warmup_status"] == 200 and rec["health_status"] == 200
        and rec["health"].get("backend") == "cuda" and rec["embed"]["status"] == 200
        and rec["embed"]["dim"] == 2048 and rec["embed"]["finite"]
        and rec["transfer"]["status"] == 200 and rec["transfer"]["written"] == 1
        and rec["queued_depth"] == 3 and rec["overflow"] == {"status": 429, "retry_after": "30"}
        and rec["warmup_while_busy_status"] == 409 and rec["fifo_order"] == [0, 1, 2]
        and rec["fifo_status"] == [200] * 3 and rec["byte_equal_to_run_directory"]
        and all(n > 0 for n in launches.values())
    )
    if not ok:
        raise AssertionError("the server failed its checks")
    return launches


def phase_infer_prof():
    """``tools/infer_prof.py`` at the main configuration, normalized, in
    float32 and bfloat16. Returns the kernels' launches over both runs."""
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.tools import infer_prof

    keys = ("norm_loudness_s", "norm_eq_s", "norm_compression_s", "norm_imager_s", "upload_s",
            "normalize_s", "embed_s", "convert_s", "download_s", "total_s", "rtf")
    launches = {"tcn_block": 0, "compressor_envelope": 0}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        args = infer_prof.build_parser().parse_args(["--seconds", repr(T_SEG / SR), "--dtype", dtype])
        tcn_block.launches = compressor_envelope.launches = 0
        out = infer_prof.run(args)
        n = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
        emit("infer_prof", t0, audio_s=out.pop("seconds"), **out, tcn_block_launches=n["tcn_block"],
             compressor_envelope_launches=n["compressor_envelope"])
        if not (all(k in out and np.isfinite(out[k]) for k in keys) and all(v > 0 for v in n.values())):
            raise AssertionError(f"infer_prof ({dtype}) failed its checks: {out}")
        for k in launches:
            launches[k] += n[k]
    return launches


def phase_cli():
    t0 = time.perf_counter()
    from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav_stereo_ct, write_wav

    rng = np.random.default_rng(SEED + 1)
    insts = ("drums", "bass", "other", "vocals")
    with tempfile.TemporaryDirectory() as tmp:
        T = T_SEG - 1000
        for name in ("input", "reference"):
            stems = synthetic_stems(rng, len(insts), T)
            for inst, x in zip(insts, stems):
                write_wav(os.path.join(tmp, "song0", "separated", name, inst + ".wav"), x.T, SR)
        results = []
        # the CLI's defaults normalize (--normalize_input true, the port's
        # feature file); then the same song without normalization
        for extra, wav in (([], "mixture_output.wav"),
                           (["--normalize_input", "false"], "mixture_output_notnormed.wav")):
            cmd = [
                sys.executable, "-m", "music_mixing_style_transfer_tpu_torch.infer.style_transfer",
                "--target_dir", tmp + "/", "--do_not_separate", "true", *extra,
            ]
            t_cli = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            out = os.path.join(tmp, "song0", wav)
            y = read_wav_stereo_ct(out) if os.path.exists(out) else None
            ok = proc.returncode == 0 and y is not None and y.shape == (2, T) and np.isfinite(y).all()
            results.append({"args": extra, "wav": wav, "returncode": proc.returncode,
                            "wrote": y is not None, "shape": None if y is None else list(y.shape),
                            "seconds": time.perf_counter() - t_cli})
            if not ok:
                emit("cli", t0, runs=results)
                raise AssertionError(f"CLI failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
        emit("cli", t0, runs=results)


def summary(cases) -> dict:
    """Per-launch numbers of ``cases`` (one dtype, one shape, every
    dilation): the largest error, and times and bounds averaged."""
    return {
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err": max(c["rel_err"] for c in cases),
        **{k: float(np.mean([c[k] for c in cases]))
           for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": cases[0]["bound_by"],
        "per_dilation_ms": {str(c["d"]): c["kernel_ms"] for c in cases},
    }


def phase_kernels_line(launches: int, interp_cases, f64, env_launches: int, env, t_all: float,
                       by_path: dict):
    """Per-launch numbers at the main path's shape [4, 2^19, 128], averaged
    over its 11 dilations: float32 (the default dtype) in the entry,
    bfloat16 nested beside it, and both at the interpolation dispatch's
    shape from ``phase_kernel_vs_plain``. ``max_abs_err`` is the largest
    float32 error at either shape."""
    t0 = time.perf_counter()
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    main_cases = {
        dtype: [block_case(MAIN_B, T_SEG, d, dtype, gen, time_it=True, reps=2) for d in DILATIONS]
        for dtype in (torch.float32, torch.bfloat16)
    }
    main = {dtype: summary(cases) for dtype, cases in main_cases.items()}
    interp = {
        name: summary([c for c in interp_cases if c["dtype"] == name])
        for name in ("float32", "bfloat16")
    }
    f32 = main[torch.float32]
    entry = {
        "name": "tcn_block",
        "route": "cuda",
        "source": "music_mixing_style_transfer_tpu_torch/csrc/tcn_block.cu",
        "replaces": "music_mixing_style_transfer_tpu/ops/pallas/tcn_block.py:76",
        "launches": launches,
        "launches_by_path": {"main_path": launches,
                             **{p: n["tcn_block"] for p, n in by_path.items()}},
        "max_abs_err": max(f32["max_abs_err"], interp["float32"]["max_abs_err"]),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": [MAIN_B, T_SEG, 128],
        "dtype": "float32",
        "float32_method": "3xTF32 on wgmma (small*big + big*small + big*big, tf32 parts "
                          "rounded to nearest; per-stage sums added in float32)",
        "max_rel_err": max(f32["max_rel_err"], interp["float32"]["max_rel_err"]),
        "float64": f64,
        "per_dilation_ms": f32["per_dilation_ms"],
        "bfloat16": main[torch.bfloat16],
        "interpolation": {"shape": [INTERP_B, INTERP_T, 128], **interp},
    }
    times = env["times"]
    sweep, final = times["sweep"], times["final"]
    envelope = {
        "name": "compressor_envelope",
        "route": "cuda",
        "source": "music_mixing_style_transfer_tpu_torch/csrc/envelope.cu",
        "replaces": "music_mixing_style_transfer_tpu/ops/pallas/envelope.py:105",
        "launches": env_launches,
        "launches_by_path": {"main_path": env_launches,
                             **{p: n["compressor_envelope"] for p, n in by_path.items()}},
        "max_abs_err": env["max_abs_err"],
        "ms": sweep["ms"],
        "plain_ms": env["plain_ms"],
        "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes this recurrence",
        "shape": sweep["shape"],
        "rows": sweep["rows"],
        "chunk": sweep["chunk"],
        "dtype": "float32",
        "max_rel_err_float64": env["max_rel_err_float64"],
        "final": final,
        "per_channel": {"sweep": times["channel_sweep"], "final": times["channel_final"]},
    }
    emit("kernels_line", t0, cases=[c for cases in main_cases.values() for c in cases],
         total_s=round(time.perf_counter() - t_all, 3))
    return {"kernels": [entry, envelope]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # fails without the package; TF32 off in cuDNN and matmuls for the comparisons
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    t_all = time.perf_counter()
    smi = phase_device_and_build()
    with full_float32():
        interp_cases, f64 = phase_kernel_vs_plain()
    env = phase_envelope_vs_plain()
    launches, env_launches = phase_main_path()  # PyTorch's default flags, as the CLI runs
    phase_normalizer_card_vs_cpu()
    by_path = {
        "normalizer_per_channel": phase_normalizer_per_channel(),
        "serve": phase_serve(),
        "infer_prof": phase_infer_prof(),
    }
    phase_cli()
    with full_float32():
        kernels = phase_kernels_line(launches, interp_cases, f64, env_launches, env, t_all, by_path)
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
