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
10. train_fxencoder: contrastive FXencoder training. Checks first: K2 at
   the FX fast path's shape [128, 2^17 + 4096] (32 draws of the
   ``Compressor``'s ranges over 2 contents x 2 channels) against a float64
   run, timed; the 4 default instrument chains under one plan on the same
   int16 segments (2^14 + 4096 samples, where the Equaliser scans, and
   training's 2^17 + 4096, where it takes its FFT cascade), the card (K2)
   against the CPU and the fast path against the generic walk, within 1e-4;
   one step on a small encoder, card against CPU, TF32 off, within 1e-4
   (its conv biases ahead of a BN within 1e-3). Then the training CLI
   (``train.cli fxencoder --fused``) at full width on a synthetic corpus:
   the default FXencoder, segments of 2^17, 4 items a step, 2 epochs of 3
   steps in float32, a resume to epoch 3, one epoch in bfloat16; each
   epoch's synced step (augmentation and train step apart), losses, K2
   launches (the synced step's 2, validation's 2, and the epoch's),
   checkpoints and each run's peak memory.
11. train_converter: converter (MixFXcloner) training against the frozen
   encoder that phase 10 trained. Checks first: K2 at the triplet shape
   [64, 2^17 + 4096] (16 draws x 2 contents x 2 channels) against a
   float64 run, timed; ``augment_triplets`` of the 4 default chains, one
   draw per instrument and item, on the same int16 segments (4 items at
   2^14 + 4096 and at 2^17 + 4096), the card against the CPU and the fast
   path against the generic walk, within 1e-4; one converter step on a
   small TCN and encoder, card vs CPU, TF32 off: the loss and the
   backward from one cotangent within 1e-4, BN statistics within 1e-5, and
   the full step's gradients within 5e-4 of each tensor's max, card vs CPU
   and each device vs a float64 CPU run (the spectral loss's float32
   conditioning). Then ``train.cli converter --fused`` at
   full width with phase 10's float32 checkpoint as ``--encoder_ckpt``:
   the default MixFXcloner, segments of 2^17, 4 items a step (16
   triplets), 2 epochs of 3 steps in float32, a resume to epoch 3, one
   epoch in bfloat16 and one of 2 steps with ``--remat``; the same
   per-epoch figures and each run's peak memory.
12. data_tools: ``tools/synth_corpus.py`` writes 2 songs of 30 s in
   train and in val, ``tools/prepare_musdb.py`` normalizes them on the card
   (K2 launches and seconds a song), and ``train.cli fxencoder --fused``
   trains one epoch of 3 steps at full width on the prepared corpus,
   reading both splits through the native wav bank (``cpp/``, built by
   ``g++``; the phase fails without it). Then: ``sample_raw_batch`` of 4
   items through the bank and through ``wavio`` (median of 5 each, the
   segments byte-equal); ``Compressor(blockwise=True)`` at [16, 2, 2^17 +
   4096], one K2 launch over its [1056, 12288] blocks, against a float64
   run (1e-5 of max|float64|) and card vs CPU (1e-5), timed with its bound;
   ``compand`` and ``lufs_normalize_compand`` at [2, 2^19], the card's
   chunked scan against a float64 serial run (1e-5); each time-FX
   processor at [2, 2^19], card vs CPU (1e-4); and
   ``generate_contents_w_effects(2, 2)`` on the card (the file set, the
   mixtures within 2.5 LSB of their instruments' clipped sum, K2's
   launches).
13. parallel: the multi-card paths, one card standing for several (so no
   time here is a scaling figure). ``infer/seqpar.py`` on one stereo stem
   of 2^19 samples, default ``TCNConfig``, float32, TF32 off, over meshes of
   2 and 4 entries of ``cuda:0`` against one forward (1e-5 of max|single|;
   K1 11 launches a shard); ``transfer_song_pcm`` on a mesh of 2 entries of
   ``cuda:0``, data parallel (within 1 LSB of the single-device run) and
   sequence parallel (its seconds and K1 launches); ``train.cli fxencoder
   --fused`` at full width without BN (per-rank batch statistics differ by
   design) under ``torchrun --nproc_per_node 2`` on ``cuda:0`` over gloo,
   2 epochs of 1 step, against one process on the same seed, ``torchrun
   --nproc_per_node 1`` over NCCL, beside it (both steps' losses and the
   held-out loss after the first update within 1e-4; two one-process runs
   drift apart after a second Adam update, so its held-out loss is shown,
   not held; K2 2 launches a step on each rank, and the held-out loss's 2
   on rank 0; each rank's peak memory); ``train.cli converter
   --fused`` at full width under 2 ranks at lr 0 against one process that
   takes each rank's item as a step of its own (the epoch's loss and the
   held-out loss within 1e-4, whatever the per-rank batch statistics); and
   beside it two spawned ranks on ``cuda:0`` over gloo, 3 contrastive steps at full
   width without BN against one process's over the whole batch (cuDNN
   deterministic; the first step's averaged gradients within 1e-4 of each
   tensor's max, and with SGD each step's loss and the parameters after
   the last too; with Adam those are shown); and the FSDP contrastive
   step at full width, one rank over NCCL (FSDP2 over gloo with CUDA
   tensors killed its rank on the card), against the replicated step from
   the same weights (1e-4).
14. imager_rates: ``normalize_device`` at 48 kHz (the imager's Haas draw
   at that rate) on 4 stems of 2^19 samples, one mono: the card (K2)
   against the CPU's plain path (the same choices, 1e-4), and the mono stem
   leaves with a side channel.
15. checkpoints: full-width weights through three routes: a reference
   ``.pt`` (A); that ``.pt`` through ``models/torch_import.py`` into a flax
   archive ``.npz`` read by ``load_model_state`` (B); the archive through
   ``models/convert_ckpt.py`` into a ``.pt`` (C). The state dicts
   bit-equal; one normalized song through route B's engine equal to route
   A's at 0 LSB (K1 11 launches, K2 4); a ``ckpt/`` directory of
   ``step_<n>.pt`` loads its newest step.
16. sefa: ``models/sefa.py`` edits on blocks 5 and 12 through the
   full-width MixFXcloner on [4, 2, 2^19], float32 and bf16 (K1 11 launches
   each, per-block conditions), against the block-by-block plain path; an
   edit changes the output, a null edit does not.
17. frontend: ``FrontEnd`` stereo ``cplx`` + ``mag`` on [2, 2, 2^19], the
   ``BackEnd`` round trip and Griffin-Lim (32 iterations), card against CPU
   (cuFFT; no kernel).
18. parity_tools: ``tools/parity_check.py`` at full width, the port on the
   card (K1) against the functional ``F.conv1d`` forward of the same state
   dict: embedding cosine and waveform NRMSE.
19. card_checks: ``tools/card_checks.py``'s full-model check (kernel path
   vs plain path) and its bf16-vs-float32 fidelity at 2^19.
20. demo: the port's ``examples/demo_style_transfer.py`` with its
   defaults (15 s, bf16, normalized), its WAVs and launches.
21. the ``kernels`` line (launches of the main path, and per path under
   ``launches_by_path``: each path runs with the counts set to 0 just
   before it and read just after; K2's ``fastpath``, ``triplet`` and
   ``blockwise`` hold its cases at those paths' shapes),
   then the last line ``{"ok": true, "device": {...}}``.

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
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import converter_plain, tcn_block
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


FASTPATH_SHAPE = (128, 2**17 + 2 * 2048)  # training's K2 launch: 4 insts x 4 items x K 2 x 2 x 2 lanes
# the card-vs-CPU augmentation's (loaded length, items): below 32768 samples the Equaliser runs
# its scans, from 32768 on its FFT cascade, as training does at 2^17 + 4096
AUG_CASES = ((2**14 + 2 * 2048, 4), (2**17 + 2 * 2048, 2))
AUG_TOL = 1e-4                             # augmentation, card vs CPU (and fast vs generic), over max|cpu|
STEP_TOL = 1e-4                            # contrastive step, card vs CPU: loss and each gradient
BIAS_TOL = 1e-3                            # its conv biases ahead of a BN, over the largest gradient
SMALL_ENC = dict(channels=(8, 16), kernels=(25, 15), strides=(4, 4), dilation=(1, 1))
INSTS = ("drums", "bass", "other", "vocals")
TRIPLET_SHAPE = (64, 2**17 + 2 * 2048)    # the converter's K2 launch: 4 insts x 4 items x 2 contents x 2 ch
TRIPLET_CASES = ((2**14 + 2 * 2048, 4), (2**17 + 2 * 2048, 4))  # augment_triplets card vs CPU: (L_load, items)
SMALL_TCN = dict(condition_dimension=16, nblocks=2, channel_width=8, kernel_size=7)
# the converter step's gradients: dL/dpred of the spectral loss's log-magnitude term is
# ill-conditioned in float32 (near-empty bins), so the full step's float32 gradients, card
# against CPU and each device against a float64 CPU run, land ~1.1e-4...1.3e-4 of each
# tensor's max apart (H100 80GB HBM3, 700 W), above STEP_TOL; they are held at CONV_GRAD_TOL,
# and the converter's backward from one cotangent, card against CPU, at STEP_TOL
CONV_GRAD_TOL = 5e-4


def train_corpus(root: str, rng, files: int = 2, seconds: float = 20.0) -> None:
    """A synthetic MUSDB-layout corpus: ``train/`` and ``val/``, per
    instrument ``files`` int16 stereo WAVs of ``seconds`` each."""
    from music_mixing_style_transfer_tpu_torch.data.wavio import write_wav

    for mode in ("train", "val"):
        os.makedirs(os.path.join(root, mode), exist_ok=True)
        for inst in INSTS:
            for k in range(files):
                x = synthetic_stems(rng, 1, int(seconds * SR))[0]
                write_wav(os.path.join(root, mode, f"{inst}_normalized_eqcompimagegain_silence_trimmed{k}.wav"),
                          x.T, SR)


def fastpath_envelope_case(shape=None):
    """K2 at a training path's shape, by default the contrastive fast
    path's [128, 2^17 + 4096]: L/4 draws of the ``Compressor``'s ranges
    (threshold -80...-5 dB, attack 1...20 ms, release 50...500 ms, ratio
    4...40), each repeated over its 2 contents x 2 channels as
    ``fx/fastpath.py`` lays them out, on dequantized int16 music; against a
    float64 run of the plain version."""
    import torch

    from music_mixing_style_transfer_tpu_torch.fx.processors import Compressor
    from music_mixing_style_transfer_tpu_torch.ops.compressor import alphas
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import (
        compressor_envelope,
        envelope_reference,
        kernel_chunk,
    )

    L, T = shape or FASTPATH_SHAPE
    p = Compressor().sample(torch.Generator().manual_seed(SEED), L // 4)
    rep = lambda v: v.to(torch.float32).repeat_interleave(4).cuda()  # noqa: E731
    th, ratio = rep(p["threshold"]), rep(p["ratio"])
    a_att, a_rel = alphas(rep(p["attack_ms"]), rep(p["release_ms"]), SR)
    env0 = torch.zeros(L, device="cuda")
    x = torch.from_numpy(synthetic_stems(np.random.default_rng(SEED + 3), L // 2, T).reshape(L, T)).cuda()
    x = x.to(torch.float32) / 32768.0
    args = (x, th, ratio, a_att.to(torch.float32), a_rel.to(torch.float32), env0)
    want, env_want = envelope_reference(*(v.double() for v in args))
    got, env = compressor_envelope(*args)
    ms = cuda_time_ms(lambda: compressor_envelope(*args), 20)
    scale, env_scale = want.abs().max().item(), env_want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    env_err = (env.double() - env_want).abs().max().item()
    case = {
        "shape": [L, T], "chunk": kernel_chunk(L), "ms": ms, "ns_per_step": ms * 1e6 / T,
        **envelope_bound(L, T), "max_abs_err": err, "max_rel_err_float64": err / max(scale, 1e-30),
        "env_err": env_err, "env_rel_err": env_err / max(env_scale, 1e-30),
        "compressing_lanes": int(((got - x).abs().amax(-1) > 1e-3).sum()), "tol": ENVELOPE_TOL,
    }
    if not (err <= ENVELOPE_TOL * scale and env_err <= ENVELOPE_TOL * env_scale + 1e-6):
        raise AssertionError(f"K2 at a training path's shape is not within its float64 bar: {case}")
    return case


def augmentation_card_vs_cpu(T: int, B: int, seed: int, triplets: bool = False):
    """The 4 default instrument chains under one plan from a seeded
    generator, on the same int16 segments of ``T`` samples, ``B`` items, as
    a training path augments them: the contrastive views (K = 2 draws an
    item) or, with ``triplets``, ``augment_triplets`` (one draw an item).
    The fast path on the card (K2) against the fast path on the CPU (plain
    versions), and against the generic walk on the card."""
    import torch

    from music_mixing_style_transfer_tpu_torch.fx import make_instrument_manipulators
    from music_mixing_style_transfer_tpu_torch.fx.chain import plan_to
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.train.fused import (
        augment_contrastive_views,
        augment_triplets,
    )

    pad = 2048
    K = 1 if triplets else 2
    man = make_instrument_manipulators()
    gen = torch.Generator().manual_seed(seed)
    plans = {inst: man[inst].draw(gen, B * K) for inst in INSTS}
    segs = torch.from_numpy(synthetic_stems(np.random.default_rng(seed + 1), 4 * B * 2, T)
                            .reshape(4, B, 2, 2, T))

    def augment(s, p, fast=True):
        if triplets:
            return augment_triplets(man, INSTS, s, p, pad, T - 2 * pad, fast=fast)
        return augment_contrastive_views(man, INSTS, s, p, pad, fast=fast)

    t0 = time.perf_counter()
    cpu = augment(segs, plans)
    cpu_s = time.perf_counter() - t0
    card_plans = plan_to(plans, "cuda")
    out = {}
    for name, fast in (("fast", True), ("generic", False)):
        before = compressor_envelope.launches
        t0 = time.perf_counter()
        views = augment(segs.cuda(), card_plans, fast)
        torch.cuda.synchronize()
        out[name] = {"views": views, "s": time.perf_counter() - t0,
                     "launches": compressor_envelope.launches - before}
    scale = max(float(v.abs().max()) for v in cpu)
    err = lambda a, b: max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a, b))  # noqa: E731
    case = {
        "shape": list(cpu[0].shape), "lanes": 4 * B * K * 2 * 2, "cpu_s": cpu_s,
        "card_fast_s": out["fast"]["s"], "card_generic_s": out["generic"]["s"],
        "launches_fast": out["fast"]["launches"], "launches_generic": out["generic"]["launches"],
        "max_abs_cpu": scale, "card_vs_cpu_err": err(out["fast"]["views"], cpu),
        "fast_vs_generic_err": err(out["fast"]["views"], out["generic"]["views"]), "tol": AUG_TOL,
    }
    case["card_vs_cpu_rel_err"] = case["card_vs_cpu_err"] / scale
    case["fast_vs_generic_rel_err"] = case["fast_vs_generic_err"] / scale
    if not (case["card_vs_cpu_rel_err"] <= AUG_TOL and case["fast_vs_generic_rel_err"] <= AUG_TOL
            and case["launches_fast"] == 2 and case["launches_generic"] == 8):
        raise AssertionError(f"augmentation on the card failed its checks: {case}")
    return case


def contrastive_step_card_vs_cpu():
    """One ``make_contrastive_train_step`` on ``SMALL_ENC`` from the same
    weights on the card and on the CPU, TF32 off: the loss and every
    gradient within 1e-4, but the conv biases ahead of a training-mode BN,
    whose gradient is 0 in exact arithmetic and rounding noise on both:
    their largest, on either side, within 1e-3 of the largest gradient."""
    import torch

    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TrainConfig
    from music_mixing_style_transfer_tpu_torch.train.contrastive import (
        init_contrastive,
        make_contrastive_train_step,
    )

    rng = np.random.default_rng(SEED + 6)
    a = torch.from_numpy((rng.standard_normal((4, 4, 2, 16384)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((4, 4, 2, 12288)) * 0.2).astype(np.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        _, state, _ = init_contrastive(FXencoderConfig(**SMALL_ENC), TrainConfig(), seed=SEED, device=dev)
        state, loss = make_contrastive_train_step(0.1)(state, a.to(dev), b.to(dev))
        runs[dev] = (float(loss), {n: p.grad.cpu() for n, p in state.model.named_parameters()})
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    g_max = max(float(g.abs().max()) for g in gc.values())
    worst, zero_grads = 0.0, 0.0
    for n, g in gc.items():
        if n.endswith("conv1d.conv1d.bias"):  # rounding noise on both: bounded, not compared
            zero_grads = max(zero_grads, float(g.abs().max()), float(gg[n].abs().max()))
            continue
        worst = max(worst, float((gg[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30))
    case = {"loss_cpu": lc, "loss_card": lg, "loss_rel_err": abs(lg - lc) / abs(lc),
            "grad_max_rel_err": worst, "tol": STEP_TOL,
            "zero_in_exact_arithmetic_grad_over_max_grad": zero_grads / g_max, "bias_tol": BIAS_TOL}
    if not (case["loss_rel_err"] <= STEP_TOL and worst <= STEP_TOL and zero_grads <= BIAS_TOL * g_max):
        raise AssertionError(f"the contrastive step on the card disagrees with the CPU: {case}")
    return case


def phase_train_fxencoder(tmp: str):
    """Contrastive FXencoder training: K2 at the fast path's shape against
    float64; augmentation card vs CPU; one step card vs CPU; then the
    training CLI at full width (the default FXencoder, segments of 2^17, 4
    items a step, ``--fused``) on a synthetic corpus: 2 epochs of 3 steps in
    float32, a resume to epoch 3, and one epoch in bfloat16. Returns the
    kernels' launches over the CLI runs, the fast-path K2 case with the K2
    launches of one training step as the CLI's synced steps counted them,
    and the float32 run's last checkpoint (the converter's frozen encoder).
    The corpus and the runs stay under ``tmp``."""
    t0 = time.perf_counter()
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.train import cli
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    k2 = fastpath_envelope_case()
    aug = [augmentation_card_vs_cpu(T, B, SEED + 4 + 4 * k) for k, (T, B) in enumerate(AUG_CASES)]
    with full_float32():
        step = contrastive_step_card_vs_cpu()
    emit("train_fxencoder_checks", t0, fastpath_envelope=k2, augmentation=aug, contrastive_step=step)

    steps, items = 3, 4
    train_corpus(os.path.join(tmp, "corpus"), np.random.default_rng(SEED + 7))
    tcn_block.launches = compressor_envelope.launches = 0
    runs = [
        cli_run(cli, "fxencoder", tmp, name, out, "ckpt", steps, ["--batch_items", str(items), *extra])
        for name, out, extra in (
            ("float32", "f32", ["--epochs", "2"]),
            ("float32_resume", "f32", ["--epochs", "3"]),
            ("bfloat16", "bf16", ["--epochs", "1", "--dtype", "bfloat16"]),
        )
    ]
    launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    emit("train_fxencoder", t0, steps_per_epoch=steps, batch_items=items, runs=runs, launches=launches)
    f32, resume, bf16 = runs
    ok = (
        f32["epochs"] == [0, 1] and resume["epochs"] == [0, 1, 2] and bf16["epochs"] == [0]
        and all(np.isfinite(v) for r in runs for v in r["losses"] + r["val_losses"])
        # 2 launches a training step (the two rounds of the eq/comp shuffle) and 2 for validation
        and all(n == 2 for r in runs for n in r["launches_synced_step"] + r["launches_val"])
        and all(n == 2 * steps + 2 for r in runs for n in r["launches_per_epoch"])
        and f32["checkpoints"] == ["step_00000001.pt", "step_00000002.pt"]
        and resume["checkpoints"] == ["step_00000002.pt", "step_00000003.pt"]
        and launches["tcn_block"] == 0 and launches["compressor_envelope"] == 4 * (2 * steps + 2)
    )
    if not ok:
        raise AssertionError(f"the training CLI failed its checks: {runs}, {launches}")
    ckpt = os.path.join(tmp, "f32", "ckpt", "step_00000003.pt")
    return launches, {**k2, "launches_per_step": runs[0]["launches_synced_step"][0]}, ckpt


def cli_run(cli, model: str, tmp: str, name: str, out: str, ckpt_dir: str, steps: int, extra) -> dict:
    """One ``train.cli <model> --fused`` run in-process on the corpus under
    ``tmp``, its peak-memory counter reset just before it: its new
    ``metrics.jsonl`` records, its K2 launches, its checkpoints, the
    allocator's cache it started from and its allocation retries (a
    ``cudaMalloc`` that failed and was retried after the cache was freed)."""
    import gc

    import torch

    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope

    t_run = time.perf_counter()
    run_dir = os.path.join(tmp, out)
    path = os.path.join(run_dir, "metrics.jsonl")
    seen = 0
    if os.path.exists(path):
        with open(path) as f:
            seen = len(f.readlines())
    before = compressor_envelope.launches
    gc.collect()  # the cache is left as it is: train_converter empties it itself
    reserved = torch.cuda.memory_reserved() / 2**30
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    torch.cuda.reset_peak_memory_stats()
    cli.main([model, "--data_dir", os.path.join(tmp, "corpus"), "--out_dir", run_dir, "--fused",
              "--steps_per_epoch", str(steps), *extra])
    torch.cuda.synchronize()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    new = recs[seen:]
    return {
        "run": name, "seconds": time.perf_counter() - t_run,
        "epochs": [r["epoch"] for r in recs], "losses": [r["loss"] for r in new],
        "val_losses": [r.get("val_loss") for r in new], "wall": [r["wall"] for r in new],
        "launches_per_epoch": [r["launches"]["compressor_envelope"] for r in new],
        "launches_synced_step": [r["launches"]["compressor_envelope_synced_step"] for r in new],
        "launches_val": [r["launches"]["compressor_envelope_val"] for r in new],
        "readers": [r["reader"] for r in new],
        "launches": compressor_envelope.launches - before,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "reserved_gb_before": reserved,
        "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries,
        "checkpoints": sorted(os.listdir(os.path.join(run_dir, ckpt_dir))),
    }


def converter_step_card_vs_cpu():
    """One ``make_converter_train_step`` on ``SMALL_TCN`` against a frozen
    ``SMALL_ENC``, from the same weights and triplets, on the card and on
    the CPU (TF32 off), and on the CPU in float64: the loss card vs CPU
    within 1e-4; BN's running statistics within 1e-5; each float32
    gradient within ``CONV_GRAD_TOL`` of its tensor's max, card vs CPU and
    each device vs float64; and the converter's backward from one
    cotangent, card vs CPU, every gradient within 1e-4 of its tensor's max."""
    import torch

    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig, TrainConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.train.converter import (
        frozen,
        init_converter,
        make_converter_train_step,
    )

    rng = np.random.default_rng(SEED + 8)
    a1, a2, b2 = (torch.from_numpy((rng.standard_normal((8, 2, 16384)) * 0.2).astype(np.float32))
                  for _ in range(3))
    a2 = 0.5 * a1 + 0.5 * a2
    cot = torch.from_numpy(rng.standard_normal((8, 2, 16384)).astype(np.float32))
    runs, backward = {}, {}
    for name, dev, dtype in (("float64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                             ("card", "cuda", torch.float32)):
        enc = frozen(fast_init(FXencoder(FXencoderConfig(**SMALL_ENC)), seed=SEED).to(dev, dtype))
        args = [v.to(dev, dtype) for v in (a1, a2, b2)]
        if name != "float64":  # the converter's backward from one cotangent
            _, state, _ = init_converter(TCNConfig(**SMALL_TCN), TrainConfig(), seed=SEED, device=dev)
            with torch.no_grad():
                emb = enc(args[2])
            state.model(args[0], emb).backward(cot.to(dev))
            backward[name] = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
        _, state, _ = init_converter(TCNConfig(**SMALL_TCN), TrainConfig(), seed=SEED, device=dev)
        state.model.to(dtype)
        state, loss = make_converter_train_step()(state, enc, *args)
        runs[name] = (float(loss), {n: p.grad.cpu().double() for n, p in state.model.named_parameters()},
                      {k: v.cpu().double() for k, v in state.model.state_dict().items() if "running" in k})

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(float(b.double().abs().max()), 1e-30)

    (l64, g64, _), (lc, gc, sc), (lg, gg, sg) = runs["float64"], runs["cpu"], runs["card"]
    case = {
        "loss_cpu": lc, "loss_card": lg, "loss_float64": l64, "loss_rel_err": abs(lg - lc) / abs(lc),
        "grad_card_vs_float64": max(rel(gg[n], g64[n]) for n in g64),
        "grad_cpu_vs_float64": max(rel(gc[n], g64[n]) for n in g64),
        "grad_card_vs_cpu": max(rel(gg[n], gc[n]) for n in gc),
        "grad_card_vs_cpu_worst": max(gc, key=lambda n: rel(gg[n], gc[n])),
        "backward_card_vs_cpu": max(rel(backward["card"][n], backward["cpu"][n]) for n in gc),
        "stats_rel_err": max(rel(sg[k], sc[k]) for k in sc),
        "tol": STEP_TOL, "grad_tol": CONV_GRAD_TOL, "stats_tol": 1e-5,
    }
    grads = ("grad_card_vs_float64", "grad_cpu_vs_float64", "grad_card_vs_cpu")
    if not (case["loss_rel_err"] <= STEP_TOL and case["backward_card_vs_cpu"] <= STEP_TOL
            and all(case[k] <= CONV_GRAD_TOL for k in grads) and case["stats_rel_err"] <= 1e-5):
        raise AssertionError(f"the converter step on the card disagrees with the CPU: {case}")
    return case


def phase_train_converter(tmp: str, encoder_ckpt: str):
    """Converter training: K2 at the triplet shape [64, 2^17 + 4096] against
    float64, timed; ``augment_triplets`` card vs CPU and fast vs generic;
    one converter step card vs CPU; then ``train.cli converter --fused`` at
    full width (the default MixFXcloner against the full-width FXencoder
    that ``phase_train_fxencoder`` trained, ``encoder_ckpt``; segments of
    2^17, 4 items a step: 16 triplets) on the same corpus: 2 epochs of 3
    steps in float32, a resume to epoch 3, one epoch in bfloat16, one epoch
    of 2 steps with ``--remat``. Returns the kernels' launches over the CLI
    runs and the triplet K2 case with the launches of one step and of one
    validation."""
    t0 = time.perf_counter()
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.train import cli
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    k2 = fastpath_envelope_case(TRIPLET_SHAPE)
    aug = [augmentation_card_vs_cpu(T, B, SEED + 20 + k, triplets=True)
           for k, (T, B) in enumerate(TRIPLET_CASES)]
    with full_float32():
        step = converter_step_card_vs_cpu()
    emit("train_converter_checks", t0, triplet_envelope=k2, augmentation=aug, converter_step=step)

    steps, items = 3, 4
    common = ["--encoder_ckpt", encoder_ckpt, "--segment_length", str(2**17), "--batch_items", str(items)]
    tcn_block.launches = compressor_envelope.launches = 0
    runs = [
        cli_run(cli, "converter", tmp, name, out, "ckpt_conv", n_steps, [*common, *extra])
        for name, out, n_steps, extra in (
            ("float32", "conv_f32", steps, ["--epochs", "2"]),
            ("float32_resume", "conv_f32", steps, ["--epochs", "3"]),
            ("bfloat16", "conv_bf16", steps, ["--epochs", "1", "--dtype", "bfloat16"]),
            ("float32_remat", "conv_remat", 2, ["--epochs", "1", "--remat"]),
        )
    ]
    launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    emit("train_converter", t0, steps_per_epoch=steps, batch_items=items, runs=runs, launches=launches)
    f32, resume, bf16, remat = runs
    per_epoch = [2 * steps + 2] * 4 + [2 * 2 + 2]  # 2 a step (the eq/comp shuffle's rounds), 2 a validation
    ok = (
        f32["epochs"] == [0, 1] and resume["epochs"] == [0, 1, 2] and bf16["epochs"] == [0]
        and remat["epochs"] == [0]
        and all(np.isfinite(v) for r in runs for v in r["losses"] + r["val_losses"])
        and all(n == 2 for r in runs for n in r["launches_synced_step"] + r["launches_val"])
        and [n for r in runs for n in r["launches_per_epoch"]] == per_epoch
        and f32["checkpoints"] == ["step_00000001.pt", "step_00000002.pt"]
        and resume["checkpoints"] == ["step_00000002.pt", "step_00000003.pt"]
        and bf16["checkpoints"] == remat["checkpoints"] == ["step_00000001.pt"]
        and launches["tcn_block"] == 0 and launches["compressor_envelope"] == sum(per_epoch)
    )
    if not ok:
        raise AssertionError(f"the converter training CLI failed its checks: {runs}, {launches}")
    return launches, {**k2, "launches_per_step": runs[0]["launches_synced_step"][0],
                      "launches_per_validation": runs[0]["launches_val"][0]}


DATA_SONGS, DATA_SECONDS = 2, 30.0           # synth_corpus: songs a split (train, val), seconds each
BLOCKWISE_SHAPE = (16, 2, 2**17 + 2 * 2048)  # Compressor(blockwise=True): 16 draws x 2 channels
COMPAND_SHAPE = (2, T_SEG)                   # compand / lufs_normalize_compand
TIMEFX_SHAPE = (2, T_SEG)                    # each time-FX processor
COMPAND_TOL = 1e-5                           # the card's chunked scan vs a float64 serial run, over max|float64|
TIMEFX_TOL = 1e-4                            # time FX card vs CPU, over max|cpu|


def blockwise_case():
    """``Compressor(blockwise=True)`` at ``BLOCKWISE_SHAPE`` (draws of the
    ``Compressor``'s ranges on dequantized int16 music): one K2 launch over
    the blocks as lanes, [16 x 2 x 33, 8192 + 4096], held against a float64
    run of its plain version on those lanes (1e-5 of max|float64|), and the
    processor against those lanes cropped (1e-5); the whole processor card
    against CPU (1e-5 of max|cpu|); K2's time and its
    bytes bound at the lanes' shape, and the processor's time. Returns the
    case and the path's launches (the one apply's)."""
    import torch

    from music_mixing_style_transfer_tpu_torch.fx.processors import Compressor
    from music_mixing_style_transfer_tpu_torch.ops import compressor as comp
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import (
        compressor_envelope,
        envelope_reference,
        kernel_chunk,
    )
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block

    B, C, T = BLOCKWISE_SHAPE
    fx = Compressor(blockwise=True)
    params = fx.sample(torch.Generator().manual_seed(SEED + 30), B)
    x = torch.from_numpy(synthetic_stems(np.random.default_rng(SEED + 31), B, T)).float() / 32768.0
    card_params = {k: v.cuda() for k, v in params.items()}
    xc = x.cuda()
    lanes, launch = {}, comp.compressor_envelope

    def capture(xl, *args):  # the lanes the blockwise path hands to the wrapper
        lanes["args"] = (xl, *args)
        return launch(xl, *args)

    comp.compressor_envelope = capture
    try:
        tcn_block.launches = compressor_envelope.launches = 0  # the path: one apply
        got = fx.apply(card_params, xc)
        torch.cuda.synchronize()
        path = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    finally:
        comp.compressor_envelope = launch
    launches = path["compressor_envelope"]
    xl, *p = lanes["args"]
    L, W = xl.shape
    want, env_want = envelope_reference(*(v.double() for v in (xl, *p)))
    kern, env = compressor_envelope(xl, *p)
    t0 = time.perf_counter()
    cpu = fx.apply(params, x)
    cpu_s = time.perf_counter() - t0
    scale = want.abs().max().item()
    err = (kern.double() - want).abs().max().item()
    env_err = (env.double() - env_want).abs().max().item()
    card_err = (got.cpu() - cpu).abs().max().item() / cpu.abs().max().item()
    # the processor's float64 yardstick: the float64 lanes cropped as the path crops them
    want_y = want[:, -4096:].reshape(B * C, -1)[:, :T].reshape(B, C, T)
    y_err = (got.double() - want_y).abs().max().item() / want_y.abs().max().item()
    ms = cuda_time_ms(lambda: compressor_envelope(xl, *p), 10)
    apply_ms = cuda_time_ms(lambda: fx.apply(card_params, xc), 5)
    case = {
        "shape": [B, C, T], "lanes": [L, W], "chunk": kernel_chunk(L), "launches_per_apply": launches,
        "ms": ms, **envelope_bound(L, W), "apply_ms": apply_ms, "cpu_apply_s": cpu_s,
        "max_abs_err": err, "max_rel_err_float64": err / scale, "env_err": env_err,
        "card_vs_cpu_rel_err": card_err, "processor_vs_float64_rel_err": y_err, "tol": ENVELOPE_TOL,
    }
    if not (launches == 1 and (L, W) == (B * C * -(-T // 4096), 8192 + 4096)
            and err <= ENVELOPE_TOL * scale and env_err <= ENVELOPE_TOL * env_want.abs().max().item() + 1e-6
            and card_err <= ENVELOPE_TOL and y_err <= ENVELOPE_TOL):
        raise AssertionError(f"the blockwise compressor failed its checks: {case}")
    return case, path


def compand_cases():
    """``compand`` and ``lufs_normalize_compand`` at ``COMPAND_SHAPE``: the
    card (its chunked scan) against a float64 serial run on the CPU within
    1e-5 of max|float64|, and the card's time."""
    import torch

    from music_mixing_style_transfer_tpu_torch.ops.compressor import compand
    from music_mixing_style_transfer_tpu_torch.ops.loudness import lufs_normalize_compand

    x = torch.from_numpy(synthetic_stems(np.random.default_rng(SEED + 32), 1, COMPAND_SHAPE[1])[0])
    x = x.float() / 32768.0
    xc = x.cuda()
    cases = []
    for name, fn in (("compand", compand),
                     ("lufs_normalize_compand", lambda y: lufs_normalize_compand(y, SR, -14.0))):
        t0 = time.perf_counter()
        want = fn(x.double())
        cpu_s = time.perf_counter() - t0
        got = fn(xc)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got.cpu().double() - want).abs().max().item()
        case = {"name": name, "shape": list(COMPAND_SHAPE), "ms": cuda_time_ms(lambda: fn(xc), 3),
                "cpu_float64_s": cpu_s, "max_abs_err": err, "max_rel_err_float64": err / scale,
                "changed": (got.cpu() - x).abs().max().item(), "tol": COMPAND_TOL}
        cases.append(case)
        if not (got.dtype == torch.float32 and err <= COMPAND_TOL * scale and case["changed"] > 1e-3):
            raise AssertionError(f"{name} on the card failed its checks: {case}")
    return cases


def timefx_cases():
    """Each time-FX processor at ``TIMEFX_SHAPE`` with one parameter set
    drawn from a seeded numpy generator (redrawn past the identity), card
    against CPU within 1e-4 of max|cpu|; ``Bend`` at its drawn segments;
    the card's time."""
    import torch

    from music_mixing_style_transfer_tpu_torch.fx import timefx

    C, T = TIMEFX_SHAPE
    x = torch.from_numpy(synthetic_stems(np.random.default_rng(SEED + 33), 1, T)[0]).float() / 32768.0
    xc = x.cuda()
    draw = np.random.default_rng(SEED + 34)
    cases = []
    for fx in (timefx.PitchShift(), timefx.TimeStretch(), timefx.PlaybackSpeed(), timefx.Bend()):
        while True:
            params = fx.sample_host(draw, T) if isinstance(fx, timefx.Bend) else fx.sample_host(draw)
            if params.get("steps", params.get("factor")) not in (0.0, 1.0):
                break
        t0 = time.perf_counter()
        cpu = fx.apply(params, x)
        cpu_s = time.perf_counter() - t0
        got = fx.apply(params, xc).cpu()
        err = (got - cpu).abs().max().item() / cpu.abs().max().item()
        case = {"name": fx.name, "shape": [C, T],
                "params": {k: np.asarray(v).tolist() for k, v in params.items()},
                "ms": cuda_time_ms(lambda: fx.apply(params, xc), 2), "cpu_s": cpu_s,
                "card_vs_cpu_rel_err": err, "tol": TIMEFX_TOL}
        cases.append(case)
        if not (got.shape == cpu.shape == (C, T) and err <= TIMEFX_TOL):
            raise AssertionError(f"{fx.name} on the card disagrees with the CPU: {case}")
    return cases


def host_read_case(corpus: str):
    """``sample_raw_batch`` of the default 4-item batch of 2^17-sample
    segments from the prepared train split, through the native wav bank and
    through ``wavio`` (median of 5 each, host clock); the segments
    byte-equal; the plan draw's share apart (``batch_plans``)."""
    from music_mixing_style_transfer_tpu_torch.data.datasets import ContrastivePairDataset

    out, segs = {}, {}
    for reader, use_native in (("native", True), ("wavio", False)):
        ds = ContrastivePairDataset(corpus, mode="train", use_native=use_native)
        assert ds.files.reader == reader, (reader, ds.files.reader)
        times = []
        for rep in range(5):
            t0 = time.perf_counter()
            segs[reader], _ = ds.sample_raw_batch(list(range(4)), epoch_seed=rep)
            times.append(time.perf_counter() - t0)
        plans = []
        for rep in range(5):
            t0 = time.perf_counter()
            ds.batch_plans(list(range(4)), epoch_seed=rep)
            plans.append(time.perf_counter() - t0)
        out[reader] = {"sample_raw_batch_s": float(np.median(times)), "all_s": times,
                       "batch_plans_s": float(np.median(plans))}
    same = segs["native"].dtype == segs["wavio"].dtype and segs["native"].tobytes() == segs["wavio"].tobytes()
    out.update(shape=list(segs["native"].shape), dtype=str(segs["native"].dtype), byte_equal=same)
    if not same:
        raise AssertionError(f"the native bank's segments differ from wavio's: {out}")
    return out


def generate_contents_case(corpus: str, out_dir: str):
    """``generate_contents_w_effects(2, 2)`` on the card from the prepared
    train split: the JAX package's file set, each mixture the clipped sum of
    its instruments' files within 2.5 LSB (five files, each rounded once by
    at most half an LSB), and K2's launches."""
    import torch

    from music_mixing_style_transfer_tpu_torch.data.datasets import ContrastivePairDataset
    from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope

    ds = ContrastivePairDataset(corpus, mode="train")
    before = compressor_envelope.launches
    t0 = time.perf_counter()
    ds.generate_contents_w_effects(2, 2, out_dir, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = compressor_envelope.launches - before
    tags = [f"A{c}{e}" for c in "AB" for e in (1, 2)]
    want = {f"{i}_ori_{c}.wav" for i in INSTS for c in (0, 1)}
    want |= {f"{i}_{t}.wav" for i in INSTS for t in tags} | {f"mixture_{t}.wav" for t in tags}
    files = set(os.listdir(out_dir))
    worst = 0.0
    for t in tags:
        mix, _ = read_wav(os.path.join(out_dir, f"mixture_{t}.wav"))
        parts = sum(read_wav(os.path.join(out_dir, f"{i}_{t}.wav"))[0].astype(np.float64) for i in INSTS)
        worst = max(worst, float(np.abs(mix - np.clip(parts, -1, 1)).max()) * 32768)
    case = {"files": len(files), "file_set_ok": files == want, "mixture_max_err_lsb": worst,
            "launches": launches, "seconds": seconds}
    if not (files == want and worst <= 2.5 and launches == 2 * len(INSTS)):
        raise AssertionError(f"generate_contents_w_effects failed its checks: {case}")
    return case


def phase_data_tools(tmp: str):
    """The data tools on the card: ``tools/synth_corpus.py`` (2 songs of
    30 s in train and in val), ``tools/prepare_musdb.py`` normalizing them
    on the card (K2 launches and seconds a song), ``train.cli fxencoder
    --fused`` for one epoch of 3 steps at full width on the prepared corpus
    through the native wav bank (both splits, or the phase fails); the host
    read, bank against ``wavio``; ``Compressor(blockwise=True)``;
    ``compand`` and ``lufs_normalize_compand``; the time FX;
    ``generate_contents_w_effects``. Returns K2's case at the blockwise
    shape and the launches of each path (the counts set to 0 just before
    it and read just after)."""
    t0 = time.perf_counter()
    import logging

    from music_mixing_style_transfer_tpu_torch import native
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.tools import prepare_musdb, synth_corpus
    from music_mixing_style_transfer_tpu_torch.train import cli

    if not native.available():
        raise AssertionError("the native library (cpp/ via g++) did not build on this machine")
    raw, corpus = os.path.join(tmp, "raw"), os.path.join(tmp, "corpus")
    t_synth = time.perf_counter()
    for split, seed in (("train", SEED + 50), ("val", SEED + 60)):
        synth_corpus.main(["--output_dir", raw, "--n_songs", str(DATA_SONGS), "--seconds",
                           str(DATA_SECONDS), "--split", split, "--seed", str(seed)])
    synth_s = time.perf_counter() - t_synth

    by_path = {}

    def counted(name, fn):
        tcn_block.launches = compressor_envelope.launches = 0
        out = fn()
        by_path[name] = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
        return out

    songs = []  # the song_stats of prepare_musdb's per-song log records
    handler = logging.Handler()
    handler.emit = lambda r: songs.append(r.song_stats) if hasattr(r, "song_stats") else None
    logger = logging.getLogger("prepare_musdb")
    logger.addHandler(handler)
    try:
        t_prep = time.perf_counter()
        rc = counted("prepare_musdb", lambda: prepare_musdb.main(
            ["--musdb_root", raw, "--output_dir", corpus, "--splits", "train", "val"]))
        prep_s = time.perf_counter() - t_prep
    finally:
        logger.removeHandler(handler)
    run = counted("train_fxencoder_prepared", lambda: cli_run(
        cli, "fxencoder", tmp, "prepared_corpus", "prepared_run", "ckpt", 3,
        ["--batch_items", "4", "--epochs", "1"]))
    emit("data_tools_corpus", t0, synth_corpus_s=synth_s, prepare_musdb_s=prep_s, songs=songs,
         train=run, launches=dict(by_path))
    prepared = sorted(os.listdir(os.path.join(corpus, "train")))
    ok = (rc == 0 and len(songs) == 2 * DATA_SONGS
          and all(s["launches"] > 0 for s in songs)
          and len(prepared) == len(INSTS) * DATA_SONGS
          and run["readers"] == [{"train": "native", "val": "native"}]
          and all(np.isfinite(v) for v in run["losses"] + run["val_losses"])
          and by_path["prepare_musdb"]["tcn_block"] == 0
          and by_path["train_fxencoder_prepared"]["compressor_envelope"] == 2 * 3 + 2)
    if not ok:
        raise AssertionError(f"synth_corpus -> prepare_musdb -> train.cli failed its checks: "
                             f"{rc}, {songs}, {prepared}, {run}, {by_path}")

    host = host_read_case(corpus)
    blockwise, by_path["blockwise"] = blockwise_case()
    compand = compand_cases()
    timefx = timefx_cases()
    contents = counted("generate_contents", lambda: generate_contents_case(
        corpus, os.path.join(tmp, "contents")))
    emit("data_tools", t0, host_read=host, blockwise=blockwise, compand=compand, timefx=timefx,
         generate_contents=contents, launches=by_path)
    return blockwise, by_path


PAR_MESHES = (2, 4)          # sequence-parallel conversion: shards, all on cuda:0
SEQPAR_TOL = 1e-5            # the time-sharded forward vs one forward, over max|single|
PAR_LOSS_TOL = 1e-4          # two ranks vs one process: each epoch's loss and held-out loss, relative
PAR_RANKS = 2                # training ranks sharing the one card, over gloo
PAR_STEPS = 3                # spawned ranks vs one process: steps compared
PAR_GRAD_TOL = 1e-4          # two ranks' averaged gradients (and SGD parameters) vs one process
FSDP_TOL = 1e-4              # FSDP step vs the replicated step: loss and every parameter
PAR_TIMEOUT = 600            # seconds a multi-process run may take before it is killed
# the encoder of the loss comparisons: the published widths without BN (JAX's norm="none"):
# per-rank batch statistics differ from the global batch's by design
PAR_ENCODER = '{"norm": "none"}'


class Started:
    """A multi-process run started in the background: ``torchrun`` (its
    own session, output to a log) or spawned ranks. ``wait`` joins it with
    what is left of ``PAR_TIMEOUT``, kills whatever still runs and fails."""

    def __init__(self, popen=None, procs=(), log_path=None):
        import signal

        self._signal = signal
        self.popen, self.procs, self.log_path = popen, list(procs), log_path
        self.deadline = time.perf_counter() + PAR_TIMEOUT
        self.t0 = time.perf_counter()

    def kill(self) -> None:
        """Stop whatever of the run still runs (the phase's clean-up on a failure)."""
        if self.popen is not None and self.popen.poll() is None:
            os.killpg(self.popen.pid, self._signal.SIGKILL)
            self.popen.wait()
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()

    def wait(self) -> float:
        """Seconds the run took; raises if it failed or ran over."""
        left = lambda: max(self.deadline - time.perf_counter(), 0.0)  # noqa: E731
        over = False
        if self.popen is not None:
            try:
                self.popen.wait(left())
            except subprocess.TimeoutExpired:
                over = True
            if self.popen.poll() is None or over:
                os.killpg(self.popen.pid, self._signal.SIGKILL)
                self.popen.wait()
        for p in self.procs:
            p.join(left())
            if p.is_alive():
                over = True
                p.kill()
                p.join()
        if over:
            raise AssertionError(f"a run went over {PAR_TIMEOUT} s and was killed ({self.log_path})")
        if self.popen is not None and self.popen.returncode != 0:
            with open(self.log_path) as f:
                raise AssertionError(f"exit code {self.popen.returncode}:\n{f.read()[-4000:]}")
        return time.perf_counter() - self.t0


def start_torchrun(nproc: int, model: str, tmp: str, out: str, extra) -> Started:
    """``torchrun --standalone --nproc_per_node nproc -m ...train.cli model``
    on the corpus under ``tmp``, in the background; see ``torchrun_result``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), "-m", "music_mixing_style_transfer_tpu_torch.train.cli", model,
           "--data_dir", os.path.join(tmp, "corpus"), "--out_dir", os.path.join(tmp, out),
           "--fused", *extra]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_path = os.path.join(tmp, out + ".log")
    with open(log_path, "w") as log:
        popen = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                 start_new_session=True, env=env)
    return Started(popen=popen, log_path=log_path)


def torchrun_result(run: Started, model: str, tmp: str, out: str) -> dict:
    """A finished ``start_torchrun``: rank 0's ``metrics.jsonl`` records,
    the checkpoints and the seconds. Fails on a non-zero exit."""
    seconds = run.wait()
    with open(os.path.join(tmp, out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ckpt = "ckpt_conv" if model == "converter" else "ckpt"
    return {"run": out, "seconds": seconds,
            "losses": [r["loss"] for r in recs], "val_losses": [r.get("val_loss") for r in recs],
            "world_size": [r.get("world_size") for r in recs], "ranks": [r.get("ranks") for r in recs],
            "wall": [r["wall"] for r in recs],
            "launches_per_epoch": [r["launches"]["compressor_envelope"] for r in recs],
            "checkpoints": sorted(os.listdir(os.path.join(tmp, out, ckpt)))}


def rank_case(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a spawned group of ``world`` ranks on ``cuda:0`` over
    gloo, at full width, cuDNN deterministic; writes its result to ``out``.

    Two ranks against one process (the FXencoder without BN): the
    data-parallel contrastive step on this rank's items for ``PAR_STEPS``
    steps against this rank's own one-process steps over the whole batch,
    from the same weights: the first step's averaged gradients, each step's
    loss and the parameters after the last, with SGD (held) and with Adam
    (shown: its first updates are ~lr*sign(g), which flips with rounding
    wherever g ~ 0). Then, on rank 0 alone in a one-rank NCCL subgroup
    (FSDP2 over gloo with CUDA tensors killed its rank with SIGSEGV on the
    card), the FSDP step (with BN, SGD) against the replicated step from
    the same weights, and each rank's share of the parameters and of Adam's
    moments after an Adam FSDP step."""
    import datetime

    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    res = {}
    try:
        torch.cuda.set_device(0)
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
        from music_mixing_style_transfer_tpu_torch.models import FXencoder
        from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
        from music_mixing_style_transfer_tpu_torch.train.contrastive import (
            make_contrastive_train_step,
            make_fsdp_contrastive_step,
            shard_train_state,
        )
        from music_mixing_style_transfer_tpu_torch.train.state import TrainState, make_optimizer

        rng = np.random.default_rng(SEED + 40)
        data = [[torch.from_numpy((rng.standard_normal((1, 8, 2, 2**15)) * 0.2).astype(np.float32)).cuda()
                 for _ in range(2)] for _ in range(PAR_STEPS)]
        k = 8 // world

        def fresh(norm):
            return fast_init(FXencoder(FXencoderConfig(norm=norm)), seed=SEED + 40).cuda().train()

        def optimizer(name, model):
            if name == "sgd":
                return torch.optim.SGD(model.parameters(), lr=1e-3)
            return make_optimizer(model.parameters())

        def steps(group, opt_name):
            model = fresh("none")
            state = TrainState(0, model, optimizer(opt_name, model))
            step = make_contrastive_train_step(0.1, "float32", group)
            losses, grads = [], None
            for a, b in data:
                if group is not None:
                    a, b = a[:, rank * k:(rank + 1) * k], b[:, rank * k:(rank + 1) * k]
                state, loss = step(state, a, b)
                losses.append(float(loss))
                grads = grads or {n: p.grad.clone() for n, p in model.named_parameters()}
            return losses, grads, {n: p.detach().clone() for n, p in model.named_parameters()}

        def rel(x, y):
            return max(float((x[n] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                       for n, v in y.items())

        for opt_name in ("sgd", "adam"):
            l2, g2, p2 = steps(dist.group.WORLD, opt_name)
            l1, g1, p1 = steps(None, opt_name)
            res[opt_name] = {"losses": l2, "one_process_losses": l1, "grad_rel_err": rel(g2, g1),
                             "params_rel_err": rel(p2, p1)}
        sub = dist.new_group([0], backend="nccl")  # every rank takes part in making it
        if rank == 0:
            after = {}
            for name in ("replicated", "fsdp"):
                model = fresh("batch")
                state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=1.0))
                if name == "fsdp":
                    state = shard_train_state(state, sub)
                    step = make_fsdp_contrastive_step(sub)
                else:
                    step = make_contrastive_train_step(0.1, "float32", sub)
                state, loss = step(state, *data[0])
                res[name] = {"loss": float(loss)}
                after[name] = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
                               for n, p in model.named_parameters()}
                after[name].update({n: b.clone() for n, b in model.named_buffers() if "running" in n})
            res["fsdp_rel_err"] = rel(after["fsdp"], after["replicated"])
            model = fresh("batch")
            state = shard_train_state(TrainState(0, model, make_optimizer(model.parameters())), sub)
            make_fsdp_contrastive_step(sub)(state, *data[0])
            res.update(
                params=sum(p.numel() for p in model.parameters()),
                local_params=sum(p.to_local().numel() for p in model.parameters()),
                local_moments=sum(state.optimizer.state[p]["exp_avg"].to_local().numel()
                                  for p in model.parameters()))
        dist.barrier()
        torch.cuda.synchronize()
        res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    except BaseException:
        import traceback

        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def start_ranks(tmp: str, world: int) -> Started:
    """``rank_case`` in ``world`` spawned processes, in the background."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, "ranks_store")
    procs = [ctx.Process(target=rank_case, args=(r, world, store, os.path.join(tmp, f"ranks_{r}.json")),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return Started(procs=procs, log_path=store)


def ranks_result(run: Started, tmp: str) -> dict:
    """The finished ``start_ranks``: each rank's result, and the seconds."""
    seconds = run.wait()
    ranks = []
    for r, p in enumerate(run.procs):
        out = os.path.join(tmp, f"ranks_{r}.json")
        if not os.path.exists(out):
            raise AssertionError(f"rank {r} left no result (exit code {p.exitcode})")
        with open(out) as f:
            ranks.append(json.load(f))
        if "error" in ranks[-1]:
            raise AssertionError(f"rank {r} failed:\n{ranks[-1]['error']}")
    return {"ranks": ranks, "seconds": seconds}


def phase_parallel(tmp: str):
    """Multi-card paths on the one card, each shard or rank standing for a
    card (so no time here is a scaling figure): sequence-parallel
    conversion, data- and sequence-parallel ``transfer_song_pcm``, both
    training CLIs under two ranks over gloo against one process, the CLI
    under ``torchrun --nproc_per_node 1`` over NCCL, and the FSDP step.
    Returns the kernels' launches on these paths (for ``launches_by_path``)."""
    t0 = time.perf_counter()
    import gc

    import torch

    from music_mixing_style_transfer_tpu_torch.config import InferenceConfig, TCNConfig
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
        MixingStyleTransfer,
        StyleTransferEngine,
    )
    from music_mixing_style_transfer_tpu_torch.infer.seqpar import make_seq_parallel_converter
    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.parallel import create_mesh
    from music_mixing_style_transfer_tpu_torch.train import cli
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    def shards(n):
        return create_mesh(n, ["cuda:0"] * n)

    paths = {}
    # 1. the time-sharded forward of one stereo stem, default TCNConfig, float32, TF32 off
    rng = np.random.default_rng(SEED + 30)
    model = fast_init(MixFXcloner(TCNConfig()), seed=SEED + 30).cuda().eval()
    x = torch.from_numpy((rng.standard_normal((1, 2, T_SEG)) * 0.3).astype(np.float32)).cuda()
    cond = torch.from_numpy(rng.standard_normal((1, 2048)).astype(np.float32)).cuda()
    with full_float32(), torch.inference_mode():
        single = model(x, cond)
    seqpar = []
    tcn_block.launches = compressor_envelope.launches = 0
    for n in PAR_MESHES:
        fn = make_seq_parallel_converter(model, shards(n))
        torch.cuda.synchronize()
        before = tcn_block.launches
        t_run = time.perf_counter()
        out = fn(x.transpose(1, 2), cond).transpose(1, 2)
        torch.cuda.synchronize()
        err = float((out - single).abs().max() / single.abs().max())
        seqpar.append({"shards": n, "seconds": time.perf_counter() - t_run, "rel_err": err,
                       "tcn_block_launches": tcn_block.launches - before, "tol": SEQPAR_TOL})
        print(json.dumps({"phase": "parallel_seqpar", **seqpar[-1]}), flush=True)
        del fn
    paths["parallel_seqpar"] = {"tcn_block": tcn_block.launches, "compressor_envelope": 0}
    if not all(c["rel_err"] <= SEQPAR_TOL and c["tcn_block_launches"] == 11 * c["shards"]
               for c in seqpar):
        raise AssertionError(f"sequence-parallel conversion failed: {seqpar}")
    del model, single

    # 2. transfer_song_pcm on a mesh of 2 entries of cuda:0: data parallel, then sequence parallel
    rng = np.random.default_rng(SEED)
    song, ref = synthetic_stems(rng, 4, T_SEG), synthetic_stems(rng, 4, 3 * T_SEG)
    cfg = InferenceConfig(normalize_input=False)
    one = MixingStyleTransfer(StyleTransferEngine(seed=SEED), cfg)
    mesh_eng = StyleTransferEngine(seed=SEED, mesh=shards(2))
    pcm = {}
    want, _ = one.transfer_song_pcm(song, ref)
    for name, c in (("data_parallel", cfg), ("sequence_parallel",
                                             InferenceConfig(normalize_input=False, sequence_parallel=True))):
        pipe = MixingStyleTransfer(mesh_eng, c)
        pipe.transfer_song_pcm(song[:, :, :8192], ref[:, :, :8192])  # warm-up, not counted
        torch.cuda.synchronize()
        tcn_block.launches = 0
        t_run = time.perf_counter()
        mix, _ = pipe.transfer_song_pcm(song, ref)
        pcm[name] = {"seconds": time.perf_counter() - t_run, "tcn_block_launches": tcn_block.launches,
                     "max_lsb_vs_single_device": int(np.abs(mix.astype(np.int32) - want).max()),
                     "shape": list(mix.shape)}
        paths[f"parallel_{name}"] = {"tcn_block": tcn_block.launches, "compressor_envelope": 0}
    print(json.dumps({"phase": "parallel_pcm", **pcm}), flush=True)
    if not (pcm["data_parallel"]["max_lsb_vs_single_device"] <= 1
            and all(p["tcn_block_launches"] == 22 and p["shape"] == [2, T_SEG] for p in pcm.values())):
        raise AssertionError(f"the mesh's transfer_song_pcm failed: {pcm}")
    del one, mesh_eng
    torch.cuda.empty_cache()

    started = []  # runs in the background: killed on the way out if still running

    def launch(run):
        started.append(run)
        return run

    try:
        # 3-4. both training CLIs: two ranks on cuda:0 over gloo against one process, the
        # one-process encoder run being torchrun's one rank over NCCL (cuda:LOCAL_RANK); groups
        # run side by side on the card (their times are not scaling figures either way)
        train_corpus(os.path.join(tmp, "corpus"), np.random.default_rng(SEED + 7))
        enc = ["--encoder_config", PAR_ENCODER, "--batch_items", "4", "--epochs", "2",
               "--steps_per_epoch", "1"]
        ranks_args = ["--device", "cuda:0", "--dist_backend", "gloo"]
        gc.collect()
        torch.cuda.empty_cache()  # the card's memory for the ranks, not this process's cache
        one = launch(start_torchrun(1, "fxencoder", tmp, "enc1", enc))
        two = launch(start_torchrun(PAR_RANKS, "fxencoder", tmp, "enc2", enc + ranks_args))
        runs = {"fxencoder_one_nccl": torchrun_result(one, "fxencoder", tmp, "enc1"),
                "fxencoder_two": torchrun_result(two, "fxencoder", tmp, "enc2")}
        encoder_ckpt = os.path.join(tmp, "enc1", "ckpt", "step_00000002.pt")
        # the converter at lr 0: two ranks' step s (each its item 2s + r) is one process's steps
        # 2s and 2s + 1 (one item each), whatever BN's batch statistics and the RMS loss's
        # batch means give, so the epoch's loss and the held-out loss must agree
        conv = ["--encoder_config", PAR_ENCODER, "--encoder_ckpt", encoder_ckpt, "--epochs", "1",
                "--learning_rate", "0", "--segment_length", str(2**17)]
        runs["converter_one"] = cli_run(cli, "converter", tmp, "one_process", "conv1", "ckpt_conv", 4,
                                        conv + ["--batch_items", "1"])
        gc.collect()
        torch.cuda.empty_cache()
        two = launch(start_torchrun(PAR_RANKS, "converter", tmp, "conv2",
                                    conv + ["--steps_per_epoch", "2", "--batch_items", "2", *ranks_args]))
        spawned_run = launch(start_ranks(tmp, PAR_RANKS))  # step 5's ranks, beside the converter's
        runs["converter_two"] = torchrun_result(two, "converter", tmp, "conv2")
        print(json.dumps({"phase": "parallel_train", "runs": runs}), flush=True)

        def close(a, b):
            return all(abs(x - y) <= PAR_LOSS_TOL * abs(y) for x, y in zip(a, b)) and len(a) == len(b)

        e1, e2 = runs["fxencoder_one_nccl"], runs["fxencoder_two"]
        c1, c2 = runs["converter_one"], runs["converter_two"]

        def k2(run):
            return [[r["compressor_envelope"] for r in ranks] for ranks in run["ranks"]]

        ok = (
            # both steps' losses and the held-out loss after the first update; after the second
            # update two one-process runs drift apart too (cuDNN's nondeterministic algorithms
            # and Adam's sign-like first steps at full width: PERF.md §6), so that one is shown
            close(e2["losses"], e1["losses"]) and close(e2["val_losses"][:1], e1["val_losses"][:1])
            and e1["world_size"] == [1, 1] and e2["world_size"] == [PAR_RANKS] * 2
            # each rank 2 K2 launches a step on its own lanes; rank 0 also the held-out loss's 2
            and k2(e2) == [[4] + [2] * (PAR_RANKS - 1)] * 2 and k2(e1) == [[4], [4]]
            and e2["checkpoints"] == e1["checkpoints"] == ["step_00000001.pt", "step_00000002.pt"]
            and close(c2["losses"], c1["losses"]) and close(c2["val_losses"], c1["val_losses"])
            and k2(c2) == [[2 * 2 + 2] + [2 * 2] * (PAR_RANKS - 1)]
            and c1["launches_per_epoch"] == [2 * 4 + 2]
        )
        paths["parallel_train"] = {
            "tcn_block": 0,
            "compressor_envelope": sum(sum(sum(r) for r in k2(run)) for run in (e1, e2, c2))
            + sum(c1["launches_per_epoch"]),
        }
        if not ok:
            raise AssertionError(f"two ranks disagree with one process: {runs}")

        # 5. two spawned ranks against one process, step by step; the FSDP step
        spawned = ranks_result(spawned_run, tmp)
    finally:
        for run in started:
            run.kill()
    ranks = spawned["ranks"]
    spawned.update(steps=PAR_STEPS, grad_tol=PAR_GRAD_TOL, fsdp_world=1, fsdp_backend="nccl",
                   fsdp_tol=FSDP_TOL)
    emit("parallel", t0, seqpar=seqpar, pcm=pcm, spawned=spawned,
         fxencoder_val_after_two_updates_rel=abs(e2["val_losses"][1] - e1["val_losses"][1])
         / abs(e1["val_losses"][1]),
         peak_memory_gb_by_rank={k: [r["max_memory_gb"] for r in run["ranks"][-1]]
                                 for k, run in (("fxencoder", e2), ("converter", c2))},
         note="shards and ranks share one card: no time here is a scaling figure")
    sgd = [r["sgd"] for r in ranks]
    r0 = ranks[0]
    ok = (
        all(r["grad_rel_err"] <= PAR_GRAD_TOL and r["params_rel_err"] <= PAR_GRAD_TOL
            and close(r["losses"], r["one_process_losses"]) for r in sgd)
        # Adam: its first step's gradients (what follows flips with rounding where g ~ 0)
        and all(r["adam"]["grad_rel_err"] <= PAR_GRAD_TOL for r in ranks)
        and abs(r0["fsdp"]["loss"] - r0["replicated"]["loss"]) <= FSDP_TOL * abs(r0["replicated"]["loss"])
        and r0["fsdp_rel_err"] <= FSDP_TOL and r0["local_moments"] == r0["local_params"] == r0["params"]
    )
    if not ok:
        raise AssertionError(f"two spawned ranks or the FSDP step disagree: {spawned}")
    return paths


IMAGER_SR = 48000             # imager_rates: a rate whose Haas draw is not 44.1 kHz's
SEFA_EDITS = {5: (0, 3.0), 12: (1, -3.0)}  # sefa: (eigenvector, strength) on two fused blocks
FRONTEND_TOL = 1e-5           # FrontEnd features and BackEnd waveforms, card vs CPU, over max|cpu|
# Griffin-Lim, card vs CPU from one initial phase, over max|cpu|: each iteration's angle
# is ill-conditioned where a bin is near 0; float32 vs float64 on the CPU reads ~1.6e-5
# after 32 iterations at 2^17 samples of noise
GRIFFIN_LIM_TOL = 1e-3
GRIFFIN_LIM_ITERS = 32
PARITY_COSINE = 0.99999       # parity_tools: the port's FXencoder vs the functional forward
PARITY_NRMSE = 1e-4           # parity_tools: the port's converter (K1) vs the functional forward


def phase_imager_rates():
    """``normalize_device`` at 48 kHz (the default ``NormalizationConfig``
    but the rate) on 4 stems of 2^19 samples, one of them mono so that the
    imager stereoizes it with the Haas draw of that rate: the card (K2)
    against the CPU's plain path, the same compression choices and the
    stems within NORMALIZER_TOL; and the mono stem leaves with a side
    channel (the Haas branch ran). Returns the card run's launches."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.config import NormalizationConfig
    from music_mixing_style_transfer_tpu_torch.fx.processors import haas_params
    from music_mixing_style_transfer_tpu_torch.normalize.batch import BatchedAudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.normalize.features import load_fx_features
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block

    cfg = NormalizationConfig(sample_rate=IMAGER_SR)
    features = load_fx_features(FEATURES, stems=cfg.stems)
    insts = list(cfg.stems)
    song = synthetic_stems(np.random.default_rng(SEED + 11), len(insts), T_SEG) / 32768.0
    song[1, 1] = song[1, 0]  # bass: mono
    fft = cfg.fft_size
    x = torch.from_numpy(np.pad(song.astype(np.float32), ((0, 0), (0, 0), (fft, fft))))
    card = BatchedAudioEffectsNormalizer(features, cfg, device="cuda")
    cpu = BatchedAudioEffectsNormalizer(features, cfg, device="cpu")
    lengths = [T_SEG] * len(insts)
    with torch.inference_mode():
        card.normalize_device(x[:, :, : 2 * fft + 8192].cuda(), insts, [8192] * len(insts))  # warm-up
        xc = x.cuda()
        torch.cuda.synchronize()
        tcn_block.launches = compressor_envelope.launches = 0
        t_card = time.perf_counter()
        got = card.normalize_device(xc, insts, lengths)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t_card
        launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
        got = got.cpu()
        t_cpu = time.perf_counter()
        want = cpu.normalize_device(x, insts, lengths)
        cpu_s = time.perf_counter() - t_cpu
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    a, b = card.last_compression, cpu.last_compression
    same = all(np.array_equal(a[k], b[k]) for k in ("ratio", "threshold", "active", "fallback"))
    # the mono stem leaves with a side channel only if the Haas branch ran
    mid, side = got[1, 0] + got[1, 1], got[1, 0] - got[1, 1]
    side_share = float(side.pow(2).sum() / (mid.pow(2).sum() + side.pow(2).sum()))
    emit("imager_rates", t0, sample_rate=IMAGER_SR, haas=haas_params(IMAGER_SR), shape=list(x.shape),
         mono_stem=insts[1], card_s=card_s, cpu_s=cpu_s, max_abs_err=err, max_abs_ref=scale,
         tol=NORMALIZER_TOL, same_choices=same, mono_stem_side_share=side_share,
         tcn_block_launches=launches["tcn_block"],
         compressor_envelope_launches=launches["compressor_envelope"])
    if not (same and err <= NORMALIZER_TOL * scale and torch.isfinite(got).all()
            and launches["compressor_envelope"] > 0 and launches["tcn_block"] == 0
            and side_share > 1e-3):
        raise AssertionError("normalize_device at 48 kHz on the card disagrees with the CPU")
    return launches


def phase_checkpoints(tmp: str):
    """Weights through the three routes at full width. A: a reference-format
    ``.pt``. B: that ``.pt`` -> ``models/torch_import.py`` -> a flax
    archive (``.npz``) -> ``load_model_state``. C: the archive ->
    ``models/convert_ckpt.py`` -> a ``.pt``. The three state dicts must be
    bit-equal; one normalized song through engines built from route A and
    from route B must be the same int16 (0 LSB), the route-B run counted;
    and a ``ckpt/`` directory of ``step_<n>.pt`` loads its newest step.
    Returns the route-B song's launches and route A's checkpoint paths."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.config import InferenceConfig
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import (
        MixingStyleTransfer,
        StyleTransferEngine,
    )
    from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner, torch_import
    from music_mixing_style_transfer_tpu_torch.models.checkpoints import (
        load_model_state,
        save_flax_archive,
    )
    from music_mixing_style_transfer_tpu_torch.models.convert_ckpt import convert
    from music_mixing_style_transfer_tpu_torch.models.fast_init import seeded_model
    from music_mixing_style_transfer_tpu_torch.models.weights import save_torch_state_dict
    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.train.checkpoint import CheckpointManager
    from music_mixing_style_transfer_tpu_torch.train.state import TrainState, make_optimizer

    paths, equal, t_routes = {}, {}, time.perf_counter()
    for name, cls, seed in (("fxencoder", FXencoder, SEED + 20), ("mixfxcloner", MixFXcloner, SEED + 21)):
        m = seeded_model(cls, seed, randomize_bn=True)
        a = os.path.join(tmp, f"{name}_a.pt")
        save_torch_state_dict(m.state_dict(), a)
        b = os.path.join(tmp, f"{name}_b.npz")
        save_flax_archive(getattr(torch_import, f"load_{name}_variables")(a), b)
        c = os.path.join(tmp, f"{name}_c.pt")
        convert(name, b, c)
        sds = {r: load_model_state(p, cls()).state_dict() for r, p in (("a", a), ("b", b), ("c", c))}
        equal[name] = all(
            sorted(sds[r]) == sorted(sds["a"]) and all(torch.equal(sds[r][k], v) for k, v in sds["a"].items())
            for r in ("b", "c"))
        equal[name] &= all(torch.equal(sds["a"][k], v) for k, v in m.state_dict().items())
        paths[name] = {"a": a, "b": b, "c": c}
        del m, sds
    routes_s = time.perf_counter() - t_routes

    rng = np.random.default_rng(SEED + 22)
    song = synthetic_stems(rng, 4, T_SEG)
    ref = synthetic_stems(rng, 4, T_SEG)
    norm = AudioEffectsNormalizer(FEATURES)
    mixes, launches = {}, None
    for route in ("a", "b"):
        eng = StyleTransferEngine(ckpt_path_enc=paths["fxencoder"][route],
                                  ckpt_path_conv=paths["mixfxcloner"][route], seed=SEED)
        pipe = MixingStyleTransfer(eng, InferenceConfig(normalize_input=True), normalizer=norm)
        pipe.transfer_song_pcm(song[:, :, :8192], ref[:, :, :8192])  # warm-up, not counted
        torch.cuda.synchronize()
        tcn_block.launches = compressor_envelope.launches = 0
        mixes[route], _ = pipe.transfer_song_pcm(song, ref)
        if route == "b":
            launches = {"tcn_block": tcn_block.launches,
                        "compressor_envelope": compressor_envelope.launches}
        del eng, pipe
    lsb = int(np.abs(mixes["a"].astype(np.int32) - mixes["b"].astype(np.int32)).max())

    ckpt = os.path.join(tmp, "run", "ckpt")
    mgr, sd_new = CheckpointManager(ckpt, keep=2), None
    for step, seed in ((1, SEED + 23), (2, SEED + 24)):
        m = seeded_model(FXencoder, seed)
        mgr.save(step, TrainState(step, m, make_optimizer(m.parameters())))
        sd_new = m.state_dict()
    loaded = load_model_state(ckpt, FXencoder()).state_dict()
    newest = all(torch.equal(loaded[k], v) for k, v in sd_new.items())
    emit("checkpoints", t0, routes_s=routes_s, state_dicts_bit_equal=equal,
         archive_mb={n: os.path.getsize(p["b"]) / 1e6 for n, p in paths.items()},
         song_lsb_route_b_vs_a=lsb, mix_peak=int(np.abs(mixes["b"].astype(np.int32)).max()),
         ckpt_dir_steps=mgr.steps(), ckpt_dir_loads_newest=newest,
         tcn_block_launches=launches["tcn_block"],
         compressor_envelope_launches=launches["compressor_envelope"])
    if not (all(equal.values()) and lsb == 0 and np.abs(mixes["b"]).max() > 0 and newest
            and launches["tcn_block"] == 11 and launches["compressor_envelope"] >= 4):
        raise AssertionError("the checkpoint routes failed their checks")
    return launches, {n: p["a"] for n, p in paths.items()}


def phase_sefa():
    """``models/sefa.py``: edits on two fused blocks through the full-width
    MixFXcloner on ``[4, 2, 2^19]``, float32 and bf16, each block taking its
    own condition into K1 (11 launches a forward), held against the
    block-by-block plain path (float32 within CONVERTER_TOL of max; bf16
    NRMSE within BF16_TOL); an edit changes the output, a null edit does
    not. Returns the two edited forwards' launches."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import seeded_model
    from music_mixing_style_transfer_tpu_torch.models.sefa import (
        film_edit_directions,
        sefa_per_block_conditions,
    )
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import converter_plain, tcn_block
    from music_mixing_style_transfer_tpu_torch.utils.device import full_float32

    base_model = seeded_model(MixFXcloner, SEED + 30, "cuda", randomize_bn=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = torch.randn(MAIN_B, 2, T_SEG, device="cuda", generator=gen) * 0.3
    cond = torch.randn(MAIN_B, 2048, device="cuda", generator=gen)
    runs, launches, n_run = {}, {"tcn_block": 0, "compressor_envelope": 0}, []
    with full_float32(), torch.inference_mode():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            model = base_model.to(dtype)
            c = cond.to(dtype)
            conds = sefa_per_block_conditions(c, model, SEFA_EDITS)
            xd = x.to(dtype)
            torch.cuda.synchronize()
            tcn_block.launches = compressor_envelope.launches = 0
            t_run = time.perf_counter()
            got = model(xd, conds)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            n = tcn_block.launches
            n_run.append(n)
            for k, v in (("tcn_block", n), ("compressor_envelope", compressor_envelope.launches)):
                launches[k] += v
            got = got.float()
            want = converter_plain(model, xd, conds).float()
            base = model(xd, c).float()
            null = model(xd, sefa_per_block_conditions(c, model, {b: (e, 0.0) for b, (e, _) in
                                                                   SEFA_EDITS.items()})).float()
            diff = (got - want).double()
            runs[name] = {
                "forward_s": run_s, "tcn_block_launches": n,
                "max_abs_err": float(diff.abs().max()), "max_abs_ref": float(want.abs().max()),
                "nrmse": float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()),
                "edit_vs_base_max_abs_diff": float((got - base).abs().max()),
                "null_edit_equals_base": bool(torch.equal(null, base)),
            }
            del got, want, base, null
    vals, _ = film_edit_directions(base_model.blocks[5].film)
    emit("sefa", t0, shape=[MAIN_B, 2, T_SEG], edits={str(b): e for b, e in SEFA_EDITS.items()},
         block5_top_eigenvalues=[float(v) for v in vals[:3]], runs=runs,
         tol={"float32_max_abs": CONVERTER_TOL, "bfloat16_nrmse": BF16_TOL})
    f32, bf16 = runs["float32"], runs["bfloat16"]
    ok = (n_run == [11, 11] and f32["max_abs_err"] <= CONVERTER_TOL * max(f32["max_abs_ref"], 1e-6)
          and bf16["nrmse"] <= BF16_TOL
          and all(r["edit_vs_base_max_abs_diff"] > 1e-3 and r["null_edit_equals_base"]
                  for r in runs.values()))
    if not ok:
        raise AssertionError(f"SeFa-edited conversion failed its checks: {runs}")
    return launches


def phase_frontend():
    """``models/frontend.py`` on the card against the CPU: ``FrontEnd``
    stereo in ``cplx`` and ``mag`` on ``[2, 2, 2^19]``, the ``BackEnd``'s
    ``cplx`` round trip, and Griffin-Lim (32 iterations) on one channel's
    magnitude from one initial phase. cuFFT only: no kernel of the port."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.models.frontend import BackEnd, FrontEnd
    from music_mixing_style_transfer_tpu_torch.ops.stft import hann_window, magnitude, stft

    x = torch.from_numpy(synthetic_stems(np.random.default_rng(SEED + 40), 2, T_SEG) / 32768.0).float()
    fe, be, mono = FrontEnd("stereo"), BackEnd("stereo"), BackEnd("mono")
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev)
        t_dev = time.perf_counter()
        feats = fe(xd, ["cplx", "mag"])
        wave = be.cplx_to_wave(feats[:, :4])
        spec = stft(xd[:1, 0], fe.n_fft, fe.hop_length, hann_window(fe.n_fft), center=True)
        mag = magnitude(spec.transpose(-1, -2))
        if dev == "cuda":
            phase0 = -np.pi + 2 * np.pi * torch.rand(
                mag.shape, generator=torch.Generator().manual_seed(SEED + 41))
        gl = mono.griffin_lim(mag, GRIFFIN_LIM_ITERS, init_phase=phase0)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t_dev
        out[dev] = {"features": feats.cpu(), "wave": wave.cpu(), "griffin_lim": gl.cpu()}

    def rel(k):
        a, b = out["cuda"][k], out["cpu"][k]
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    errs = {k: rel(k) for k in ("features", "wave", "griffin_lim")}
    n = x.shape[-1]
    recon = float((out["cuda"]["wave"][..., 512 : n - 2048] - x[..., 512 : n - 2048]).pow(2).mean().sqrt())
    emit("frontend", t0, shape=list(x.shape), features_shape=list(out["cuda"]["features"].shape),
         griffin_lim_iters=GRIFFIN_LIM_ITERS, card_s=secs["cuda"], cpu_s=secs["cpu"],
         rel_err=errs, tol={"features": FRONTEND_TOL, "wave": FRONTEND_TOL,
                            "griffin_lim": GRIFFIN_LIM_TOL},
         cplx_round_trip_rms_err=recon)
    ok = (errs["features"] <= FRONTEND_TOL and errs["wave"] <= FRONTEND_TOL
          and errs["griffin_lim"] <= GRIFFIN_LIM_TOL and recon < 0.02
          and all(torch.isfinite(v).all() for v in out["cuda"].values()))
    if not ok:
        raise AssertionError(f"FrontEnd/BackEnd on the card disagree with the CPU: {errs}, {recon}")
    return {"tcn_block": 0, "compressor_envelope": 0}


def phase_parity_tools(tmp: str, ckpts: dict):
    """``tools/parity_check.py`` at full width on the card: the port's
    FXencoder from the ``checkpoints`` phase's route-A ``.pt`` and a
    MixFXcloner ``.pt`` (output layer scaled by 0.01 so the clamp does not
    hide a difference) against the functional forward on the same state
    dict, one stereo segment of 2^19 samples. Returns the converter check's
    launches (K1 in the port's forward; the functional forward is cuDNN)."""
    t0 = time.perf_counter()
    import torch

    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.models.fast_init import seeded_model
    from music_mixing_style_transfer_tpu_torch.models.weights import save_torch_state_dict
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.tools import parity_check

    conv = seeded_model(MixFXcloner, SEED + 50, randomize_bn=True)
    with torch.no_grad():
        conv.output.weight.mul_(0.01)
        conv.output.bias.mul_(0.01)
    conv_pt = os.path.join(tmp, "parity_conv.pt")
    save_torch_state_dict(conv.state_dict(), conv_pt)
    rng = np.random.default_rng(SEED + 51)
    x = (rng.standard_normal((1, 2, T_SEG)) * 0.1).astype(np.float32)
    cond = rng.standard_normal((1, 2048)).astype(np.float32)
    enc = parity_check.check_encoder(ckpts["fxencoder"], x)
    tcn_block.launches = compressor_envelope.launches = 0
    t_conv = time.perf_counter()
    converter = parity_check.check_converter(conv_pt, x, cond)
    conv_s = time.perf_counter() - t_conv
    launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    emit("parity_tools", t0, fxencoder=enc, mixfxcloner=converter, converter_check_s=conv_s,
         tol={"embedding_cosine_min": PARITY_COSINE, "nrmse": PARITY_NRMSE},
         tcn_block_launches=launches["tcn_block"])
    if not (enc["embedding_cosine_min"] >= PARITY_COSINE and converter["nrmse"] <= PARITY_NRMSE
            and converter["max_abs_ref"] < 1.0 and launches["tcn_block"] == 11):
        raise AssertionError("parity_check at full width failed its checks")
    return launches


def phase_card_checks():
    """``tools/card_checks.py``'s full-model check (kernel path vs plain
    path, float32 and bf16) and its bf16-vs-float32 fidelity check at
    ``SEG = 2^19`` (its per-dilation check is ``kernel_vs_plain``'s).
    Returns their launches."""
    t0 = time.perf_counter()
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block
    from music_mixing_style_transfer_tpu_torch.tools import card_checks

    tcn_block.launches = compressor_envelope.launches = 0
    # seeded noise, never a reference checkout's samples: what this gate compares is fixed
    full = card_checks.check_full_model(reference_root=None)
    fidelity = card_checks.check_bf16_fidelity(reference_root=None)
    launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    emit("card_checks", t0, segment_length=card_checks.SEG, full_model=full,
         bf16_fidelity=fidelity, tcn_block_launches=launches["tcn_block"])
    if not (full["pass"] and fidelity["pass"] and launches["tcn_block"] == 44):
        raise AssertionError(f"card_checks failed: {full}, {fidelity}, {launches}")
    return launches


def phase_demo(tmp: str):
    """The port's demo end to end on the card with its defaults (15 s, bf16,
    segments of 2^17, FX normalization): the WAVs it writes and its
    launches."""
    t0 = time.perf_counter()
    from music_mixing_style_transfer_tpu_torch.data.wavio import read_wav_stereo_ct
    from music_mixing_style_transfer_tpu_torch.examples import demo_style_transfer
    from music_mixing_style_transfer_tpu_torch.ops.cuda.envelope import compressor_envelope
    from music_mixing_style_transfer_tpu_torch.ops.cuda.tcn_block import tcn_block

    out = os.path.join(tmp, "demo")
    tcn_block.launches = compressor_envelope.launches = 0
    rc = demo_style_transfer.main(["--out", out])
    launches = {"tcn_block": tcn_block.launches, "compressor_envelope": compressor_envelope.launches}
    song = os.path.join(out, "song1")
    wavs = sorted(n for n in os.listdir(song) if n.endswith(".wav"))
    mix = read_wav_stereo_ct(os.path.join(song, "mixture_output.wav"))
    emit("demo", t0, returncode=rc, wavs=wavs, mix_shape=list(mix.shape),
         mix_peak=float(np.abs(mix).max()), tcn_block_launches=launches["tcn_block"],
         compressor_envelope_launches=launches["compressor_envelope"])
    if not (rc == 0 and mix.shape == (2, int(SR * 15.0)) and np.isfinite(mix).all()
            and np.abs(mix).max() > 0 and len(wavs) == 5
            and launches["tcn_block"] > 0 and launches["compressor_envelope"] > 0):
        raise AssertionError(f"the demo failed its checks: {wavs}, {launches}")
    return launches


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
                       by_path: dict, fastpath: dict, triplet: dict, blockwise: dict):
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
        "replaces": "music_mixing_style_transfer_tpu/ops/pallas/envelope.py:106",
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
        "fastpath": fastpath,
        "triplet": triplet,
        "blockwise": blockwise,
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
    with tempfile.TemporaryDirectory() as work:  # the corpus, and the encoder the converter trains against
        by_path["train_fxencoder"], fastpath, encoder_ckpt = phase_train_fxencoder(work)
        by_path["train_converter"], triplet = phase_train_converter(work, encoder_ckpt)
    with tempfile.TemporaryDirectory() as work:  # the raw and the prepared corpus
        blockwise, data_paths = phase_data_tools(work)
    by_path.update(data_paths)
    with tempfile.TemporaryDirectory() as work:  # the multi-card paths' corpus and runs
        by_path.update(phase_parallel(work))
    by_path["imager_rates"] = phase_imager_rates()
    with tempfile.TemporaryDirectory() as work:  # the checkpoints of every route, the demo's songs
        by_path["checkpoints"], ckpts = phase_checkpoints(work)
        by_path["sefa"] = phase_sefa()
        by_path["frontend"] = phase_frontend()
        by_path["parity_tools"] = phase_parity_tools(work, ckpts)
        by_path["card_checks"] = phase_card_checks()
        by_path["demo"] = phase_demo(work)
    with full_float32():
        kernels = phase_kernels_line(launches, interp_cases, f64, env_launches, env, t_all, by_path,
                                     fastpath, triplet, blockwise)
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
