"""Driver ``songs``: whole songs through ``MixingStyleTransfer.transfer_song_pcm``
in a closed loop, one song at a time, as ``run_directory`` and the
server's ``/transfer`` hand them over after the WAV read: int16 ``[4, 2, T]``
input and reference stacks.

Traffic keys: ``lengths_s`` (the songs' lengths; each song's reference is
another of the songs), ``min_passes``, ``orders``, ``checked_songs`` and
``checked_segments``. The seed draws the music and the pairing of
references (one cycle through the songs). A pass sends every song once,
pass ``p`` in the order ``orders[p % len(orders)]`` (the same for every
seed: a song after a failed one finds the allocator's cache empty, so the
order changes the work). The window holds whole passes, so every window
holds the same mix: at least ``min_passes``, and then another only while
the passes so far, at their mean time, say it ends within ``--seconds``. A
song that raises ``torch.OutOfMemoryError`` is a failed request: its time
stays in the window, the allocator's cache is emptied and the next song
goes.

``correct``: a sample of the songs that completed (the longest, and others
drawn from the seed) is checked against the plain reference in their
second pass: the compression choices of the normalizer, the normalizer's
output, the reference stems' embeddings, and the int16 mixture on
``checked_segments`` of the song's segments (its last and others drawn from
the seed) against the reference's converter and sum run on the program's
own normalized stems and embeddings (its error over that of the
reference's converter in the served dtype).
"""
from __future__ import annotations

import concurrent.futures
import os
import sys
import time

import numpy as np
import torch

from mstbench import harness, weights
from mstbench.harness import Check, Outcome
from mstbench.reference import nrmse, seeded_weights, tuples
from mstbench.songs import SR, synth_song, to_pcm16


def _oom_types():
    return (torch.OutOfMemoryError,) if hasattr(torch, "OutOfMemoryError") else (
        torch.cuda.OutOfMemoryError,)


def engine(ctx):
    """The cell's ``StyleTransferEngine`` with the benchmark's weights."""
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import StyleTransferEngine

    cfg, dev = ctx.config, ctx.device
    dtype = cfg["inference"]["dtype"]
    eng = StyleTransferEngine(FXencoderConfig(**tuples(cfg["encoder"])),
                              TCNConfig(**tuples(cfg["converter"])), dtype=dtype, device=dev)
    served = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for name, module in (("encoder", eng.encoder), ("converter", eng.converter)):
        weights.load(module, weights.seeded_state(module, ctx.sub_seed(name), dev, served))
    return eng


def build(ctx):
    """The serving deployment of the cell's configuration (``serve.py
    --normalize_input``), with the benchmark's weights."""
    from music_mixing_style_transfer_tpu_torch.config import InferenceConfig
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import MixingStyleTransfer
    from music_mixing_style_transfer_tpu_torch.normalize import AudioEffectsNormalizer

    cfg = ctx.config
    inf = tuples(cfg["inference"])
    normalizer = None
    if inf["normalize_input"]:
        normalizer = AudioEffectsNormalizer(
            os.path.join(harness.ROOT, cfg["normalization"]["features"]), device=ctx.device)
    return MixingStyleTransfer(engine(ctx), InferenceConfig(**inf), normalizer)


def songs(ctx, lengths, tag: str):
    """int16 ``[4, 2, n]`` host arrays, one a length, made on the device."""
    return [to_pcm16(synth_song(ctx.sub_seed(tag, i), n, ctx.device)).cpu().numpy()
            for i, n in enumerate(lengths)]


class Capture:
    """What the program produced for the songs under check, taken at the
    layer boundaries by wrappers on the engine's and normalizer's
    instances: the normalizer's output and the reference embeddings (to
    the host at once, so they take no card memory)."""

    def __init__(self, mst):
        self.on = False
        self.got = {}
        self._mst = mst
        eng = mst.engine
        group_mean = eng._encode_group_mean

        def encode_group_mean(*a, **k):
            out = group_mean(*a, **k)
            if self.on:
                self.got["embeddings"] = out.float().cpu()
            return out

        eng._encode_group_mean = encode_group_mean
        if mst.normalizer is not None and mst.cfg.normalize_input:
            batched = mst.normalizer.batched()
            normalize_device = batched.normalize_device

            def normalize(*a, **k):
                out = normalize_device(*a, **k)
                if self.on:
                    self.got["normalized"] = out.cpu()
                return out

            batched.normalize_device = normalize

    def choices(self):
        n = self._mst.normalizer
        return None if n is None else dict(n.batched().last_compression)


def install_spans(mst, spans, counters):
    """The traced run's spans, and the K1 launches' shapes and the
    converter's batch sizes for the readers."""
    from music_mixing_style_transfer_tpu_torch.models.tcn import TCNBlock

    eng = mst.engine
    spans.module(eng.encoder, "mst.encoder")
    spans.module(eng.converter, "mst.converter",
                 on_call=lambda m, a: counters["converter_batches"].append(int(a[0].shape[0])))
    if mst.normalizer is not None:
        spans.method(mst.normalizer.batched(), "normalize_device", "mst.normalize")
    for block in eng.converter.blocks:
        if isinstance(block, TCNBlock) and block.uses_kernel():
            block.register_forward_hook(
                lambda m, a, out: counters["k1_launches"].append(
                    (int(a[0].shape[0]), int(a[0].shape[1]), int(m.dilation),
                     a[0].dtype == torch.bfloat16)))


def pick(ctx, done, lengths):
    """The songs to check: the longest that completed, and others drawn
    from the seed."""
    if not done:
        return []
    longest = max(done, key=lambda j: lengths[j])
    others = sorted(set(done) - {longest})
    k = min(len(others), ctx.traffic["checked_songs"] - 1)
    rng = np.random.default_rng(ctx.sub_seed("checked"))
    return [longest] + [int(j) for j in rng.choice(others, k, replace=False)] if k else [longest]


def run(ctx) -> Outcome:
    from mstbench.tracing import Spans

    tr, inf = ctx.traffic, ctx.config["inference"]
    L, Lr = inf["segment_length"], inf["segment_length_ref"]
    S = len(inf["instruments"])
    lengths = [int(round(s * SR)) for s in tr["lengths_s"]]
    n = len(lengths)
    rng = np.random.default_rng(ctx.sub_seed("order"))
    cycle = rng.permutation(n)  # song cycle[k]'s reference is song cycle[k + 1]
    ref_of = {int(cycle[k]): int(cycle[(k + 1) % n]) for k in range(n)}
    ref_lengths = [lengths[ref_of[i]] for i in range(n)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # songs made while the engine builds
        made = pool.submit(songs, ctx, lengths, "input")
        mst = build(ctx)
        ctx.mark("build")
        inputs = made.result()
    refs = [inputs[ref_of[i]] for i in range(n)]
    ctx.mark("songs")
    capture = Capture(mst)
    counters = ctx.counters
    counters.update(converter_batches=[], k1_launches=[], attempts=[])
    spans = Spans()

    def attempt(i):
        """One request: ``(mixture or None, the choices)``."""
        try:
            mix, _ = mst.transfer_song_pcm(inputs[i], refs[i])
            return mix, capture.choices()
        except _oom_types():
            spans.close_all()
        torch.cuda.empty_cache()
        return None, None

    for i in range(n):  # warm-up: every shape of the window, once
        attempt(i)
    if ctx.trace_on:
        install_spans(mst, spans, counters)
    checked, outputs = [], {}
    passes = 0
    with ctx.window():
        t0 = time.perf_counter()
        while passes < tr["min_passes"] or (
                time.perf_counter() - t0) * (passes + 1) <= ctx.seconds * passes:
            for i in tr["orders"][passes % len(tr["orders"])]:
                capture.on = passes == 1 and i in checked
                before = len(counters["converter_batches"])
                t = time.perf_counter()
                mix, choices = attempt(int(i))
                counters["attempts"].append({
                    "i": int(i), "samples": lengths[i], "ok": mix is not None,
                    "segments": S * -(-lengths[i] // L),
                    "ref_segments": S * (-(-ref_lengths[i] // Lr) if ref_lengths[i] > 2 * Lr else 1),
                    "batches": counters["converter_batches"][before:],
                    "pass": passes, "wall_s": time.perf_counter() - t,
                })
                if capture.on and mix is not None:
                    outputs[int(i)] = dict(capture.got, mixture=mix, choices=choices)
                capture.got = {}
            if passes == 0:
                checked = pick(ctx, [a["i"] for a in counters["attempts"] if a["ok"]], lengths)
            passes += 1
    spans.remove()
    attempts = counters["attempts"]
    ok_s = sum(a["samples"] for a in attempts if a["ok"]) / SR
    print("passes_s " + " ".join(f"{sum(a['wall_s'] for a in attempts if a['pass'] == p):.3f}"
                                 for p in range(passes))
          + f" completed_songs_s {sum(a['wall_s'] for a in attempts if a['ok']):.3f}"
          + f" failed_songs_s {sum(a['wall_s'] for a in attempts if not a['ok']):.3f}",
          file=sys.stderr)
    metrics = {"song_audio_s_per_s": ok_s / ctx.window_s,
               "peak_mem_gib": ctx.window_peak_bytes / 2**30}
    counters.update(window_s=ctx.window_s, completed_audio_s=ok_s,
                    attempted_audio_s=sum(a["samples"] for a in attempts) / SR)
    peak = ctx.peak_bytes()

    del mst, capture, spans
    torch.cuda.empty_cache()
    checks = check(ctx, checked, outputs, inputs, refs)
    return Outcome(metrics, len(attempts), sum(not a["ok"] for a in attempts), checks, peak)


def check(ctx, checked, outputs, inputs, refs):
    """The checked songs against the plain reference (the control's
    readings in its place when the run is a control run)."""
    from mstbench.reference.serve import SongReference, choice_mismatches

    cfg, dev = ctx.config, ctx.device
    inf = cfg["inference"]
    served = torch.bfloat16 if inf["dtype"] == "bfloat16" else torch.float32
    feats = os.path.join(harness.ROOT, cfg["normalization"]["features"])

    def reference(control=False):
        return SongReference(cfg, *[seeded_weights(k, cfg[k], ctx.sub_seed(k), dev, served)
                                    for k in ("encoder", "converter")], feats, dev, control=control)

    limits = ctx.limits
    worst = {"choices": 0.0, "norm_nrmse": 0.0, "emb_err": 0.0, "mix_err": 0.0}
    missing = [i for i in checked if i not in outputs]
    ref = reference()
    ctl = reference(control=True) if ctx.control == "control" else None
    insts = list(inf["instruments"])
    L = inf["segment_length"]
    for i in checked:
        if i not in outputs:
            continue
        got = outputs[i]
        t0 = time.perf_counter()
        T = inputs[i].shape[-1]
        limit = None
        if got["choices"] is not None:  # each channel's sweep up to the program's choice
            idx = ref.grid_index(insts, got["choices"]["ratio"], got["choices"]["threshold"])
            limit = np.where(np.asarray(got["choices"]["active"], bool), idx + 1, 1)
        if inf["normalize_input"]:
            normalized, _, choices = ref.normalize(inputs[i], insts, limit)
        pcm_in = torch.nn.functional.pad(ref.pcm(inputs[i]), (0, -(-T // L) * L - T))
        torch.cuda.synchronize() if dev.type == "cuda" else None
        t1 = time.perf_counter()
        n_seg = -(-T // L)
        k = min(n_seg, ctx.traffic["checked_segments"])
        rng = np.random.default_rng(ctx.sub_seed("segments", i))
        rows = sorted({n_seg - 1} | {int(j) for j in rng.choice(n_seg - 1, k - 1, replace=False)})
        at = np.zeros(T, bool)  # the samples of the checked segments
        for j in rows:
            at[j * L : (j + 1) * L] = True
        embs = ref.embed_stems(refs[i])
        fft = ref.norm_cfg.fft_size
        if ctl is not None:  # the control's answers in the program's place
            if inf["normalize_input"]:
                c_norm, c_in, c_choices = ctl.normalize(inputs[i], insts, limit)
            else:
                c_norm, c_in, c_choices = None, pcm_in, None
            c_emb = ctl.embed_stems(refs[i])
            got = {"choices": c_choices, "normalized": None if c_norm is None else c_norm.cpu(),
                   "embeddings": c_emb.cpu(),
                   "mixture": np.round(np.clip(ctl.convert(c_in, c_emb, T, rows=rows),
                                               -1, 32767 / 32768) * 32768).astype(np.int16)}
        if got["choices"] is not None:
            worst["choices"] += choice_mismatches(got["choices"], choices)
            worst["norm_nrmse"] = max(worst["norm_nrmse"], nrmse(
                got["normalized"][:, :, fft : fft + T], normalized[:, :, fft : fft + T]))
        e_got, e_ref = got["embeddings"].double(), embs.double().cpu()
        worst["emb_err"] = max(worst["emb_err"], float(
            ((e_got - e_ref).norm(dim=-1) / e_ref.norm(dim=-1)).max()))
        # The converter and the sum, on the converter's input and conditions
        # as the program made them (its normalized stems and its reference
        # embeddings, each judged above), so that neither stage's error
        # reaches this one: the mixture's error over the error of the
        # reference's own converter in the served dtype on the same input (a
        # random-weight converter's near-silent output makes its relative
        # error swing 10x from seed to seed, and this ratio divides that out;
        # float32 serving is judged against the mixture's own norm).
        if inf["normalize_input"]:
            Tb = n_seg * L
            x_in = got["normalized"][:, :, fft : fft + Tb].to(dev).clamp(-1.0, 1.0)
            x_in = x_in * (torch.arange(Tb, device=dev) < T)
        else:
            x_in = pcm_in
        e_in = got["embeddings"].to(dev)
        mix = np.clip(ref.convert(x_in, e_in, T, rows=rows), -1.0, 32767 / 32768)[:, at]
        served = np.zeros_like(mix) if ref.served == torch.float32 else np.clip(
            ref.convert(x_in, e_in, T, ref.served, rows), -1.0, 32767 / 32768)[:, at]
        print(f"reading song {T / 44100:.1f} s: sweep {limit} candidates, normalize "
              f"{t1 - t0:.1f} s, networks {time.perf_counter() - t1:.1f} s on segments {rows}",
              file=sys.stderr)
        err = np.linalg.norm(got["mixture"][:, at] / 32768.0 - mix)
        worst["mix_err"] = max(worst["mix_err"], float(err / np.linalg.norm(served - mix)))
        print(f"reading song {T / 44100:.1f} s: mix_nrmse {float(err / np.linalg.norm(mix))!r} "
              f"served_nrmse {float(np.linalg.norm(served - mix) / np.linalg.norm(mix))!r}",
              file=sys.stderr)
        del x_in, pcm_in, embs
        torch.cuda.empty_cache()
    checks = {k: Check(v, float(limits[k])) for k, v in worst.items()}
    # every sampled song checked, and at least one
    checks["unchecked"] = Check(float(len(missing) + (not checked)), 0.0)
    return checks
