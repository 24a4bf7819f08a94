"""Driver ``mixes``: whole stereo mixtures through
``MixingStyleTransfer.transfer_mix_pcm``, closed loop, one request at a
time, as ``run_directory`` and the server's ``/transfer`` hand them over
with ``separation_model="htdemucs"``: an int16 ``[2, T]`` input mixture and
a reference mixture (another song), both separated on the card by HTDemucs,
then the stem stacks through the serving stages of ``songs``.

Traffic keys: those of ``songs`` (``lengths_s``, ``min_passes``,
``orders``, ``checked_songs``, ``checked_segments``), which pick the songs,
the references, the passes and the window alike. The warm-up separates each
mixture once (every dispatch shape of the separator) and sends the shortest
and the longest request whole (the converter's smallest and largest
bucket); a traced run then installs ``songs``' spans and hooks, so the
stages after separation are read as in ``serve_songs``. Each mixture is the sum of
the four stems that ``songs`` makes from the seed for the same song,
quantized as a 16-bit WAV holds it. A request that raises
``torch.OutOfMemoryError`` is a failed request, as in ``songs``. The
configuration's ``separator`` group is the separator's
``HTDemucsConfig``; its weights come from ``weights_htdemucs``.

``correct``: the checked songs (as ``songs`` picks them), in their second
pass: ``sep_err``, the worst source's NRMSE of the program's separation of
the input and the reference mixture against the frozen reference's float32
separation of the same mixture (``reference/plain/htdemucs.py``, TF32
off); then ``songs``' checks on the program's own separated stems. Controls
(``readings.py --control``): ``sep_tf32`` and ``sep_bf16`` put the
reference's separation with TF32 on, or in bfloat16, in the program's place
for ``sep_err``; ``control`` is ``songs``' control for the later stages.
"""
from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from mstbench import weights, weights_htdemucs
from mstbench.drivers import songs
from mstbench.harness import Check, Outcome
from mstbench.reference import nrmse, tuples
from mstbench.reference.plain import htdemucs as plain
from mstbench.songs import SR, synth_song, to_pcm16

SEP_CONTROLS = {"sep_tf32", "sep_bf16"}


def layout(cfg: dict) -> torch.nn.Module:
    """The reference HTDemucs at the configuration's sizes, on the meta
    device."""
    with torch.device("meta"):
        return plain.HTDemucs(plain.HTDemucsConfig(**tuples(cfg["separator"])))


def build(ctx, state):
    """``songs``' serving deployment with the in-process separator, both
    with the benchmark's weights."""
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import MixingStyleTransfer
    from music_mixing_style_transfer_tpu_torch.models.htdemucs import (
        HTDemucsConfig,
        HTDemucsSeparator,
    )

    mst = songs.build(ctx)
    sep = HTDemucsSeparator(HTDemucsConfig(**tuples(ctx.config["separator"])), device=ctx.device)
    weights.load(sep.model, state)
    return MixingStyleTransfer(mst.engine, mst.cfg, mst.normalizer, separator=sep)


def mixtures(ctx, lengths):
    """int16 ``[2, n]`` host arrays: each song's four stems summed."""
    return [to_pcm16(synth_song(ctx.sub_seed("input", i), n, ctx.device).sum(0)).cpu().numpy()
            for i, n in enumerate(lengths)]


def chunks(T: int, cfg: dict) -> int:
    """Chunks of the separator for a mixture of ``T`` samples."""
    L = int(round(cfg["segment"] * cfg["samplerate"]))
    return len(range(0, T, int((1 - cfg["overlap"]) * L)))


def run(ctx) -> Outcome:
    # a program without the separator fails here, before any set-up
    import music_mixing_style_transfer_tpu_torch.models.htdemucs  # noqa: F401

    from mstbench.tracing import Spans

    tr, inf = ctx.traffic, ctx.config["inference"]
    L, Lr = inf["segment_length"], inf["segment_length_ref"]
    S = len(inf["instruments"])
    lengths = [int(round(s * SR)) for s in tr["lengths_s"]]
    n = len(lengths)
    rng = np.random.default_rng(ctx.sub_seed("order"))
    cycle = rng.permutation(n)  # song cycle[k]'s reference is song cycle[k + 1]
    ref_of = {int(cycle[k]): int(cycle[(k + 1) % n]) for k in range(n)}
    state = weights_htdemucs.seeded_state(layout(ctx.config), ctx.sub_seed("separator"), ctx.device)
    mst = build(ctx, state)
    ctx.mark("build")
    inputs = mixtures(ctx, lengths)
    refs = [inputs[ref_of[i]] for i in range(n)]
    ctx.mark("songs")
    capture = songs.Capture(mst)
    separate = mst.separator.separate

    def separate_captured(mix):
        out = separate(mix)
        if capture.on:
            capture.got.setdefault("stems", []).append(out.cpu())
        return out

    mst.separator.separate = separate_captured
    counters = ctx.counters
    counters.update(converter_batches=[], k1_launches=[], attempts=[])
    sep_cfg = ctx.config["separator"]
    spans = Spans()

    def attempt(i):
        """One request: ``(mixture or None, the choices)``."""
        try:
            mix, _ = mst.transfer_mix_pcm(inputs[i], refs[i])
            return mix, capture.choices()
        except songs._oom_types():
            spans.close_all()
        torch.cuda.empty_cache()
        return None, None

    # warm-up: every dispatch shape of the separator (each mixture once), then
    # whole requests at the converter's smallest and largest bucket only (the
    # largest fails on the card: once, not at every length that reaches it)
    for mix in inputs:
        separate(mix)
    by_length = sorted(range(n), key=lengths.__getitem__)
    for i in sorted({by_length[0], by_length[-1]}):
        attempt(i)
    if ctx.trace_on:
        songs.install_spans(mst, spans, counters)
    checked, outputs = [], {}
    passes = 0
    with ctx.window():
        t0 = time.perf_counter()
        while passes < tr["min_passes"] or (
                time.perf_counter() - t0) * (passes + 1) <= ctx.seconds * passes:
            for i in tr["orders"][passes % len(tr["orders"])]:
                i = int(i)
                capture.on = passes == 1 and i in checked
                before = len(counters["converter_batches"])
                t = time.perf_counter()
                mix, choices = attempt(i)
                Tr = refs[i].shape[-1]
                counters["attempts"].append({
                    "i": i, "samples": lengths[i], "ref_samples": Tr, "ok": mix is not None,
                    "chunks": chunks(lengths[i], sep_cfg) + chunks(Tr, sep_cfg),
                    "segments": S * -(-lengths[i] // L),
                    "ref_segments": S * (-(-Tr // Lr) if Tr > 2 * Lr else 1),
                    "batches": counters["converter_batches"][before:],
                    "pass": passes, "wall_s": time.perf_counter() - t,
                })
                if capture.on and mix is not None:
                    outputs[i] = dict(capture.got, mixture=mix, choices=choices)
                capture.got = {}
            if passes == 0:
                checked = songs.pick(ctx, [a["i"] for a in counters["attempts"] if a["ok"]],
                                     lengths)
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
                    attempted_audio_s=sum(a["samples"] for a in attempts) / SR,
                    attempted_mix_s=sum(a["samples"] + a["ref_samples"] for a in attempts) / SR)
    peak = ctx.peak_bytes()

    del mst, capture, separate, spans
    torch.cuda.empty_cache()
    checks = check(ctx, state, checked, outputs, inputs, refs)
    return Outcome(metrics, len(attempts), sum(not a["ok"] for a in attempts), checks, peak)


def check(ctx, state, checked, outputs, inputs, refs):
    """``sep_err`` on the checked songs' mixtures, then ``songs``' checks on
    the program's separated stems."""
    dev = ctx.device
    model = weights.load(layout(ctx.config).to_empty(device=dev), state).eval()
    low = copy.deepcopy(model).to(torch.bfloat16) if ctx.control == "sep_bf16" else None
    sep_err = 0.0
    stems_in, stems_ref = {}, {}
    for i in checked:
        if i not in outputs:
            continue
        got_in, got_ref = outputs[i].pop("stems")
        stems_in[i], stems_ref[i] = got_in.numpy(), got_ref.numpy()
        for mix, got in ((inputs[i], got_in), (refs[i], got_ref)):
            t0 = time.perf_counter()
            x = torch.from_numpy(mix).to(dev)
            want = plain.separate(model, x).cpu()
            if ctx.control in SEP_CONTROLS:  # the control's separation in the program's place
                got = plain.separate(model if low is None else low, x, tf32=ctx.control == "sep_tf32").cpu()
            err = max(nrmse(got[s], want[s]) for s in range(want.shape[0]))
            print(f"reading mixture {mix.shape[-1] / SR:.1f} s: sep_err {err!r} "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
            sep_err = max(sep_err, err)
    del model, low
    torch.cuda.empty_cache()
    checks = songs.check(ctx, checked, outputs, stems_in, stems_ref)
    checks["sep_err"] = Check(sep_err, float(ctx.limits["sep_err"]))
    return checks
