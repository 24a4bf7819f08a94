"""Driver ``train``: converter training through
``FusedConverterPipeline.step``, as the training loop runs it with its
prefetcher: a producer thread makes each step's raw int16 batch and FX
plans from the seed while the card trains on the last one.

Traffic keys: ``bank_songs`` and ``bank_seconds`` (the synthetic songs made
on the card at set-up that every batch's segments are cut from, each item's
two contents at offsets and songs drawn from the seed) and
``checked_steps``. Set-up builds the pipeline, the converter's state and
its optimizer once, drives them through the first ``checked_steps`` steps
(which warm up every shape) and hands that same state to the window,
which runs steps until ``--seconds`` have passed; at most two steps are in
flight. ``converter_step_s`` is the window's seconds over its steps.

``correct``: the reference replays the first steps from the same weights
and batches; each step's loss, each leaf's first gradient (read from
Adam's first moment after one step) and each leaf's change after the last
checked step are compared.
"""
from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from mstbench import weights
from mstbench.harness import Check, Outcome
from mstbench.reference import tuples
from mstbench.songs import SR, synth_song, to_pcm16


def module(ctx, cls, cfg_cls, name):
    """The program's ``cls`` at the configuration's sizes with the
    benchmark's weights, on the device."""
    with torch.device("meta"):
        m = cls(cfg_cls(**tuples(ctx.config[name])))
    m = m.to_empty(device=ctx.device)
    return weights.load(m, weights.seeded_state(m, ctx.sub_seed(name), ctx.device))


class Batches:
    """Raw batches ``[n_inst, items, 2, 2, L + 2 pad]`` (int16) and their
    plans, the k-th drawn from the seed alone, cut from a bank of songs."""

    def __init__(self, ctx, chains):
        tc, tr = ctx.config["train"], ctx.traffic
        self.ctx, self.chains, self.tc = ctx, chains, tc
        n = int(tr["bank_seconds"] * SR)
        self.bank = [to_pcm16(synth_song(ctx.sub_seed("bank", i), n, ctx.device)).cpu().numpy()
                     for i in range(tr["bank_songs"])]
        self.load_len = tc["segment_length"] + 2 * tc["pad"]

    def __call__(self, k: int):
        tc, insts = self.tc, self.tc["instruments"]
        B = tc["batch_size_per_device"]
        rng = np.random.default_rng(self.ctx.sub_seed("batch", k))
        segs = np.empty((len(insts), B, 2, 2, self.load_len), np.int16)
        for ii in range(len(insts)):
            for j in range(B):
                for c in range(2):
                    song = self.bank[rng.integers(len(self.bank))]
                    o = int(rng.integers(0, song.shape[-1] - self.load_len))
                    segs[ii, j, c] = song[ii, :, o : o + self.load_len]
        g = torch.Generator().manual_seed(self.ctx.sub_seed("plans", k))
        return segs, {inst: self.chains[inst].draw(g, B) for inst in insts}


class Producer:
    """A thread that makes batches ``start, start + 1, ...`` ahead of the
    trainer."""

    def __init__(self, make, start: int, depth: int = 2):
        self.q: queue.Queue = queue.Queue(depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, args=(make, start), daemon=True)
        self.thread.start()

    def _loop(self, make, k):
        while not self.stop.is_set():
            item = make(k)
            while not self.stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            k += 1

    def get(self):
        return self.q.get(timeout=60)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("the batch producer did not stop")


def run(ctx) -> Outcome:
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig, TrainConfig
    from music_mixing_style_transfer_tpu_torch.fx.factory import make_instrument_manipulators
    from music_mixing_style_transfer_tpu_torch.models import FXencoder, MixFXcloner
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedConverterPipeline
    from music_mixing_style_transfer_tpu_torch.train.state import (
        TrainState, make_lr_schedule, make_optimizer)

    from mstbench.reference.train import manipulators
    from mstbench.tracing import Spans

    tc, dev = ctx.config["train"], ctx.device
    tcfg = TrainConfig(batch_size_per_device=tc["batch_size_per_device"],
                       segment_length=tc["segment_length"], learning_rate=tc["learning_rate"],
                       compute_dtype=tc["compute_dtype"])
    encoder = module(ctx, FXencoder, FXencoderConfig, "encoder")
    converter = module(ctx, MixFXcloner, TCNConfig, "converter").train()
    opt = make_optimizer(converter.parameters(), tcfg.learning_rate, tcfg.weight_decay)
    state = TrainState(step=0, model=converter, optimizer=opt, lr_schedule=make_lr_schedule(tcfg))
    pipe = FusedConverterPipeline(encoder, rms_weight=tc["rms_weight"],
                                  compute_dtype=tc["compute_dtype"], device=dev, fast=True)
    pipe.set_chains(make_instrument_manipulators(tc["instruments"], tc["apply_prob"],
                                                 tc["reverb_prob"], None, tc["sample_rate"]),
                    tc["instruments"], tc["pad"], tc["segment_length"])
    ctx.mark("build")
    make = Batches(ctx, manipulators(tc))
    checked = ctx.traffic["checked_steps"]
    firsts = [make(k) for k in range(checked)]
    ctx.mark("songs")

    # the first steps, through the window's own call: they warm up every shape
    got = {"losses": []}
    aug = pipe.augment
    def keep_embedding(module, args, out):
        got.setdefault("embedding", out.cpu())

    emb_hook = encoder.register_forward_hook(keep_embedding)
    for k, (segs, plans) in enumerate(firsts):
        views = aug(segs, plans)
        if k == 0:
            got["views"] = [t.cpu() for t in views]
        pipe.augment = lambda *a, v=views: v
        state, loss = pipe.step(state, segs, plans)
        del pipe.augment
        got["losses"].append(float(loss))
        if k == 0:
            emb_hook.remove()
            beta1 = opt.param_groups[0]["betas"][0]
            # a leaf the optimizer did not update has no first moment: 0
            got["grad"] = {n: float((opt.state[p]["exp_avg"] / (1.0 - beta1)).double().norm())
                           if "exp_avg" in opt.state[p] else 0.0
                           for n, p in converter.named_parameters()}
        del views
    start = weights.seeded_state(converter, ctx.sub_seed("converter"), dev)
    got["change"] = {n: float((p.detach() - start[n]).double().norm())
                     for n, p in converter.named_parameters()}
    del start

    spans = Spans()
    if ctx.trace_on:
        spans.method(pipe, "augment", "mst.augment")
        spans.method(pipe, "_train", "mst.train_step")
    producer = Producer(make, checked)
    steps, done, waited, ends = 0, [], 0.0, []
    try:
        with ctx.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                t = time.perf_counter()
                segs, plans = producer.get()
                waited += time.perf_counter() - t
                state, loss = pipe.step(state, segs, plans)
                ev = torch.cuda.Event() if dev.type == "cuda" else None
                if ev is not None:
                    ev.record()
                done.append(ev)
                if len(done) >= 2 and done[-2] is not None:
                    done[-2].synchronize()  # at most two steps in flight
                steps += 1
                ends.append(time.perf_counter())
    finally:
        producer.close()
        spans.remove()
    gaps = np.diff([t0] + ends)
    print(f"steps_s min {gaps.min():.3f} median {np.median(gaps):.3f} max {gaps.max():.3f} "
          f"waited_for_batches_s {waited:.3f}", file=sys.stderr)
    ctx.counters.update(steps=steps, window_s=ctx.window_s,
                        triplets=tc["batch_size_per_device"] * len(tc["instruments"]))
    metrics = {"converter_step_s": ctx.window_s / steps,
               "peak_mem_gib": ctx.window_peak_bytes / 2**30}
    peak = ctx.peak_bytes()
    del pipe, state, opt, converter, encoder, loss
    torch.cuda.empty_cache()
    return Outcome(metrics, steps, 0, check(ctx, got, firsts, make.chains), peak)


def check(ctx, got, firsts, chains):
    """The program's first steps against the reference's replay of them."""
    from mstbench.reference import nrmse, seeded_weights
    from mstbench.reference.train import replay, worst_leaf_gap

    dev = ctx.device
    states = [seeded_weights(k, ctx.config[k], ctx.sub_seed(k), dev) for k in ("encoder", "converter")]
    ref = replay(ctx.config, *states, firsts, chains, dev)
    if ctx.control is not None:  # the control, or a planted fault, in the program's place
        got = replay(ctx.config, *states, firsts, chains, dev, tf32=ctx.control == "control",
                     fault=None if ctx.control == "control" else ctx.control)
    gmed = float(np.median(list(ref["grad"].values())))
    moved = {n for n, g in ref["grad"].items() if g >= 1e-3 * gmed}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    lim = ctx.limits
    checks = {
        "loss_gap": Check(loss_gap, float(lim["loss_gap"])),
        "grad_gap": Check(worst_leaf_gap(got["grad"], ref["grad"]), float(lim["grad_gap"])),
        "change_gap": Check(worst_leaf_gap(got["change"], ref["change"], moved),
                            float(lim["change_gap"])),
    }
    # shown beside the checks, not compared (PERF.md: no upper reading)
    n = min(got["embedding"].shape[0], ref["embedding"].shape[0])
    info = {"aug_nrmse": max(nrmse(a[:n], b[:n]) for a, b in zip(got["views"][1:], ref["views"][1:])),
            "emb_err": nrmse(got["embedding"][:n], ref["embedding"][:n]),
            "leaves_left_out": len(ref["grad"]) - len(moved),
            "loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])],
            "worst_grad_leaf": max(ref["grad"], key=lambda n: abs(got["grad"][n] - ref["grad"][n])
                                   / max(ref["grad"][n], gmed))}
    print("reading " + " ".join(f"{k} {v!r}" for k, v in info.items()), file=sys.stderr)
    return checks
