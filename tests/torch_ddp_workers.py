"""Workers of the port's multi-process tests (``tests/test_torch_ddp*.py``).

They run in spawned children, one per rank of a gloo process group, and
import only torch, numpy and the port: never JAX (the JAX oracles are
computed in the parent). :func:`run_ranks` starts the children, joins
them with a timeout, kills what is left and fails, so a hung collective
costs a test its seconds, not the suite its time limit.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 60  # a collective that waits longer fails its rank
INSTRUMENTS = ("drums", "bass")  # the training loops' instruments in train_runs


def run_ranks(target, world: int, tmp_dir: str, args=(), timeout: float = 120.0,
              group: bool = True) -> list:
    """``target(rank, world, *args)`` in ``world`` spawned processes (one
    thread each), under a gloo group over a ``FileStore`` in ``tmp_dir``
    when ``group``; their results in rank order. A child that raises, dies
    or outlives ``timeout`` fails the call (the others are killed)."""
    return Ranks(target, world, tmp_dir, args, group).wait(timeout)


class Ranks:
    """The spawned processes of :func:`run_ranks`, started; ``wait``
    collects them, so that two groups can run at once."""

    def __init__(self, target, world: int, tmp_dir: str, args=(), group: bool = True):
        ctx = multiprocessing.get_context("spawn")
        tag = uuid.uuid4().hex
        store = os.path.join(tmp_dir, f"store-{tag}") if group else None
        self.world = world
        self.outs = [os.path.join(tmp_dir, f"result-{tag}-{r}.pt") for r in range(world)]
        self.procs = [ctx.Process(target=_entry, args=(target, r, world, store, args, self.outs[r]),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def wait(self, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if alive:
            raise AssertionError(f"ranks {alive} of {self.world} still running after {timeout} s: "
                                 "killed")
        results = []
        for r, (p, out) in enumerate(zip(self.procs, self.outs)):
            if not os.path.exists(out):
                raise AssertionError(f"rank {r} exited with code {p.exitcode} and no result")
            res = torch.load(out, weights_only=False)
            if "error" in res:
                raise AssertionError(f"rank {r} of {self.world} failed:\n{res['error']}")
            results.append(res["ok"])
        return results


def _entry(target, rank, world, store, args, out):
    torch.set_num_threads(1)
    try:
        if store is not None:
            dist.init_process_group(
                "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            )
        res = {"ok": target(rank, world, *args)}
    except BaseException:  # reported to the parent, which fails the test with it
        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(res, out)


def _block(a, rank, world):
    n = len(a) // world
    return a[rank * n:(rank + 1) * n]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# NT-Xent
# ---------------------------------------------------------------------------
def nt_xent_case(rank, world, zi, zj, temperature):
    """This rank's block of ``zi, zj [N, D]`` through the gathered NT-Xent:
    the loss and the gradients that reach this rank's rows."""
    from music_mixing_style_transfer_tpu_torch.losses import nt_xent_loss

    a = torch.from_numpy(_block(zi, rank, world)).requires_grad_(True)
    b = torch.from_numpy(_block(zj, rank, world)).requires_grad_(True)
    loss = nt_xent_loss(a, b, temperature, dist.group.WORLD)
    loss.backward()
    return {"loss": float(loss), "grad_i": _np(a.grad), "grad_j": _np(b.grad)}


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
def _encoder(cfg_fields, state_dict):
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder

    model = FXencoder(FXencoderConfig(**cfg_fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return model.train()


def _state(model, opt):
    from music_mixing_style_transfer_tpu_torch.train.state import TrainState

    return TrainState(step=0, model=model, optimizer=opt)


def _after(model) -> dict:
    """Parameters (whole, also when FSDP-sharded) and buffers."""
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        out[name] = _np(t)
    return out


def contrastive_steps(rank, world, cfg_fields, state_dict, a, b, lr, plain_cfg_fields):
    """From the same weights, on this rank's block of the items of ``a, b
    [n_inst, B, 2, T]``: one SGD step of the DDP step and of the FSDP step
    (losses, parameters and buffers after; the DDP step's averaged
    gradients); one Adam step of the FSDP step (each rank's share of the
    parameters and of Adam's moments); and one Adam step of the DDP step on
    ``plain_cfg_fields`` (no BN) with its averaged gradients, before Adam."""
    from music_mixing_style_transfer_tpu_torch.train.contrastive import (
        make_contrastive_train_step,
        make_fsdp_contrastive_step,
        shard_train_state,
    )
    from music_mixing_style_transfer_tpu_torch.train.state import make_optimizer

    group = dist.group.WORLD
    la = torch.from_numpy(np.ascontiguousarray(a[:, _slice(a.shape[1], rank, world)]))
    lb = torch.from_numpy(np.ascontiguousarray(b[:, _slice(b.shape[1], rank, world)]))
    out = {}

    model = _encoder(cfg_fields, state_dict)
    state, loss = make_contrastive_train_step(group=group)(
        _state(model, torch.optim.SGD(model.parameters(), lr=lr)), la, lb)
    out["ddp"] = {"loss": float(loss), "after": _after(model),
                  "grads": {n: _np(p.grad) for n, p in model.named_parameters()}}

    model = _encoder(cfg_fields, state_dict)
    state = shard_train_state(_state(model, torch.optim.SGD(model.parameters(), lr=lr)), group)
    state, loss = make_fsdp_contrastive_step(group)(state, la, lb)
    out["fsdp"] = {"loss": float(loss), "after": _after(model)}

    model = _encoder(cfg_fields, state_dict)
    state = shard_train_state(_state(model, make_optimizer(model.parameters())), group)
    state, _ = make_fsdp_contrastive_step(group)(state, la, lb)
    out["fsdp_shares"] = {
        n: (p.to_local().numel(), p.numel(), state.optimizer.state[p]["exp_avg"].to_local().numel(),
            state.optimizer.state[p]["exp_avg_sq"].to_local().numel(), p.shape[0])
        for n, p in model.named_parameters()
    }

    model = _encoder(plain_cfg_fields, _plain_weights(plain_cfg_fields))
    state, loss = make_contrastive_train_step(group=group)(
        _state(model, make_optimizer(model.parameters())), la, lb)
    out["plain_adam"] = {"loss": float(loss),
                         "grads": {n: _np(p.grad) for n, p in model.named_parameters()}}
    return out


def _slice(n, rank, world):
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def _plain_weights(cfg_fields) -> dict:
    """Seeded weights of the encoder without BN (every rank and the parent
    make the same ones)."""
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init

    model = fast_init(FXencoder(FXencoderConfig(**cfg_fields)), seed=3)
    return {k: _np(v) for k, v in model.state_dict().items()}


def converter_step(rank, world, enc_fields, enc_sd, conv_fields, conv_sd, a1, a2, b2, lr):
    """One SGD step of the data-parallel converter step on this rank's
    block of the triplets ``[B, 2, T]``: the loss (mean over the ranks),
    the parameters and the buffers after it."""
    from music_mixing_style_transfer_tpu_torch.config import TCNConfig
    from music_mixing_style_transfer_tpu_torch.models import MixFXcloner
    from music_mixing_style_transfer_tpu_torch.train.converter import frozen, make_converter_train_step

    enc = frozen(_encoder(enc_fields, enc_sd))
    model = MixFXcloner(TCNConfig(**conv_fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in conv_sd.items()})
    model.train()
    block = [torch.from_numpy(np.ascontiguousarray(_block(v, rank, world))) for v in (a1, a2, b2)]
    state, loss = make_converter_train_step(group=dist.group.WORLD)(
        _state(model, torch.optim.SGD(model.parameters(), lr=lr)), enc, *block)
    return {"loss": float(loss), "after": _after(model)}


# ---------------------------------------------------------------------------
# Training loops
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def batch_linear_converter():
    """The converter's two batch-level nonlinearities replaced by
    batch-linear stand-ins, so that the mean of per-rank losses is the
    one-process loss: BN's training mode by its eval affine (the running
    statistics, left as they are; the port's twin of JAX's
    ``norm="none"``, which the TCN has no option for), and the RMS loss,
    the product of two batch means (reference ``loss.py:77-93``), by the
    batch mean of its per-row terms. With the originals, W ranks give the
    mean of per-rank losses (JAX's ``pmean``, the reference's DDP), which is
    not the one-process loss of the global batch."""
    from music_mixing_style_transfer_tpu_torch.models import blocks
    from music_mixing_style_transfer_tpu_torch.train import converter

    train_forward, rms_loss = blocks.BatchNorm1d.forward, converter.rms_loss

    def affine(self, x):
        s, t = self.fold()
        return x * s.to(x.dtype)[:, None] + t.to(x.dtype)[:, None]

    def rms_rows(est, tgt, weight_factor=100.0):
        e, t = est.reshape(-1, est.shape[-1]), tgt.reshape(-1, tgt.shape[-1])
        d = torch.sqrt(torch.mean(e**2, dim=-1)) - torch.sqrt(torch.mean(t**2, dim=-1))
        weight = torch.clamp(torch.abs(d), min=1.0 / weight_factor) * weight_factor
        return torch.mean(weight**1.5 * d**2)

    blocks.BatchNorm1d.forward, converter.rms_loss = affine, rms_rows
    try:
        yield
    finally:
        blocks.BatchNorm1d.forward, converter.rms_loss = train_forward, rms_loss


@contextlib.contextmanager
def recording():
    """Record the training items each dataset reads (``(epoch_seed, idx)``
    of its ``train`` mode) and each checkpoint write."""
    from music_mixing_style_transfer_tpu_torch.data import datasets
    from music_mixing_style_transfer_tpu_torch.train.checkpoint import CheckpointManager

    rec = {"items": [], "saves": []}
    rng_for, save = datasets._FXDataset._rng_for, CheckpointManager.save

    def rng_spy(self, idx, epoch_seed):
        if self.mode == "train":
            rec["items"].append((epoch_seed, idx))
        return rng_for(self, idx, epoch_seed)

    def save_spy(self, step, state, extra=None):
        rec["saves"].append(step)
        return save(self, step, state, extra)

    datasets._FXDataset._rng_for, CheckpointManager.save = rng_spy, save_spy
    try:
        yield rec
    finally:
        datasets._FXDataset._rng_for, CheckpointManager.save = rng_for, save


def _records(out_dir):
    import json

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_runs(rank, world, corpus, out_root, enc_fields, plain_fields, conv_fields, seg):
    """Both trainers on ``corpus`` (this rank's device: the CPU), each run's
    records (rank 0's), items read, checkpoint writes and final state:
    ``train_fxencoder`` (``plain_fields``, no BN) for 1 epoch of 2 steps,
    then resumed to a second; ``train_converter`` (batch-linear, see
    :func:`batch_linear_converter`)
    against an encoder of ``enc_fields`` for 1 epoch of 2 steps; and the
    errors that the world size raises (``rank`` 0 of a group only)."""
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig, TCNConfig, TrainConfig
    from music_mixing_style_transfer_tpu_torch.models import FXencoder
    from music_mixing_style_transfer_tpu_torch.models.fast_init import fast_init
    from music_mixing_style_transfer_tpu_torch.train.loop import train_converter, train_fxencoder

    tag = f"w{world}"
    tcfg = TrainConfig(segment_length=seg)
    # two of the four instruments: the CPU walks the FX chains' scans, the bulk of the time
    kw = dict(steps_per_epoch=2, batch_items=2, device="cpu", fused=True, instruments=INSTRUMENTS)
    out = {}
    enc_dir = os.path.join(out_root, f"enc_{tag}")
    with recording() as rec:
        train_fxencoder(corpus, enc_dir, FXencoderConfig(**plain_fields), tcfg, epochs=1, **kw)
        state = train_fxencoder(corpus, enc_dir, FXencoderConfig(**plain_fields), tcfg, epochs=2, **kw)
    out["fxencoder"] = {"items": rec["items"], "saves": rec["saves"], "step": state.step,
                        "records": _records(enc_dir) if rank == 0 else None,
                        "after": _after(state.model)}

    encoder = fast_init(FXencoder(FXencoderConfig(**enc_fields)), seed=5)
    conv_dir = os.path.join(out_root, f"conv_{tag}")
    with recording() as rec, batch_linear_converter():
        state = train_converter(corpus, conv_dir, encoder, TCNConfig(**conv_fields), tcfg, epochs=1,
                                **kw)
    out["converter"] = {"items": rec["items"], "saves": rec["saves"], "step": state.step,
                        "records": _records(conv_dir) if rank == 0 else None,
                        "after": _after(state.model)}

    if world > 1:
        out["errors"] = _errors(corpus, out_root, plain_fields, tcfg)
    return out


def _errors(corpus, out_root, plain_fields, tcfg):
    """The messages of what a 2-rank group refuses: a batch of 3 items
    (the pipeline's split and ``train_fxencoder``), and ``use_mesh=False``
    (the CLI's ``--no_mesh``)."""
    from music_mixing_style_transfer_tpu_torch.config import FXencoderConfig
    from music_mixing_style_transfer_tpu_torch.train import cli
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedContrastivePipeline
    from music_mixing_style_transfer_tpu_torch.train.loop import train_fxencoder

    msgs = {}
    pipe = FusedContrastivePipeline(device="cpu", group=dist.group.WORLD)
    for name, fn in (
        ("shard", lambda: pipe.shard(3, 6)),
        ("train_fxencoder", lambda: train_fxencoder(
            corpus, os.path.join(out_root, "odd"), FXencoderConfig(**plain_fields), tcfg, epochs=1,
            steps_per_epoch=1, batch_items=3, device="cpu")),
        ("no_mesh", lambda: cli.main(["fxencoder", "--data_dir", corpus, "--out_dir",
                                      os.path.join(out_root, "no_mesh"), "--device", "cpu",
                                      "--no_mesh"])),
    ):
        try:
            fn()
        except ValueError as e:
            msgs[name] = str(e)
    return msgs


def several(rank, world, calls):
    """``{name: fn(rank, world, *args)}`` for each ``(name, fn_name,
    args)`` of ``calls``, in one process group."""
    return {name: globals()[fn](rank, world, *args) for name, fn, args in calls}


def card_contrastive_step(rank, world, cfg_fields, a, b):
    """The data-parallel contrastive step with both ranks on ``cuda:0``
    (gloo carries CUDA tensors): the loss and the averaged gradients."""
    from music_mixing_style_transfer_tpu_torch.train.contrastive import make_contrastive_train_step
    from music_mixing_style_transfer_tpu_torch.train.state import make_optimizer

    torch.cuda.set_device(0)
    model = _encoder(cfg_fields, _plain_weights(cfg_fields)).cuda()
    la, lb = (torch.from_numpy(np.ascontiguousarray(v[:, _slice(v.shape[1], rank, world)])).cuda()
              for v in (a, b))
    _, loss = make_contrastive_train_step(group=dist.group.WORLD)(
        _state(model, make_optimizer(model.parameters())), la, lb)
    return {"loss": float(loss), "grads": {n: _np(p.grad) for n, p in model.named_parameters()},
            "device": str(next(model.parameters()).device)}
