"""Devices and process groups for multi-card training and inference.

Counterpart of ``music_mixing_style_transfer_tpu/parallel/mesh.py``. The
JAX package runs one controller over a 1-D ``data`` mesh; the port has two
forms of it:

- inference is one process over a :class:`Mesh`, a list of devices: the
  engine keeps one replica of the weights on each distinct device and sends
  each shard of a batch to its own entry (``infer/pipeline.py``,
  ``infer/seqpar.py``). An entry may repeat (``["cuda:0"] * 4``, or CPU
  entries), so one device stands for several shards, as the JAX tests'
  virtual CPU devices do;
- training is one process per rank in a ``torch.distributed`` process group
  (``torchrun``): :func:`init_process_group_from_env` starts it, and
  :class:`Ranks` tells the trainers who they are. Gradients are averaged
  over the group (DDP, or FSDP2's reduce-scatter), as the reference trains
  (DDP + NCCL, ``training_utils.py:127-172``) and as JAX's ``pmean`` does.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# long enough for a full-width step and a checkpoint write on another rank,
# short enough that a dead rank ends the job instead of hanging it
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D list of devices, one per shard (the JAX mesh's ``data`` axis)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices in first-seen order, each once."""
        return tuple(dict.fromkeys(self.devices))


def create_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default ``cuda:0 .. cuda:k-1``, every card
    present), cut to its first ``n_devices``. Raises when fewer devices are
    there than asked for; a CUDA entry raises without a card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} device(s) are "
                f"available ({[d.type for d in devices]}); for several shards on one device "
                "pass devices=[...] with repeated entries, e.g. ['cuda:0'] * N or ['cpu'] * N"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the training group: world size 1 and no
    group when ``torch.distributed`` is not initialized."""

    rank: int = 0
    world_size: int = 1
    group: Optional[dist.ProcessGroup] = None

    @classmethod
    def current(cls) -> "Ranks":
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
        return cls()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def parallel(self) -> bool:
        return self.world_size > 1

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def rank_device(device="cuda") -> torch.device:
    """``device``, with a bare ``"cuda"`` taken as ``cuda:LOCAL_RANK``
    (``torchrun``'s variable; 0 without it). An explicit index or the CPU
    is kept as it is, so several ranks can share one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def init_process_group_from_env(device="cuda", backend: Optional[str] = None,
                                timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and return this rank's
    device (:func:`rank_device`). Without ``WORLD_SIZE`` in the environment
    (a plain ``python`` run) it starts no group. ``backend`` defaults to NCCL
    on a card and gloo on the CPU; gloo lets two ranks share one card,
    which NCCL refuses. A collective that waits longer than ``timeout_s``
    fails instead of hanging the job."""
    dev = rank_device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s))
    return dev
