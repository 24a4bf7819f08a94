"""Device selection and float32 precision for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --inference_device cpu) to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_float32():
    """TF32 off in cuDNN convolutions and matmuls inside the block, restored
    afterwards. The flags are process-wide: callers in several threads must
    not overlap (the server admits one computing request at a time)."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
