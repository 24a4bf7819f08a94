"""Compressor envelope follower: dB side chain, one-pole attack/release
smoothing carried across calls, and gain, in one pass over device memory.

Counterpart of ``music_mixing_style_transfer_tpu/ops/pallas/envelope.py``.
The kernel is hand-written CUDA for Hopper, ``csrc/envelope.cu``: a
time-parallel scan (chunk summaries, a carry scan over them, a re-walk of
each chunk; its header gives the algebra and what bounds it).
``envelope_reference`` is its plain PyTorch version, and
``envelope_chunked_reference`` a plain model of the kernel's three phases,
for the tests. The wrapper ``compressor_envelope`` takes the plain version
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``serial_scan`` and ``chunked_scan`` are the two walks with the side chain
given, for the compander (``ops/compressor.py:compand``), whose linear-domain
envelope K2 does not compute.

``compressor_envelope.launches`` counts kernel launches (and nothing else),
so a run can show that its path went through the kernel. While tracing,
the counter ``ops.cuda.envelope`` records ``(L, T, R)`` of each envelope
computed (``R`` the rows of ``x`` that ``rows`` reads, else ``None``): on
the card one record a launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import profiling

REFERENCE_CHUNK = 256  # time steps of the plain version's side chain at a time


def _side_chain(xc, threshold, ratio):
    from ..compressor import amp_to_db, static_gain_curve

    x_g = amp_to_db(xc)
    return x_g - static_gain_curve(x_g, threshold[:, None], ratio[:, None])


def walk(p_att, p_rel, a_att, a_rel, z):
    """The serial walk over one time-major chunk in the signed form:
    ``p_att``, ``p_rel`` ``[C, L]`` hold ``s * (1 - a) * x_l`` of the attack
    and release candidates, ``z`` ``[L]`` the carried ``s * e``. Step t
    writes ``max(a_att * z + p_att[t], a_rel * z + p_rel[t])`` over
    ``p_att[t]``, the order of the JAX package's ``_envelope_scan``
    (``a * y + (1 - a) * x``). Returns the last ``z``."""
    for t in range(p_att.shape[0]):
        z = torch.maximum(
            torch.addcmul(p_att[t], a_att, z), torch.addcmul(p_rel[t], a_rel, z), out=p_att[t]
        )
    return z


def serial_scan(x_l, a_att, a_rel, env0):
    """The envelope ``e [L, T]`` of ``x_l [L, T]`` (the side chain, given)
    from ``env0 [L]``: ``e[t] = max`` (``min`` where ``a_att > a_rel``) of
    ``a_att e[t-1] + (1 - a_att) x_l[t]`` and ``a_rel e[t-1] + (1 - a_rel)
    x_l[t]``, walked serially in chunks of ``REFERENCE_CHUNK`` steps."""
    s = torch.where(a_att <= a_rel, 1.0, -1.0).to(x_l.dtype)
    b_att, b_rel = s * (1.0 - a_att), s * (1.0 - a_rel)
    e = torch.empty_like(x_l)
    z = s * env0
    for t0 in range(0, x_l.shape[1], REFERENCE_CHUNK):
        xc = x_l[:, t0 : t0 + REFERENCE_CHUNK].t().contiguous()  # can be x_l's own memory
        p_att = xc * b_att
        z = walk(p_att, xc * b_rel, a_att, a_rel, z)
        e[:, t0 : t0 + REFERENCE_CHUNK] = s[:, None] * p_att.t()
    return e


def envelope_reference(x, threshold, ratio, a_att, a_rel, env0, rows=None):
    """Plain version: ``x [L, T]`` float32 with per-lane ``threshold``,
    ``ratio``, ``a_att``, ``a_rel`` and carried envelope ``env0`` (each
    ``[L]``) -> ``(y [L, T], env_out [L])``. With ``rows`` ([L] int64),
    lane l reads row ``rows[l]`` of ``x [R, T]``.

    The side chain is ``compressor_process``'s (``x_g - static_gain_curve``);
    then a Python loop over time on ``[L]`` vectors, the counterpart of the
    JAX package's ``_envelope_scan``. The loop runs in the signed form
    ``z = s * e`` with ``s = +1`` where ``a_att <= a_rel`` (max of the two
    candidates) and ``-1`` elsewhere (min): ``min(a, b) = -max(-a, -b)`` and
    a sign flip is exact, so the result is the same and each step is three
    operations. Time goes in chunks of ``REFERENCE_CHUNK`` samples, so the
    elementwise side chain and gain work on tensors that stay in cache (every
    operation is per sample, so the chunking changes no value); time-major
    copies keep each step's ``[L]`` rows contiguous, and the walk writes each
    step's envelope over the row it has just read."""
    if rows is not None:
        x = x.index_select(0, rows)
    s = torch.where(a_att <= a_rel, 1.0, -1.0).to(x.dtype)
    b_att, b_rel = s * (1.0 - a_att), s * (1.0 - a_rel)
    y = torch.empty_like(x)
    z = s * env0
    for t0 in range(0, x.shape[1], REFERENCE_CHUNK):
        xc = x[:, t0 : t0 + REFERENCE_CHUNK]
        x_l = _side_chain(xc, threshold, ratio).t().contiguous()
        p_att = x_l * b_att  # [chunk, L]: s * (1 - a_att) * x_l
        z = walk(p_att, x_l.mul_(b_rel), a_att, a_rel, z)
        y_l = s[:, None] * p_att.t()
        y[:, t0 : t0 + REFERENCE_CHUNK] = xc * torch.pow(10.0, -y_l / 20.0)
    return y, s * z


def chunked_scan(x_l, a_att, a_rel, env0, chunk):
    """The envelope of :func:`serial_scan` (same arguments, the side chain
    ``x_l [L, T]`` given) by the kernel's three phases, in the dtype of
    ``x_l`` and on its device: C + T/C + C small steps over whole tensors
    instead of T. In the signed form ``z = s*e`` a chunk of ``chunk`` steps
    maps its carry to ``max_i(A_i*z + B_i)`` with ``A_i = a_att^i *
    a_rel^(chunk-i)``: (A) the intercepts ``B_i`` of every full chunk at
    once, by the DP over its steps; (B) the carry across the chunks, one
    evaluation each; (C) every chunk re-walked from its carry. The slopes
    are taken in float64 and split into hi + lo parts of ``x_l``'s dtype,
    as the kernel does. A lane's last chunk, full or not, is only walked,
    as in the kernel."""
    L, T = x_l.shape
    C = int(chunk)
    dt, dev = x_l.dtype, x_l.device
    s = torch.where(a_att <= a_rel, 1.0, -1.0).to(dt)
    a, c = a_att.to(dt), a_rel.to(dt)
    b_att, b_rel = s * (1.0 - a), s * (1.0 - c)
    n_chunks = -(-T // C)
    x_l = torch.nn.functional.pad(x_l, (0, n_chunks * C - T)).reshape(L, n_chunks, C)
    # (A) intercepts of every chunk but the last: B [L, n_chunks - 1, C + 1]
    xa = x_l[:, : n_chunks - 1]
    B = torch.zeros(L, n_chunks - 1, C + 1, dtype=dt, device=dev)
    for t in range(C):
        p, q = b_att[:, None] * xa[..., t], b_rel[:, None] * xa[..., t]
        att = a[:, None, None] * B[..., :t + 1] + p[..., None]
        rel = c[:, None, None] * B[..., :t + 1] + q[..., None]
        B[..., 1 : t + 1] = torch.maximum(att[..., :t], rel[..., 1:])
        B[..., t + 1] = att[..., t]
        B[..., 0] = rel[..., 0]
    # (B) the carry into every chunk
    i = torch.arange(C + 1, dtype=torch.float64, device=dev)
    A = a.double()[:, None] ** i * c.double()[:, None] ** (C - i)  # [L, C + 1]
    a_hi = A.to(dt)
    a_lo = (A - a_hi.double()).to(dt)
    z = s * env0.to(dt)
    carry = torch.empty(L, n_chunks, dtype=dt, device=dev)
    for j in range(n_chunks):
        carry[:, j] = z
        if j + 1 < n_chunks:
            z = (a_hi * z[:, None] + (a_lo * z[:, None] + B[:, j])).amax(-1)
    # (C) re-walk every chunk from its carry
    zz = carry
    e = torch.empty_like(x_l)
    for t in range(C):
        zz = torch.maximum(a[:, None] * zz + b_att[:, None] * x_l[..., t],
                           c[:, None] * zz + b_rel[:, None] * x_l[..., t])
        e[..., t] = zz
    return (s[:, None] * e.reshape(L, -1))[:, :T]


def envelope_chunked_reference(x, threshold, ratio, a_att, a_rel, env0, chunk, rows=None):
    """Plain model of the kernel's three phases (:func:`chunked_scan` over
    the dB side chain), in the dtype of ``x``, same arguments and result as
    :func:`envelope_reference`."""
    if rows is not None:
        x = x.index_select(0, rows)
    e = chunked_scan(_side_chain(x, threshold, ratio), a_att, a_rel, env0, chunk)
    return x * torch.pow(10.0, -e / 20.0), e[:, -1]


def _bind(lib):
    """``lib`` (a build of ``csrc/envelope.cu``) with its C signatures set."""
    fn = lib.compressor_envelope_f32
    # x, rows, R; threshold, ratio, a_att, a_rel, env_in, y, env_out, status;
    # status words, L, T, stream
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    words = lib.compressor_envelope_scratch_words
    words.argtypes = [ctypes.c_longlong] * 2
    words.restype = ctypes.c_longlong
    lib.compressor_envelope_chunk.argtypes = [ctypes.c_longlong]
    lib.compressor_envelope_chunk.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load

    return _bind(load("envelope"))


def kernel_chunk(n_lanes: int) -> int:
    """The chunk length the kernel takes for ``n_lanes`` lanes (16 from 128
    lanes on, 64 below; ``csrc/envelope.cu:chunk_for``). Builds the kernel."""
    return _library().compressor_envelope_chunk(n_lanes)


def compressor_envelope(x, threshold, ratio, a_att, a_rel, env0, rows=None):
    """Envelope follower over ``x [L, T]`` (float32, contiguous) with per-lane
    parameters ``[L]`` (cast to float32); returns ``(y [L, T], env_out [L])``,
    the gain-applied signal and the envelope after its last sample, to carry
    into the next slab. With ``rows`` ([L] int64, on x's device), lane l reads
    row ``rows[l]`` of ``x [R, T]``, so lanes that share a signal read it once.
    The range of ``rows`` is not checked on the card (that would cost a host
    sync): an index outside x traps in the kernel, which leaves the process's
    CUDA context unusable; on the CPU it raises ``IndexError``."""
    if x.dtype != torch.float32:
        raise ValueError(f"compressor_envelope: x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"compressor_envelope: x must be [L, T], got {tuple(x.shape)}")
    L, T = x.shape
    if rows is not None:
        if rows.dtype != torch.int64 or rows.dim() != 1 or rows.device != x.device:
            raise ValueError(
                f"compressor_envelope: rows must be int64 [L] on {x.device}, got "
                f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
            )
        L = rows.shape[0]
    params = []
    for name, a in (
        ("threshold", threshold), ("ratio", ratio), ("a_att", a_att), ("a_rel", a_rel),
        ("env0", env0),
    ):
        if tuple(a.shape) != (L,) or a.device != x.device:
            raise ValueError(
                f"compressor_envelope: {name} must be ({L},) on {x.device}, "
                f"got {tuple(a.shape)} on {a.device}"
            )
        params.append(a.to(torch.float32).contiguous())
    shape = (L, T, None if rows is None else x.shape[0])
    if x.device.type == "cpu":
        profiling.count("ops.cuda.envelope", shape)
        return envelope_reference(x, *params, rows=rows)
    if x.device.type != "cuda":
        raise ValueError(f"compressor_envelope: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("compressor_envelope: x must be contiguous (row-major [L, T])")
    y = torch.empty(L, T, dtype=torch.float32, device=x.device)
    if L == 0 or T == 0 or x.shape[0] == 0:  # nothing to walk: the envelope carries through
        return y, params[-1].clone()
    lib = _library()
    # the block ticket and the carries handed between windows
    words = lib.compressor_envelope_scratch_words(L, T)
    status = torch.zeros(words, dtype=torch.int64, device=x.device)
    env_out = torch.empty(L, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.compressor_envelope_f32(
            x.data_ptr(), None if rows is None else rows.contiguous().data_ptr(), x.shape[0],
            *(a.data_ptr() for a in params), y.data_ptr(), env_out.data_ptr(),
            status.data_ptr(), status.numel(), L, T,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"compressor_envelope: kernel launch failed with CUDA error {err}")
    compressor_envelope.launches += 1
    profiling.count("ops.cuda.envelope", shape)
    return y, env_out


compressor_envelope.launches = 0
