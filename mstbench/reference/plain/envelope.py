"""The compressor's envelope follower for the plain reference: no kernel,
exact on every device, and fast enough for whole songs.

The recurrence (the port's ``csrc/envelope.cu`` computes the same one):

    e[t] = max(a_att e[t-1] + (1 - a_att) x_l[t], a_rel e[t-1] + (1 - a_rel) x_l[t])

(``min`` where ``a_att > a_rel``), walked in the signed form ``z = s * e``.
A Python loop over time takes minutes on a whole song, so :func:`exact_scan`
walks it in three vectorised phases: (A) every chunk of ``C`` steps maps
its carry ``z`` to ``max_i(A_i z + B_i)``, ``A_i = a_att^i a_rel^(C-i)``,
and a DP over the chunk's steps gives the intercepts ``B_i``; (B) the
carries across chunks; (C) every chunk re-walked from its carry. Phase B is
serial over chunks, so it runs in windows that all start at once: window 0
from ``env0``, every later one from ``env0``'s carry ``warm`` chunks early. Every step
multiplies a carry's error by ``a_att`` or ``a_rel``, so after
``WARM_TAUS`` time constants of the slower pole the error left is under
``e^-20`` of the start's, below float32's resolution of the envelope.
:func:`serial_scan` is the step-by-step walk it is tested against.
"""
from __future__ import annotations

import math

import torch

CHUNK = 64          # steps a chunk (phase A's DP is C^2 / 2 operations a sample)
WINDOW = 8192       # chunks of phase B's windows
WARM_TAUS = 20.0    # time constants of warm-up before a window's first carry
LANE_BYTES = 16 << 30  # memory a lane block of phase A may take


def _side_chain(xc, threshold, ratio):
    from .compressor import amp_to_db, static_gain_curve

    x_g = amp_to_db(xc)
    return x_g - static_gain_curve(x_g, threshold[:, None], ratio[:, None])


def serial_scan(x_l, a_att, a_rel, env0):
    """The envelope ``e [L, T]`` of ``x_l [L, T]`` from ``env0 [L]``, one
    time step after another."""
    s = torch.where(a_att <= a_rel, 1.0, -1.0).to(x_l.dtype)
    b_att, b_rel = s * (1.0 - a_att), s * (1.0 - a_rel)
    e = torch.empty_like(x_l)
    z = s * env0
    for t in range(x_l.shape[1]):
        z = torch.maximum(a_att * z + b_att * x_l[:, t], a_rel * z + b_rel * x_l[:, t])
        e[:, t] = z
    return s[:, None] * e


def _intercepts(xa, a, c, b_att, b_rel):
    """Phase A: ``B [L, n, C + 1]`` of the chunks ``xa [L, n, C]``."""
    L, n, C = xa.shape
    B = torch.zeros(L, n, C + 1, dtype=xa.dtype, device=xa.device)
    for t in range(C):
        p, q = b_att[:, None] * xa[..., t], b_rel[:, None] * xa[..., t]
        att = a[:, None, None] * B[..., : t + 1] + p[..., None]
        rel = c[:, None, None] * B[..., : t + 1] + q[..., None]
        B[..., 1 : t + 1] = torch.maximum(att[..., :t], rel[..., 1:])
        B[..., t + 1] = att[..., t]
        B[..., 0] = rel[..., 0]
    return B


def _carries(B, a, c, z0, C):
    """Phase B: the carry into each of ``n = B.shape[1] + 1`` chunks."""
    L, nb, P = B.shape
    n = nb + 1
    dt, dev = B.dtype, B.device
    i = torch.arange(P, dtype=torch.float64, device=dev)
    A = a.double()[:, None] ** i * c.double()[:, None] ** (C - i)  # [L, C + 1]
    a_hi = A.to(dt)[:, None, :]
    a_lo = (A - A.to(dt).double()).to(dt)[:, None, :]
    slow = torch.maximum(a, c).double().clamp(max=1.0 - 1e-12)
    warm = int(math.ceil(WARM_TAUS / float((-torch.log(slow)).min()) / C))
    W = WINDOW if n > warm + WINDOW else n
    nwin = -(-n // W)
    first = 0 if nwin == 1 else warm
    # window w's step j reads chunk w*W + j - first of B, through a strided view
    Bp = torch.nn.functional.pad(B, (0, 0, first, nwin * W - nb))
    carry = torch.empty(L, nwin * W, dtype=dt, device=dev)
    idx = torch.arange(W + first)[:, None] + torch.arange(nwin)[None, :] * W - first
    live = (idx >= 0) & (idx < nb)  # [step, window]
    all_live = live.all(1).tolist()
    live = live.to(dev)
    # every window starts from env0's carry: exact where its warm-up reaches
    # back to chunk 0, a guess that the warm-up forgets elsewhere
    z = z0[:, None].expand(L, nwin).clone()
    for j in range(W + first):
        if j >= first:
            carry[:, j - first :: W] = z
        t = torch.addcmul(Bp[:, j :: W][:, :nwin], a_lo, z[..., None])
        nz = torch.addcmul(t, a_hi, z[..., None]).amax(-1)
        z = nz if all_live[j] else torch.where(live[j][None, :], nz, z)
    return carry[:, :n]


def exact_scan(x_l, a_att, a_rel, env0, chunk: int = CHUNK):
    """The envelope of :func:`serial_scan` (same arguments and result), by
    the three phases, lane block by lane block."""
    L, T = x_l.shape
    C = int(chunk)
    if T <= 4 * C:
        return serial_scan(x_l, a_att, a_rel, env0)
    dt = x_l.dtype
    n = -(-T // C)
    per_lane = n * (C + 1) * x_l.element_size() * 3
    block = max(1, LANE_BYTES // per_lane)
    out = torch.empty_like(x_l)
    for l0 in range(0, L, block):
        sl = slice(l0, min(L, l0 + block))
        a, c = a_att[sl].to(dt), a_rel[sl].to(dt)
        s = torch.where(a <= c, 1.0, -1.0).to(dt)
        b_att, b_rel = s * (1.0 - a), s * (1.0 - c)
        xl = torch.nn.functional.pad(x_l[sl], (0, n * C - T)).reshape(-1, n, C)
        B = _intercepts(xl[:, : n - 1], a, c, b_att, b_rel)
        zz = _carries(B, a, c, s * env0[sl].to(dt), C)
        del B
        e = torch.empty_like(xl)
        for t in range(C):
            zz = torch.maximum(a[:, None] * zz + b_att[:, None] * xl[..., t],
                               c[:, None] * zz + b_rel[:, None] * xl[..., t])
            e[..., t] = zz
        out[sl] = (s[:, None] * e.reshape(e.shape[0], -1))[:, :T]
    return out


def chunked_scan(x_l, a_att, a_rel, env0, chunk):
    """The compander's walk (the chunk length is the reference's own)."""
    return exact_scan(x_l, a_att, a_rel, env0)


def compressor_envelope(x, threshold, ratio, a_att, a_rel, env0, rows=None):
    """``x [L, T]`` (or ``[R, T]`` read through ``rows [L]``) with per-lane
    parameters ``[L]`` -> ``(y [L, T], env_out [L])``."""
    if rows is not None:
        x = x.index_select(0, rows)
    params = [p.to(torch.float32) for p in (threshold, ratio, a_att, a_rel, env0)]
    threshold, ratio, a_att, a_rel, env0 = params
    if x.shape[1] == 0:
        return x.clone(), env0.clone()
    e = exact_scan(_side_chain(x, threshold, ratio), a_att, a_rel, env0)
    return x * torch.pow(10.0, -e / 20.0), e[:, -1]
