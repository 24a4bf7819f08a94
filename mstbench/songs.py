"""Four-stem songs made on the device from a seed.

The instruments are those of the port's ``tools/synth_corpus.py`` (drums:
kick, snare and hat patterns; bass: a scale line of saw-ish notes; other:
chord pads with arpeggiated attacks; vocals: vibrato formant phrases, a
quarter of them rests), each note placed with a constant-power pan, and the
four stems peak-normalized together to 0.7. Here every event of a stem is
drawn and rendered at once from a ``torch.Generator`` on the device, so a
six-minute song takes milliseconds instead of seconds of host loops; the
numbers differ from the tool's, whose numpy generator draws one event at a
time.
"""
from __future__ import annotations

import math

import torch

SR = 44100
SCALE = (0, 2, 3, 5, 7, 8, 10)  # natural minor
INSTRUMENTS = ("drums", "bass", "other", "vocals")


def _note_hz(root, degree: torch.Tensor) -> torch.Tensor:
    octave = torch.div(degree, len(SCALE), rounding_mode="floor")
    scale = torch.tensor(SCALE, dtype=torch.float64, device=degree.device)
    return root * 2.0 ** (octave.double() + scale[degree - octave * len(SCALE)] / 12.0)


def _env(n: int, attack: float, decay: float, dev) -> torch.Tensor:
    t = torch.arange(n, dtype=torch.float64, device=dev) / SR
    a = torch.clamp(t / max(attack, 1e-4), max=1.0)
    return a * torch.exp(-torch.clamp(t - attack, min=0.0) / max(decay, 1e-3))


def _place(track: torch.Tensor, starts: torch.Tensor, bursts: torch.Tensor, pan) -> None:
    """Add mono ``bursts [E, Lb]`` at ``starts [E]`` into ``track [2, n]``
    with constant-power pans (a number or ``[E]``)."""
    n, (E, Lb) = track.shape[1], bursts.shape
    pan = torch.as_tensor(pan, dtype=torch.float64, device=track.device).expand(E)
    starts, order = torch.sort(starts, stable=True)
    bursts, pan = bursts[order], pan[order, None]
    # events e and e + k never overlap: each add below meets every sample
    # once, so the sum's order (and the song, to the bit) follows the seed
    k = 1
    while k < E and int((starts[k:] - starts[:-k]).min()) < Lb:
        k += 1
    idx = starts[:, None] + torch.arange(Lb, device=track.device)
    for c, gain in enumerate((torch.cos(pan * math.pi / 2), torch.sin(pan * math.pi / 2))):
        part = (bursts * gain).float()
        for g in range(k):
            keep = idx[g::k] < n
            track[c].index_add_(0, idx[g::k][keep], part[g::k][keep])


def _drums(g, n: int, beat: int, dev) -> torch.Tensor:
    out = torch.zeros(2, n, device=dev)
    pattern = torch.randint(0, 2, (16,), generator=g, device=dev).bool()
    pattern[0] = True
    bars = torch.arange(0, n, 4 * beat, device=dev)
    steps = torch.arange(16, device=dev)
    pos = bars[:, None] + steps[None, :] * beat // 4  # [bars, 16]
    kick_len, snare_len, hat_len = int(0.12 * SR), int(0.15 * SR), int(0.05 * SR)
    t = torch.arange(kick_len, dtype=torch.float64, device=dev) / SR
    kick = torch.sin(2 * math.pi * (45 + 75 * torch.exp(-t * 30)) * t) * _env(kick_len, 0.002, 0.05, dev)
    kicks = pos[:, (steps % 4 == 0) & pattern].reshape(-1)
    _place(out, kicks, 0.8 * kick.expand(kicks.numel(), -1), 0.5)
    snares = pos[:, steps % 8 == 4].reshape(-1)
    noise = torch.randn(snares.numel(), snare_len, generator=g, device=dev, dtype=torch.float64)
    body = torch.sin(2 * math.pi * 180 * torch.arange(snare_len, device=dev, dtype=torch.float64) / SR)
    _place(out, snares, 0.45 * (0.6 * noise + 0.4 * body) * _env(snare_len, 0.001, 0.04, dev), 0.5)
    hat_steps = steps[steps % 2 == 0]
    hats = pos[:, hat_steps].reshape(-1)
    noise = torch.randn(hats.numel(), hat_len, generator=g, device=dev, dtype=torch.float64)
    noise = noise - torch.nn.functional.pad(noise[:, :-1], (1, 0)) * 0.95  # HF tilt
    pans = torch.where((hat_steps // 2) % 2 == 1, 0.3, 0.7).double().repeat(pos.shape[0])
    _place(out, hats, 0.18 * noise * _env(hat_len, 0.0005, 0.012, dev), pans)
    return out


def _bass(g, n: int, beat: int, root: float, dev) -> torch.Tensor:
    out = torch.zeros(2, n, device=dev)
    degrees = torch.randint(-3, 5, (64,), generator=g, device=dev)
    starts = torch.arange(0, n, beat, device=dev)
    hz = _note_hz(root / 2, degrees[torch.arange(starts.numel(), device=dev) % 64])
    t = torch.arange(beat, dtype=torch.float64, device=dev) / SR
    wave = sum(torch.sin(2 * math.pi * hz[:, None] * k * t) / k for k in range(1, 6))
    _place(out, starts, 0.35 * wave * _env(beat, 0.01, 0.4, dev), 0.5)
    return out


def _other(g, n: int, beat: int, root: float, dev) -> torch.Tensor:
    out = torch.zeros(2, n, device=dev)
    chord_len = 4 * beat
    t = torch.arange(chord_len, dtype=torch.float64, device=dev) / SR
    prog = torch.randint(0, 7, (16,), generator=g, device=dev)
    starts = torch.arange(0, n, chord_len, device=dev)
    E = starts.numel()
    base = prog[torch.arange(E, device=dev) % 16]
    pad = torch.zeros(E, chord_len, dtype=torch.float64, device=dev)
    arp_t = t[: beat * 2]
    arp_env = _env(beat * 2, 0.005, 0.2, dev)
    for j, step in enumerate((0, 2, 4)):  # triad
        hz = _note_hz(root, base + step)
        detune = 1.0 + 0.001 * torch.randn(E, generator=g, device=dev, dtype=torch.float64)
        phase = 2 * math.pi * torch.rand(E, generator=g, device=dev, dtype=torch.float64)
        pad += torch.sin(2 * math.pi * (hz * detune)[:, None] * t + phase[:, None])
        pans = 0.2 + 0.6 * torch.rand(E, generator=g, device=dev, dtype=torch.float64)
        arp = 0.10 * torch.sin(2 * math.pi * hz[:, None] * 2 * arp_t) * arp_env
        _place(out, starts + j * beat // 2, arp, pans)
    _place(out, starts, 0.12 * pad * _env(chord_len, 0.3, 3.0, dev), 0.5)
    return out


def _vocals(g, n: int, beat: int, root: float, dev) -> torch.Tensor:
    out = torch.zeros(2, n, device=dev)
    phrase_len = 2 * beat
    t = torch.arange(phrase_len, dtype=torch.float64, device=dev) / SR
    starts = torch.arange(0, n, 4 * beat, device=dev)
    E = starts.numel()
    sung = torch.rand(E, generator=g, device=dev) >= 0.25  # rests between phrases
    hz = _note_hz(root * 2, torch.randint(0, 7, (E,), generator=g, device=dev))
    pans = 0.35 + 0.3 * torch.rand(E, generator=g, device=dev, dtype=torch.float64)
    vib = 1.0 + 0.01 * torch.sin(2 * math.pi * 5.5 * t)
    phase = torch.cumsum(2 * math.pi * hz[:, None] * vib / SR, dim=1)
    tone = sum(a * torch.sin(phase * m) for m, a in ((1.0, 1.0), (2.4, 0.5), (3.1, 0.3)))
    burst = 0.28 * tone * _env(phrase_len, 0.08, 0.8, dev)
    _place(out, starts[sung], burst[sung], pans[sung])
    return out


def synth_song(seed: int, n: int, device) -> torch.Tensor:
    """One aligned 4-stem song ``[4, 2, n]`` float32 on ``device``, in
    :data:`INSTRUMENTS` order, peak-normalized jointly to 0.7."""
    g = torch.Generator(device=device).manual_seed(seed)
    tempo = 80.0 + 60.0 * float(torch.rand((), generator=g, device=device))
    beat = int(SR * 60 / tempo)
    root = 110.0 + 110.0 * float(torch.rand((), generator=g, device=device))  # A2..A3
    stems = torch.stack([
        _drums(g, n, beat, device), _bass(g, n, beat, root, device),
        _other(g, n, beat, root, device), _vocals(g, n, beat, root, device),
    ])
    return stems * (0.7 / stems.abs().amax().clamp_min(1e-6))


def to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float audio in [-1, 1] -> int16 PCM, as a 16-bit WAV holds it."""
    return torch.round(x * 32768.0).clamp(-32768, 32767).to(torch.int16)
