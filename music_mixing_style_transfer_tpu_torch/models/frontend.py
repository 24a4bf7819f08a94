"""STFT front end / back end feature converters, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/models/frontend.py``
(reference ``modules/front_back_end.py:9-211``):

- ``FrontEnd``: waveform -> stacked spectral features with torch.stft's
  conventions (``center=True`` reflect pad, periodic window). The mode
  slicing is the reference's: ``cplx`` drops the Nyquist bin, ``mag`` drops
  the DC bin, and the trailing frame is trimmed when ``T % (n_fft//4) == 0``.
- ``BackEnd``: spectral features -> waveform (the inverse STFT for ``cplx``
  and ``mag_phase``, the dropped bin restored as zeros; Griffin-Lim for a
  magnitude alone). The reference's ``griffin_lim`` is dead code with
  undefined symbols (``front_back_end.py:195-211``); this one works, as the
  JAX package's does.

Both run on the input tensor's device (cuFFT on the card).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..ops.stft import hamming_window, hann_window, istft, magnitude, stft


def _window(kind: str, win_length: int):
    return hann_window(win_length) if kind == "hann" else hamming_window(win_length)


class FrontEnd:
    def __init__(
        self,
        channel: str = "stereo",
        n_fft: int = 2048,
        hop_length: Optional[int] = None,
        win_length: Optional[int] = None,
        window: str = "hann",
    ):
        self.channel = channel
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.window = _window(window, self.win_length)

    def _stft(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T]`` -> ``[B, bins, frames]`` complex."""
        return stft(x, self.n_fft, self.hop_length, self.window, center=True).transpose(-1, -2)

    def _trim(self, feats: torch.Tensor, T: int) -> torch.Tensor:
        return feats[..., :-1] if T % round(self.n_fft / 4) == 0 else feats

    def __call__(self, x: torch.Tensor, mode: Sequence[str]) -> torch.Tensor:
        """``x``: ``[B, T]`` (mono) or ``[B, 2, T]`` (stereo) ->
        ``[B, C, bins, frames]``, the modes' channels concatenated."""
        outputs: List[torch.Tensor] = []
        T = x.shape[-1]
        specs = [self._stft(x)] if self.channel == "mono" else [self._stft(x[:, 0]),
                                                                  self._stft(x[:, 1])]
        for cur in mode:
            if cur == "cplx":
                feats = torch.stack([p for s in specs for p in (s.real, s.imag)], dim=1)
                feats = self._trim(feats, T)
                if self.n_fft % 2 == 0:
                    feats = feats[:, :, :-1]  # drop Nyquist (reference :44-45)
            elif cur == "mag":
                feats = self._trim(torch.stack([magnitude(s) for s in specs], dim=1), T)
                if self.n_fft % 2 == 0:
                    feats = feats[:, :, 1:]  # drop DC (reference :61-62)
            else:
                raise ValueError(f"unknown front-end mode {cur}")
            outputs.append(feats)
        return torch.cat(outputs, dim=1) if len(outputs) > 1 else outputs[0]


class BackEnd:
    def __init__(
        self,
        channel: str = "stereo",
        n_fft: int = 2048,
        hop_length: Optional[int] = None,
        win_length: Optional[int] = None,
        window: str = "hann",
        eps: float = 1e-7,
    ):
        self.channel = channel
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.eps = eps
        self.window = _window(window, self.win_length)

    def _istft(self, spec_bt: torch.Tensor) -> torch.Tensor:
        """``[B, bins, frames]`` complex -> ``[B, T]``."""
        return istft(spec_bt.transpose(-1, -2), self.hop_length, self.window, center=True)

    @staticmethod
    def _zero_bin(feats: torch.Tensor) -> torch.Tensor:
        return feats.new_zeros(feats.shape[:-2] + (1, feats.shape[-1]))

    def _restore_nyquist(self, feats: torch.Tensor) -> torch.Tensor:
        """Append the dropped Nyquist bin as zeros (``cplx`` features drop
        the top bin)."""
        return torch.cat([feats, self._zero_bin(feats)], dim=-2)

    def _restore_dc(self, feats: torch.Tensor) -> torch.Tensor:
        """Prepend the dropped DC bin as zeros: ``mag`` features drop bin 0,
        and the reference BackEnd prepends (``front_back_end.py:124-126``)."""
        return torch.cat([self._zero_bin(feats), feats], dim=-2)

    @staticmethod
    def _polar(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """``mag * exp(1j * phase)``."""
        return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))

    def cplx_to_wave(self, feats: torch.Tensor) -> torch.Tensor:
        """``[B, 2*C, bins-1, frames]`` (real and imaginary parts, channel by
        channel) -> ``[B, C, T]``."""
        waves = [
            self._istft(torch.complex(self._restore_nyquist(feats[:, 2 * i]),
                                      self._restore_nyquist(feats[:, 2 * i + 1])))
            for i in range(feats.shape[1] // 2)
        ]
        return torch.stack(waves, dim=1)

    def mag_phase_to_wave(self, mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """``mag, phase [B, C, bins-1, frames]`` -> ``[B, C, T]``."""
        waves = [
            self._istft(self._polar(self._restore_dc(mag[:, c]), self._restore_dc(phase[:, c])))
            for c in range(mag.shape[1])
        ]
        return torch.stack(waves, dim=1)

    def griffin_lim(
        self,
        mag: torch.Tensor,
        n_iter: int = 32,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Griffin-Lim phase reconstruction of ``mag [B, bins, frames]`` on
        its device, peak-normalized. The initial phase is ``init_phase``, or
        uniform in [-pi, pi) from ``generator`` (a generator on ``mag``'s
        device; seed 0 when None)."""
        if init_phase is None:
            if generator is None:
                generator = torch.Generator(device=mag.device).manual_seed(0)
            u = torch.rand(mag.shape, generator=generator, device=mag.device, dtype=mag.dtype)
            phase = -math.pi + 2 * math.pi * u
        else:
            phase = init_phase.to(mag.device, mag.dtype)
        frames = mag.shape[-1]
        for _ in range(n_iter):
            wav = self._istft(self._polar(mag, phase))
            spec = stft(wav, self.n_fft, self.hop_length, self.window, center=True)
            phase = torch.angle(spec.transpose(-1, -2)[..., :frames])
        wav = self._istft(self._polar(mag, phase))
        return wav / wav.abs().max().clamp_min(1e-9)
