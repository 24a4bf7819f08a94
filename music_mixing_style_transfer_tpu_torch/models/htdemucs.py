"""HTDemucs, Demucs v4's default separator (``htdemucs``), and its separation
front end, on the card.

Rouard, Massa and Defossez, "Hybrid Transformers for Music Source
Separation" (arXiv:2211.08553); code: facebookresearch/demucs,
``demucs/htdemucs.py``, ``transformer.py``, ``hdemucs.py``, ``demucs.py``
(``DConv``), ``apply.py`` and ``separate.py``. The reference pipeline
separates both songs into drums, bass, other and vocals before the style
transfer (``inference/style_transfer.py:82-90``); here that runs in-process
(``MixingStyleTransfer.transfer_mix_pcm``).

Two U-Nets side by side: one over the complex spectrogram (complex as
channels, 2-D convolutions over frequency x time), one over the waveform
(1-D convolutions), with a cross-domain transformer between them at the
bottleneck: self-attention within each domain alternating with
cross-attention from each domain into the other. Module and parameter names
are Demucs's, so a published state dict loads by name
(``HTDemucsSeparator(ckpt=...)``). Only the published topology is built: a
setting that would reach Demucs's collapsed-frequency layer (``last_freq``:
a frequency axis of ``kernel_size`` or fewer bins at some depth) raises, and
so does a transformer width (``bottom_channels``) that is not a positive
multiple of 4 and of the heads. Demucs's switches that the released model
leaves at one value are constants here, not settings (no GroupNorm in the
U-Net layers, DConv in the encoders alone, complex as channels, every
rewrite, the frequency embedding, the channel samplers, self layers first,
the transformer's published options, the triangular window's power 1).

The separation front end (``separate.py`` and ``apply.py``): the mixture is
standardized by the mean and std of its mono sum; chunks of ``segment``
seconds start every ``(1 - overlap) * segment``; a chunk that runs past the
song is centred (samples from before its start, zeros beyond the song);
``batch`` chunks go through the model in one dispatch; each output is
centre-trimmed, weighted by the triangular window and overlap-added on the
device, then divided by the summed weights and un-standardized. Departure
from ``separate.py``: no random shift (Demucs's ``shifts=1`` draws one
offset in [0, 0.5 s]; here the offset is 0).

The separator runs in float32 with TF32 off (``full_float32``;
``HTDemucsConfig.dtype``), as the reference pipeline runs Demucs; attention
goes through ``F.scaled_dot_product_attention``.

Traced (``utils/profiling.py``): ``separate.htdemucs`` spans one mixture's
separation; inside it ``separate.htdemucs.spec`` (standardization, STFT,
iSTFT, chunking and overlap-add), ``separate.htdemucs.unet`` (both
branches' encoders and decoders) and ``separate.htdemucs.transformer`` (the
channel samplers and the transformer's layers); the counter
``separate.htdemucs`` keeps one record a dispatch:
``{"samples", "chunks", "batch", "freq_tokens", "time_tokens"}`` (the
mixture's samples and chunks, the dispatch's chunks, and the transformer's
tokens a chunk in each domain).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import demucs_ispec, demucs_spec
from ..utils import profiling
from ..utils.device import full_float32, resolve_device
from ..utils.logging import get_logger

log = get_logger(__name__)

FREQ_EMB = 0.2  # weight of the frequency embedding after the first encoder
EMB_SCALE = 10.0  # ScaledEmbedding's scale
MAX_PERIOD = 10000.0  # the transformer's sinusoidal positions


@dataclass(frozen=True)
class HTDemucsConfig:
    """The released ``htdemucs`` model's settings (Demucs's keyword
    arguments, where the class defaults differ: ``bottom_channels`` 512 and
    ``segment`` 39/5 s), and the front end's (``overlap``, ``batch``: chunks
    a dispatch). ``dtype`` is no setting: the separator runs in float32."""

    sources: Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    samplerate: int = 44100
    channels: int = 48
    growth: int = 2
    depth: int = 4
    nfft: int = 4096
    kernel_size: int = 8
    stride: int = 4
    context: int = 1
    context_enc: int = 0
    dconv_depth: int = 2
    dconv_comp: int = 8
    dconv_init: float = 1e-3
    bottom_channels: int = 512
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    segment: float = 7.8
    overlap: float = 0.25
    batch: int = 16
    dtype: ClassVar[str] = "float32"

    @property
    def segment_length(self) -> int:
        """Samples a chunk (``int(segment * samplerate)`` of Demucs's
        ``Fraction``: 343,980 for 39/5 s)."""
        return int(round(self.segment * self.samplerate))

    @property
    def chunk_stride(self) -> int:
        return int((1 - self.overlap) * self.segment_length)


def tokens(cfg: HTDemucsConfig) -> Tuple[int, int]:
    """The transformer's tokens a chunk: ``(frequency x time, time)``."""
    hop = cfg.nfft // 4
    freq = cfg.nfft // 2 // cfg.stride**cfg.depth
    n = cfg.segment_length
    for _ in range(cfg.depth):
        n = -(-n // cfg.stride)
    return freq * -(-cfg.segment_length // hop), n


class LayerScale(nn.Module):
    """A learnt scale a channel (``demucs.py`` / ``transformer.py``)."""

    def __init__(self, channels: int, init: float = 0.0, channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x):
        return self.scale * x if self.channel_last else self.scale[:, None] * x


def _whole_norm(x: torch.Tensor, weight, bias, eps: float, dims) -> torch.Tensor:
    """GroupNorm with one group: ``x`` standardized over ``dims`` (all but
    the batch axis), then the per-channel affine, in one pass after a
    parallel reduction (``native_group_norm`` reduces each sample's row on
    one block: 8 blocks for a batch of 8 chunks)."""
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    scale = weight * torch.rsqrt(var + eps)
    return torch.addcmul(bias - mean * scale, x, scale)


class GroupNorm1(nn.GroupNorm):
    """``nn.GroupNorm(1, C)`` over ``[B, C, T]`` (its parameters), computed
    by :func:`_whole_norm`."""

    def __init__(self, num_channels: int):
        super().__init__(1, num_channels)

    def forward(self, x):
        return _whole_norm(x, self.weight[:, None], self.bias[:, None], self.eps, (1, 2))


class DConv(nn.Module):
    """Residual branch of dilated 1-D convolutions (dilation ``2**d``):
    conv k3 to ``C/compress``, GroupNorm(1), GELU, conv k1 to ``2C``,
    GroupNorm(1), GLU, LayerScale."""

    def __init__(self, channels: int, compress: float, depth: int, init: float):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList(
            nn.Sequential(
                nn.Conv1d(channels, hidden, 3, dilation=2**d, padding=2**d),
                GroupNorm1(hidden), nn.GELU(),
                nn.Conv1d(hidden, 2 * channels, 1),
                GroupNorm1(2 * channels), nn.GLU(1),
                LayerScale(channels, init),
            )
            for d in range(depth)
        )

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


def _dconv(dconv: DConv, y: torch.Tensor, freq: bool) -> torch.Tensor:
    """``dconv`` over ``y``; on the frequency branch with frequency folded
    into the batch."""
    if not freq:
        return dconv(y)
    B, C, Fr, T = y.shape
    y = dconv(y.permute(0, 2, 1, 3).reshape(B * Fr, C, T))
    return y.view(B, Fr, C, T).permute(0, 2, 1, 3)


class HEncLayer(nn.Module):
    """One encoder layer: strided conv (``[k, 1]`` over frequency, or ``k``
    over time after a right pad to a multiple of the stride), GELU, DConv,
    then a rewrite to ``2C`` and GLU (no GroupNorm: ``norm_starts`` 4 at
    depth 4)."""

    def __init__(self, chin, chout, kernel_size, stride, freq, context, dconv_kw):
        super().__init__()
        self.freq, self.stride = freq, stride
        pad = kernel_size // 4
        if freq:
            self.conv = nn.Conv2d(chin, chout, [kernel_size, 1], [stride, 1], [pad, 0])
            self.rewrite = nn.Conv2d(chout, 2 * chout, 1 + 2 * context, 1, context)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel_size, stride, pad)
            self.rewrite = nn.Conv1d(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.dconv = DConv(chout, **dconv_kw)

    def forward(self, x):
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = _dconv(self.dconv, F.gelu(self.conv(x)), self.freq)
        return F.glu(self.rewrite(y), dim=1)


class HDecLayer(nn.Module):
    """One decoder layer: add the skip, rewrite (3x3 over frequency x time,
    or 3 over time) to ``2C`` and GLU, then the transposed strided conv,
    trimmed by ``k // 4`` at each end of frequency or to ``length`` in
    time, and GELU except in the last layer (no DConv: ``dconv_mode`` 1)."""

    def __init__(self, chin, chout, last, kernel_size, stride, freq, context):
        super().__init__()
        self.freq, self.last, self.pad = freq, last, kernel_size // 4
        if freq:
            self.conv_tr = nn.ConvTranspose2d(chin, chout, [kernel_size, 1], [stride, 1])
            self.rewrite = nn.Conv2d(chin, 2 * chin, 1 + 2 * context, 1, context)
        else:
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel_size, stride)
            self.rewrite = nn.Conv1d(chin, 2 * chin, 1 + 2 * context, 1, context)

    def forward(self, x, skip, length: int):
        z = self.conv_tr(F.glu(self.rewrite(x + skip), dim=1))
        z = z[..., self.pad : -self.pad, :] if self.freq else z[..., self.pad : self.pad + length]
        return z if self.last else F.gelu(z)


class ScaledEmbedding(nn.Module):
    """An embedding whose stored weight is the published one over
    ``EMB_SCALE``, multiplied back in the forward (``hdemucs.py``; drawn
    smooth: the running sum over the index, over its square root)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        with torch.no_grad():
            w = self.embedding.weight
            n = torch.arange(1, num_embeddings + 1).to(w)
            w.copy_(torch.cumsum(w, 0) / n.sqrt()[:, None] / EMB_SCALE)

    def forward(self, x):
        return self.embedding(x) * EMB_SCALE


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), batch first, no dropout, through
    ``F.scaled_dot_product_attention``; keys and values from ``kv`` when
    given (cross-attention), else from the queries' input."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x, kv: Optional[torch.Tensor] = None):
        B, N, D = x.shape
        h = self.heads
        w, b = self.in_proj_weight, self.in_proj_bias
        if kv is None:
            q, k, v = F.linear(x, w, b).view(B, N, 3, h, D // h).permute(2, 0, 3, 1, 4)
        else:
            q = F.linear(x, w[:D], b[:D]).view(B, N, h, D // h).transpose(1, 2)
            M = kv.shape[1]
            k, v = F.linear(kv, w[D:], b[D:]).view(B, M, 2, h, D // h).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(o.transpose(1, 2).reshape(B, N, D))


class MyGroupNorm(nn.GroupNorm):
    """GroupNorm with one group over ``[B, T, C]`` tokens: over all of a
    sequence's tokens and channels together (``transformer.py``), computed
    by :func:`_whole_norm` without transposing."""

    def __init__(self, num_channels: int):
        super().__init__(1, num_channels)

    def forward(self, x):
        return _whole_norm(x, self.weight, self.bias, self.eps, (1, 2))


class _Layer(nn.Module):
    """What the transformer's two kinds of layer share: the GELU FFN, the
    layer scales and the GroupNorm after the layer (pre-norm, ``norm_out``,
    ``layer_scale`` and ``gelu`` as published)."""

    def __init__(self, dim: int, hidden: int, init_values: float = 1e-4):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm_out = MyGroupNorm(dim)
        self.gamma_1 = LayerScale(dim, init_values, True)
        self.gamma_2 = LayerScale(dim, init_values, True)

    def _ff(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class MyTransformerEncoderLayer(_Layer):
    """Self-attention and FFN, each pre-norm with a layer scale."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__(dim, hidden)
        self.self_attn = MultiheadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x):
        x = x + self.gamma_1(self.self_attn(self.norm1(x)))
        x = x + self.gamma_2(self._ff(self.norm2(x)))
        return self.norm_out(x)


class CrossTransformerEncoderLayer(_Layer):
    """Cross-attention from ``q``'s tokens into ``k``'s (keys and values
    through their own LayerNorm, ``norm2``), then the FFN."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__(dim, hidden)
        self.cross_attn = MultiheadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, q, k):
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), self.norm2(k)))
        x = x + self.gamma_2(self._ff(self.norm3(x)))
        return self.norm_out(x)


def create_sin_embedding(length: int, dim: int, device) -> torch.Tensor:
    """``[1, length, dim]``: ``cos`` then ``sin`` of
    ``pos / MAX_PERIOD**(i / (dim/2 - 1))``."""
    pos = torch.arange(length, device=device).view(-1, 1)
    adim = torch.arange(dim // 2, device=device).view(1, -1)
    phase = pos / (MAX_PERIOD ** (adim / (dim // 2 - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)[None]


def create_2d_sin_embedding(d_model: int, height: int, width: int) -> torch.Tensor:
    """``[1, d_model, height, width]`` on the CPU: half the channels encode
    the width (time) position, half the height (frequency), interleaved
    ``sin``/``cos`` (``transformer.py``)."""
    pe = torch.zeros(d_model, height, width)
    d = d_model // 2
    div_term = torch.exp(torch.arange(0.0, d, 2) * -(math.log(MAX_PERIOD) / d))
    pos_w = torch.arange(0.0, width).unsqueeze(1)
    pos_h = torch.arange(0.0, height).unsqueeze(1)
    pe[0:d:2] = torch.sin(pos_w * div_term).t().unsqueeze(1).repeat(1, height, 1)
    pe[1:d:2] = torch.cos(pos_w * div_term).t().unsqueeze(1).repeat(1, height, 1)
    pe[d::2] = torch.sin(pos_h * div_term).t().unsqueeze(2).repeat(1, 1, width)
    pe[d + 1 :: 2] = torch.cos(pos_h * div_term).t().unsqueeze(2).repeat(1, 1, width)
    return pe[None]


class CrossTransformerEncoder(nn.Module):
    """The bottleneck transformer: both domains' tokens LayerNorm'd and
    given their sinusoidal positions (2-D over ``(time, frequency)`` for the
    spectrogram's, 1-D for the waveform's), then ``num_layers`` layers, one
    per domain each: self layers, and at every other index cross layers,
    where the time tokens attend to the frequency tokens as they were before
    the layer (self layers at the even indices)."""

    def __init__(self, dim: int, hidden_scale: float, num_heads: int, num_layers: int):
        super().__init__()
        hidden = int(dim * hidden_scale)
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for idx in range(num_layers):
            cls = CrossTransformerEncoderLayer if idx % 2 else MyTransformerEncoderLayer
            self.layers.append(cls(dim, num_heads, hidden))
            self.layers_t.append(cls(dim, num_heads, hidden))
        self._pos2d: Dict[tuple, torch.Tensor] = {}

    def _pos_2d(self, C: int, Fr: int, T: int, device) -> torch.Tensor:
        """The 2-D embedding as tokens ``[1, T*Fr, C]`` (``(t fr)`` order),
        made on the CPU as Demucs makes it, once a shape."""
        key = (C, Fr, T, device)
        if key not in self._pos2d:
            pe = create_2d_sin_embedding(C, Fr, T)
            self._pos2d[key] = pe.permute(0, 3, 2, 1).reshape(1, T * Fr, C).to(device)
        return self._pos2d[key]

    def forward(self, x, xt):
        B, C, Fr, T1 = x.shape
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        x = self.norm_in(x) + self._pos_2d(C, Fr, T1, x.device)
        T2 = xt.shape[-1]
        xt = self.norm_in_t(xt.transpose(1, 2)) + create_sin_embedding(T2, C, xt.device)
        for idx, (layer, layer_t) in enumerate(zip(self.layers, self.layers_t)):
            if idx % 2:
                x, xt = layer(x, xt), layer_t(xt, x)
            else:
                x, xt = layer(x), layer_t(xt)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)


class HTDemucs(nn.Module):
    """The hybrid time/spectrogram U-Net with the cross-domain transformer
    at its bottleneck. ``forward`` takes chunks ``[B, channels, L]`` and
    returns each source's estimate ``[B, S, channels, L]``."""

    def __init__(self, cfg: Optional[HTDemucsConfig] = None):
        super().__init__()
        cfg = cfg or HTDemucsConfig()
        self.cfg = cfg
        self.sources, self.nfft = cfg.sources, cfg.nfft
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        self.tencoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chin, chin_z = cfg.audio_channels, 2 * cfg.audio_channels  # complex as channels
        chout = chout_z = cfg.channels
        freqs = cfg.nfft // 2
        dconv_kw = {"compress": cfg.dconv_comp, "depth": cfg.dconv_depth, "init": cfg.dconv_init}
        for index in range(cfg.depth):
            if freqs <= cfg.kernel_size:
                raise ValueError(
                    f"depth {cfg.depth} with nfft {cfg.nfft} leaves {freqs} frequency bins at "
                    f"layer {index}: Demucs's collapsed-frequency layer (last_freq) is not built")
            kw = {"kernel_size": cfg.kernel_size, "stride": cfg.stride}
            self.encoder.append(HEncLayer(chin_z, chout_z, freq=True, context=cfg.context_enc,
                                          dconv_kw=dconv_kw, **kw))
            self.tencoder.append(HEncLayer(chin, chout, freq=False, context=cfg.context_enc,
                                           dconv_kw=dconv_kw, **kw))
            if index == 0:
                chin = cfg.audio_channels * len(cfg.sources)
                chin_z = 2 * chin
            self.decoder.insert(0, HDecLayer(chout_z, chin_z, last=index == 0, freq=True,
                                             context=cfg.context, **kw))
            self.tdecoder.insert(0, HDecLayer(chout, chin, last=index == 0, freq=False,
                                              context=cfg.context, **kw))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(cfg.growth * chout), int(cfg.growth * chout_z)
            freqs //= cfg.stride
            if index == 0:
                self.freq_emb = ScaledEmbedding(freqs, chin_z)
        unet, dim = cfg.channels * cfg.growth ** (cfg.depth - 1), cfg.bottom_channels
        if dim <= 0 or dim % 4 or dim % cfg.t_heads:
            raise ValueError(f"transformer width {dim}: must be positive and divide by 4 and "
                             "by t_heads")
        self.channel_upsampler = nn.Conv1d(unet, dim, 1)
        self.channel_downsampler = nn.Conv1d(dim, unet, 1)
        self.channel_upsampler_t = nn.Conv1d(unet, dim, 1)
        self.channel_downsampler_t = nn.Conv1d(dim, unet, 1)
        self.crosstransformer = CrossTransformerEncoder(dim, cfg.t_hidden_scale, cfg.t_heads,
                                                        cfg.t_layers)

    def forward(self, mix):
        length = mix.shape[-1]
        with profiling.span("separate.htdemucs.spec"):
            z = demucs_spec(mix, self.nfft)  # complex [B, C, Fr, T]
            B, C, Fq, T = z.shape
            x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(B, 2 * C, Fq, T)
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            std = x.std(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) / (1e-5 + std)
            meant = mix.mean(dim=(1, 2), keepdim=True)
            stdt = mix.std(dim=(1, 2), keepdim=True)
            xt = (mix - meant) / (1e-5 + stdt)
        with profiling.span("separate.htdemucs.unet"):
            saved, saved_t, lengths_t = [], [], []
            for idx, (encode, tencode) in enumerate(zip(self.encoder, self.tencoder)):
                lengths_t.append(xt.shape[-1])
                xt = tencode(xt)
                saved_t.append(xt)
                x = encode(x)
                if idx == 0:
                    frs = torch.arange(x.shape[-2], device=x.device)
                    x = x + FREQ_EMB * self.freq_emb(frs).t()[None, :, :, None]
                saved.append(x)
        with profiling.span("separate.htdemucs.transformer"):
            b, c, f, t = x.shape
            x = self.channel_upsampler(x.reshape(b, c, f * t)).view(b, -1, f, t)
            x, xt = self.crosstransformer(x, self.channel_upsampler_t(xt))
            x = self.channel_downsampler(x.reshape(b, -1, f * t)).view(b, c, f, t)
            xt = self.channel_downsampler_t(xt)
        with profiling.span("separate.htdemucs.unet"):
            for decode, tdecode in zip(self.decoder, self.tdecoder):
                x = decode(x, saved.pop(), 0)
                xt = tdecode(xt, saved_t.pop(), lengths_t.pop())
        with profiling.span("separate.htdemucs.spec"):
            S = len(self.sources)
            x = x.view(B, S, -1, Fq, T) * std[:, None] + mean[:, None]
            zout = x.view(B, S, -1, 2, Fq, T).permute(0, 1, 2, 4, 5, 3)
            zout = torch.view_as_complex(zout.contiguous())
            x = demucs_ispec(zout, length)
            return xt.view(B, S, -1, length) * stdt[:, None] + meant[:, None] + x


def triangle_weight(length: int, device) -> torch.Tensor:
    """Demucs's overlap-add window (``transition_power`` 1): ``1 ..
    length//2`` then back down to 1, over its maximum."""
    w = torch.cat([torch.arange(1, length // 2 + 1, device=device),
                   torch.arange(length - length // 2, 0, -1, device=device)])
    return w / w.max()


class HTDemucsSeparator:
    """A whole mixture into its sources on one device: the separation
    front end around :class:`HTDemucs` (module docstring). ``ckpt``: a
    state dict saved by ``torch.save`` (or a dict holding it under
    ``"state"``, as Demucs packs its models) with Demucs's names; when it is
    missing, weights are drawn from ``seed`` (with a warning)."""

    def __init__(self, cfg: Optional[HTDemucsConfig] = None, ckpt: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg = cfg or HTDemucsConfig()
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = HTDemucs(cfg)
        if ckpt and os.path.exists(ckpt):
            state = torch.load(ckpt, map_location="cpu", weights_only=True)
            model.load_state_dict(state.get("state", state))
            log.info("loaded HTDemucs checkpoint: %s", ckpt)
        else:
            log.warning("no HTDemucs checkpoint at %s - random init from seed %d", ckpt, seed)
        self.model = model.to(self.device).eval()
        self.tokens = tokens(cfg)
        self._weight = triangle_weight(cfg.segment_length, self.device)

    @torch.inference_mode()
    def separate(self, mix) -> torch.Tensor:
        """``mix [channels, T]`` (int16 PCM or float, numpy or a tensor) ->
        the sources ``[S, channels, T]``, float32 on the device."""
        with profiling.span("separate.htdemucs"), full_float32():
            return self._separate(mix)

    def _separate(self, mix) -> torch.Tensor:
        cfg, dev = self.cfg, self.device
        L, stride = cfg.segment_length, cfg.chunk_stride
        with profiling.span("separate.htdemucs.spec"):
            x = torch.as_tensor(np.ascontiguousarray(mix) if isinstance(mix, np.ndarray) else mix)
            x = x.to(dev)
            x = x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x.float()
            T = x.shape[-1]
            ref = x.mean(0)
            m, s = ref.mean(), ref.std()
            x = F.pad((x - m) / s, (L, L))  # zeros past both ends
            offsets = list(range(0, T, stride))
            out = x.new_zeros(len(cfg.sources), x.shape[0], T)
            total = x.new_zeros(T)
        for i in range(0, len(offsets), cfg.batch):
            group = offsets[i : i + cfg.batch]
            # a chunk that runs past the song is centred: (L - n) // 2 samples from before it
            spans = [(o, min(L, T - o)) for o in group]
            with profiling.span("separate.htdemucs.spec"):
                chunks = torch.stack([x[:, L + o - (L - n) // 2 : 2 * L + o - (L - n) // 2]
                                      for o, n in spans])
            profiling.count("separate.htdemucs", {
                "samples": T, "chunks": len(offsets), "batch": len(group),
                "freq_tokens": self.tokens[0], "time_tokens": self.tokens[1]})
            y = self.model(chunks)
            with profiling.span("separate.htdemucs.spec"):
                for k, (o, n) in enumerate(spans):
                    d = (L - n) // 2
                    out[..., o : o + n] += self._weight[:n] * y[k, ..., d : d + n]
                    total[o : o + n] += self._weight[:n]
            del y, chunks
        with profiling.span("separate.htdemucs.spec"):
            return out / total * s + m
