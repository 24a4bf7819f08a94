"""The plain float32 reference of HTDemucs separation (Demucs v4's
``htdemucs``), written from ``demucs/htdemucs.py``, ``transformer.py``,
``hdemucs.py``, ``demucs.py`` (``DConv``), ``spec.py``, ``apply.py`` and
``separate.py`` (facebookresearch/demucs; Rouard, Massa and Defossez,
arXiv:2211.08553). Plain ``torch`` only: it imports nothing else of the
port and no kernel; the spectrogram is ``torch.stft`` / ``torch.istft``,
attention is an explicit softmax over ``q k^T / sqrt(d)`` (no fused
attention), one chunk goes through the model at a time, and the loop over
chunks is written out. Convolutions and matmuls run with TF32 off unless a
caller asks for it (``separate(..., tf32=True)``, a control). The module and
parameter names are Demucs's, so the program's weights load here by name.

Departures from the published description:

- No random shift: Demucs's ``separate.py`` runs ``apply_model`` with
  ``shifts=1`` (one random offset in [0, 0.5 s]); here ``shifts=0``, the
  chunks start at 0.
- Only the published topology: no collapsed-frequency layer (``last_freq``,
  raises), complex-as-channels (``cac``), every encoder and decoder with its
  rewrite, no GroupNorm in the U-Net layers (``norm_starts`` 4 at depth 4),
  DConv in the encoders alone (``dconv_mode`` 1), the transformer with
  ``t_emb="sin"``, pre-norm layers with layer
  scales, GELU and the GroupNorm after each layer, no dropout, no sparse
  attention, no Wiener filtering (``wiener_iters`` 0).
- Weights are whatever the caller loads: no ``rescale_module`` at
  construction.
- ``dtype=torch.bfloat16`` (a control) runs the U-Nets and the transformer
  in bfloat16; the STFT, the standardizations and the iSTFT stay float32.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class HTDemucsConfig:
    """The released ``htdemucs`` settings and the front end's (the same
    fields as the program's configuration). The settings the released
    model leaves at one value are written where Demucs reads them:
    ``freq_emb`` 0.2, ``emb_scale`` 10, ``emb_smooth``, ``t_cross_first``
    false, ``t_max_period`` 10000, ``t_weight_pos_embed`` 1,
    ``transition_power`` 1."""

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


@contextlib.contextmanager
def tf32_flags(on: bool):
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# ----------------------------------------------------------------------------
# spec.py and HTDemucs._spec / _ispec


def spectro(x, n_fft, hop_length):
    *other, length = x.shape
    z = torch.stft(x.reshape(-1, length), n_fft, hop_length,
                   window=torch.hann_window(n_fft).to(x), win_length=n_fft, normalized=True,
                   center=True, return_complex=True, pad_mode="reflect")
    _, freqs, frames = z.shape
    return z.view(*other, freqs, frames)


def ispectro(z, hop_length, length):
    *other, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    x = torch.istft(z.reshape(-1, freqs, frames), n_fft, hop_length,
                    window=torch.hann_window(n_fft).to(z.real), win_length=n_fft,
                    normalized=True, length=length, center=True)
    return x.view(*other, x.shape[-1])


def spec(x, nfft):
    hl = nfft // 4
    le = int(math.ceil(x.shape[-1] / hl))
    pad = hl // 2 * 3
    x = F.pad(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
    z = spectro(x, nfft, hl)[..., :-1, :]
    return z[..., 2 : 2 + le]


def ispec(z, hop, length):
    z = F.pad(z, (0, 0, 0, 1))
    z = F.pad(z, (2, 2))
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    x = ispectro(z, hop, le)
    return x[..., pad : pad + length]


# ----------------------------------------------------------------------------
# demucs.py / hdemucs.py layers


class LayerScale(nn.Module):
    def __init__(self, channels, init=0.0, channel_last=False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.zeros(channels))
        self.scale.data[:] = init

    def forward(self, x):
        if self.channel_last:
            return self.scale * x
        return self.scale[:, None] * x


class DConv(nn.Module):
    def __init__(self, channels, compress, depth, init):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            dilation = 2**d
            self.layers.append(nn.Sequential(
                nn.Conv1d(channels, hidden, 3, dilation=dilation, padding=dilation),
                nn.GroupNorm(1, hidden), nn.GELU(),
                nn.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels), nn.GLU(1),
                LayerScale(channels, init)))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    def __init__(self, chin, chout, kernel_size, stride, freq, context, dconv_kw):
        super().__init__()
        pad = kernel_size // 4
        klass = nn.Conv1d
        self.freq, self.stride = freq, stride
        if freq:
            kernel_size, stride, pad, klass = [kernel_size, 1], [stride, 1], [pad, 0], nn.Conv2d
        self.conv = klass(chin, chout, kernel_size, stride, pad)
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.dconv = DConv(chout, **dconv_kw)

    def forward(self, x):
        if not self.freq:
            le = x.shape[-1]
            if le % self.stride != 0:
                x = F.pad(x, (0, self.stride - (le % self.stride)))
        y = self.conv(x)
        y = F.gelu(y)
        if self.freq:
            B, C, Fr, T = y.shape
            y = y.permute(0, 2, 1, 3).reshape(-1, C, T)
        y = self.dconv(y)
        if self.freq:
            y = y.view(B, Fr, C, T).permute(0, 2, 1, 3)
        z = self.rewrite(y)
        return F.glu(z, dim=1)


class HDecLayer(nn.Module):
    def __init__(self, chin, chout, last, kernel_size, stride, freq, context):
        super().__init__()
        self.pad = kernel_size // 4
        self.last, self.freq = last, freq
        klass, klass_tr = nn.Conv1d, nn.ConvTranspose1d
        if freq:
            kernel_size, stride = [kernel_size, 1], [stride, 1]
            klass, klass_tr = nn.Conv2d, nn.ConvTranspose2d
        self.conv_tr = klass_tr(chin, chout, kernel_size, stride)
        self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)

    def forward(self, x, skip, length):
        x = x + skip
        y = F.glu(self.rewrite(x), dim=1)
        z = self.conv_tr(y)
        if self.freq:
            z = z[..., self.pad : -self.pad, :]
        else:
            z = z[..., self.pad : self.pad + length]
        if not self.last:
            z = F.gelu(z)
        return z


class ScaledEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, scale=10.0, smooth=False):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        if smooth:
            weight = torch.cumsum(self.embedding.weight.data, dim=0)
            weight = weight / torch.arange(1, num_embeddings + 1).to(weight).sqrt()[:, None]
            self.embedding.weight.data[:] = weight
        self.embedding.weight.data /= scale
        self.scale = scale

    def forward(self, x):
        return self.embedding(x) * self.scale


# ----------------------------------------------------------------------------
# transformer.py


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameters, its arithmetic written out:
    ``softmax(q k^T / sqrt(d)) v`` a head, then the output projection."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        B, N, D = q.shape
        M = k.shape[1]
        h, d = self.heads, D // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = (q @ wq.t() + bq).view(B, N, h, d).transpose(1, 2)
        k = (k @ wk.t() + bk).view(B, M, h, d).transpose(1, 2)
        v = (v @ wv.t() + bv).view(B, M, h, d).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        o = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, N, D))


class MyGroupNorm(nn.GroupNorm):
    def forward(self, x):
        x = x.transpose(1, 2)
        return super().forward(x).transpose(1, 2)


class MyTransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, init_values=1e-4):
        super().__init__()
        self.self_attn = Attention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm_out = MyGroupNorm(num_groups=1, num_channels=d_model)
        self.gamma_1 = LayerScale(d_model, init_values, True)
        self.gamma_2 = LayerScale(d_model, init_values, True)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(y, y, y))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm2(x)))))
        return self.norm_out(x)


class CrossTransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, init_values=1e-4):
        super().__init__()
        self.cross_attn = Attention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)
        self.norm_out = MyGroupNorm(num_groups=1, num_channels=d_model)
        self.gamma_1 = LayerScale(d_model, init_values, True)
        self.gamma_2 = LayerScale(d_model, init_values, True)

    def forward(self, q, k):
        kn = self.norm2(k)
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), kn, kn))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm3(x)))))
        return self.norm_out(x)


def create_sin_embedding(length, dim, device, max_period):
    # TBC
    pos = torch.arange(length, device=device).view(-1, 1, 1)
    half_dim = dim // 2
    adim = torch.arange(dim // 2, device=device).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model, height, width, device, max_period):
    if d_model % 4 != 0:
        raise ValueError(f"Cannot use sin/cos positional encoding with odd dimension {d_model}")
    pe = torch.zeros(d_model, height, width)
    d_model = int(d_model / 2)
    div_term = torch.exp(torch.arange(0.0, d_model, 2) * -(math.log(max_period) / d_model))
    pos_w = torch.arange(0.0, width).unsqueeze(1)
    pos_h = torch.arange(0.0, height).unsqueeze(1)
    pe[0:d_model:2, :, :] = torch.sin(pos_w * div_term).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[1:d_model:2, :, :] = torch.cos(pos_w * div_term).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[d_model::2, :, :] = torch.sin(pos_h * div_term).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    pe[d_model + 1 :: 2, :, :] = torch.cos(pos_h * div_term).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    return pe[None, :].to(device)


class CrossTransformerEncoder(nn.Module):
    def __init__(self, dim, hidden_scale, num_heads, num_layers, cross_first, max_period,
                 weight_pos_embed):
        super().__init__()
        hidden_dim = int(dim * hidden_scale)
        self.num_layers = num_layers
        self.classic_parity = 1 if cross_first else 0
        self.max_period = max_period
        self.weight_pos_embed = weight_pos_embed
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for idx in range(num_layers):
            if idx % 2 == self.classic_parity:
                self.layers.append(MyTransformerEncoderLayer(dim, num_heads, hidden_dim))
                self.layers_t.append(MyTransformerEncoderLayer(dim, num_heads, hidden_dim))
            else:
                self.layers.append(CrossTransformerEncoderLayer(dim, num_heads, hidden_dim))
                self.layers_t.append(CrossTransformerEncoderLayer(dim, num_heads, hidden_dim))

    def forward(self, x, xt):
        dtype = x.dtype
        B, C, Fr, T1 = x.shape
        pos_emb_2d = create_2d_sin_embedding(C, Fr, T1, x.device, self.max_period)
        pos_emb_2d = pos_emb_2d.permute(0, 3, 2, 1).reshape(1, T1 * Fr, C)  # b (t1 fr) c
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        x = self.norm_in(x)
        x = x + (self.weight_pos_embed * pos_emb_2d).to(dtype)
        B, C, T2 = xt.shape
        xt = xt.permute(0, 2, 1)
        pos_emb = create_sin_embedding(T2, C, x.device, self.max_period).permute(1, 0, 2)
        xt = self.norm_in_t(xt)
        xt = xt + (self.weight_pos_embed * pos_emb).to(dtype)
        for idx in range(self.num_layers):
            if idx % 2 == self.classic_parity:
                x = self.layers[idx](x)
                xt = self.layers_t[idx](xt)
            else:
                old_x = x
                x = self.layers[idx](x, xt)
                xt = self.layers_t[idx](xt, old_x)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        xt = xt.permute(0, 2, 1)
        return x, xt


# ----------------------------------------------------------------------------
# htdemucs.py


class HTDemucs(nn.Module):
    def __init__(self, cfg: HTDemucsConfig):
        super().__init__()
        self.cfg = cfg
        self.sources = cfg.sources
        self.nfft = cfg.nfft
        self.hop_length = cfg.nfft // 4
        self.depth = cfg.depth
        self.bottom_channels = cfg.bottom_channels
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        self.tencoder = nn.ModuleList()
        self.tdecoder = nn.ModuleList()
        chin = cfg.audio_channels
        chin_z = chin * 2  # cac
        chout = cfg.channels
        chout_z = cfg.channels
        freqs = cfg.nfft // 2
        self.freq_emb = None
        for index in range(cfg.depth):
            if freqs <= cfg.kernel_size:
                raise ValueError("the collapsed-frequency layer (last_freq) is not in the reference")
            kw = {"kernel_size": cfg.kernel_size, "stride": cfg.stride}
            dconv_kw = {"depth": cfg.dconv_depth, "compress": cfg.dconv_comp,
                        "init": cfg.dconv_init}
            self.encoder.append(HEncLayer(chin_z, chout_z, freq=True, context=cfg.context_enc,
                                          dconv_kw=dconv_kw, **kw))
            self.tencoder.append(HEncLayer(chin, chout, freq=False, context=cfg.context_enc,
                                           dconv_kw=dconv_kw, **kw))
            if index == 0:
                chin = cfg.audio_channels * len(cfg.sources)
                chin_z = chin * 2
            self.decoder.insert(0, HDecLayer(chout_z, chin_z, last=index == 0, freq=True,
                                             context=cfg.context, **kw))
            self.tdecoder.insert(0, HDecLayer(chout, chin, last=index == 0, freq=False,
                                              context=cfg.context, **kw))
            chin = chout
            chin_z = chout_z
            chout = int(cfg.growth * chout)
            chout_z = int(cfg.growth * chout_z)
            freqs //= cfg.stride
            if index == 0:
                self.freq_emb = ScaledEmbedding(freqs, chin_z, smooth=True, scale=10.0)
                self.freq_emb_scale = 0.2
        transformer_channels = cfg.channels * cfg.growth ** (cfg.depth - 1)
        if cfg.bottom_channels:
            self.channel_upsampler = nn.Conv1d(transformer_channels, cfg.bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(cfg.bottom_channels, transformer_channels, 1)
            self.channel_upsampler_t = nn.Conv1d(transformer_channels, cfg.bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(cfg.bottom_channels, transformer_channels, 1)
            transformer_channels = cfg.bottom_channels
        self.crosstransformer = CrossTransformerEncoder(
            transformer_channels, cfg.t_hidden_scale, cfg.t_heads, cfg.t_layers,
            cross_first=False, max_period=10000.0, weight_pos_embed=1.0)

    def forward(self, mix):
        length = mix.shape[-1]
        dtype = next(self.parameters()).dtype
        z = spec(mix, self.nfft)
        B, C, Fr, T = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(B, C * 2, Fr, T)
        Fq = Fr
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)
        x, xt = x.to(dtype), xt.to(dtype)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = encode(x)
            if idx == 0 and self.freq_emb is not None:
                frs = torch.arange(x.shape[-2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].expand_as(x)
                x = x + self.freq_emb_scale * emb
            saved.append(x)
        if self.bottom_channels:
            b, c, f, t = x.shape
            x = x.reshape(b, c, f * t)
            x = self.channel_upsampler(x)
            x = x.reshape(b, -1, f, t)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            x = x.reshape(b, -1, f * t)
            x = self.channel_downsampler(x)
            x = x.reshape(b, -1, f, t)
            xt = self.channel_downsampler_t(xt)
        for idx, decode in enumerate(self.decoder):
            x = decode(x, saved.pop(-1), lengths.pop(-1))
            xt = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))
        assert not saved and not saved_t and not lengths_t

        x, xt = x.float(), xt.float()
        S = len(self.sources)
        x = x.view(B, S, -1, Fq, T)
        x = x * std[:, None] + mean[:, None]
        out = x.view(B, S, -1, 2, Fq, T).permute(0, 1, 2, 4, 5, 3)
        zout = torch.view_as_complex(out.contiguous())
        x = ispec(zout, self.hop_length, length)
        xt = xt.view(B, S, -1, length)
        xt = xt * stdt[:, None] + meant[:, None]
        return xt + x


# ----------------------------------------------------------------------------
# apply.py (split, overlap-add) and separate.py (standardization)


def padded_chunk(mix, offset, length, target_length):
    """``TensorChunk(mix, offset, length).padded(target_length)``: the chunk
    centred in ``target_length``, samples from around it, zeros past the
    song."""
    total_length = mix.shape[-1]
    delta = target_length - length
    start = offset - delta // 2
    end = start + target_length
    correct_start = max(0, start)
    correct_end = min(total_length, end)
    pad_left = correct_start - start
    pad_right = end - correct_end
    return F.pad(mix[..., correct_start:correct_end], (pad_left, pad_right))


def center_trim(tensor, length):
    delta = tensor.shape[-1] - length
    if delta:
        tensor = tensor[..., delta // 2 : -(delta - delta // 2)]
    return tensor


@torch.no_grad()
def apply_model(model, mix, cfg: HTDemucsConfig):
    """``mix [B, C, T]`` -> ``[B, S, C, T]``: chunks of ``segment`` seconds
    every ``(1 - overlap)`` of it, one at a time, weighted and summed."""
    batch, channels, length = mix.shape
    segment_length = int(round(cfg.segment * cfg.samplerate))
    out = torch.zeros(batch, len(cfg.sources), channels, length, device=mix.device)
    sum_weight = torch.zeros(length, device=mix.device)
    stride = int((1 - cfg.overlap) * segment_length)
    weight = torch.cat([torch.arange(1, segment_length // 2 + 1, device=mix.device),
                        torch.arange(segment_length - segment_length // 2, 0, -1, device=mix.device)])
    weight = weight / weight.max()  # transition_power 1
    for offset in range(0, length, stride):
        chunk_length = min(segment_length, length - offset)
        chunk = padded_chunk(mix, offset, chunk_length, segment_length)
        chunk_out = center_trim(model(chunk), chunk_length)
        out[..., offset : offset + segment_length] += weight[:chunk_length] * chunk_out
        sum_weight[offset : offset + segment_length] += weight[:chunk_length]
    assert sum_weight.min() > 0
    return out / sum_weight


@torch.no_grad()
def separate(model: HTDemucs, mix, tf32: bool = False) -> torch.Tensor:
    """``mix [C, T]`` float (int16 PCM is scaled by 1/32768) -> the sources
    ``[S, C, T]`` float32, as ``separate.py`` runs ``apply_model``: the
    mixture standardized by its mono sum's mean and std, and back."""
    wav = mix.float() / 32768.0 if mix.dtype == torch.int16 else mix.float()
    ref = wav.mean(0)
    wav = (wav - ref.mean()) / ref.std()
    with tf32_flags(tf32):
        sources = apply_model(model, wav[None], model.cfg)[0]
    sources = sources * ref.std()
    sources = sources + ref.mean()
    return sources
