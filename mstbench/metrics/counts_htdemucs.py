"""HTDemucs's operations and bytes, the yardstick of the ``.mix`` readers,
frozen here so that a change to the program cannot move them.

Operations count multiply-adds as two: every convolution (1-D, 2-D and
transposed, over the positions it computes; a transposed convolution over
its input positions), the channel samplers, the transformer's linear layers
(the attention's projections and the FFN) and attention's two products
(``q k^T`` and the weights times ``v``). Norms, activations, GLU, the
softmax, layer scales, the embeddings, the STFT and the overlap-add are
left out. ``cfg`` is the configuration's ``separator`` group.
"""
from __future__ import annotations

from mstbench.metrics.counts import PEAKS


def _segment(cfg: dict) -> int:
    return int(round(cfg["segment"] * cfg["samplerate"]))


def _dconv(c: int, cfg: dict) -> int:
    """DConv's multiply-adds a position at ``c`` channels."""
    hidden = int(c / cfg["dconv_comp"])
    return cfg["dconv_depth"] * (c * hidden * 3 + hidden * 2 * c)


def tokens(cfg: dict):
    """The transformer's tokens a chunk: ``(frequency x time, time)``."""
    hop = cfg["nfft"] // 4
    t = _segment(cfg)
    for _ in range(cfg["depth"]):
        t = -(-t // cfg["stride"])
    return cfg["nfft"] // 2 // cfg["stride"] ** cfg["depth"] * -(-_segment(cfg) // hop), t


def unet_flops_per_chunk(cfg: dict) -> float:
    """Both U-Nets' convolutions, encoders and decoders, one chunk."""
    k, s, ctx_e, ctx_d = cfg["kernel_size"], cfg["stride"], cfg["context_enc"], cfg["context"]
    frames = -(-_segment(cfg) // (cfg["nfft"] // 4))
    fr, t = cfg["nfft"] // 2, _segment(cfg)
    a = cfg["audio_channels"]
    out_a = a * len(cfg["sources"])
    macs = 0
    ch = [cfg["channels"] * cfg["growth"] ** i for i in range(cfg["depth"])]
    for i, c in enumerate(ch):
        cin, cout = (a if i == 0 else ch[i - 1]), (out_a if i == 0 else ch[i - 1])
        z = 2 if i == 0 else 1  # complex as channels: the frequency branch's outer layer only
        fr, t = fr // s, -(-t // s)
        for pos, chin, chout, square in ((fr * frames, z * cin, z * cout, 2), (t, cin, cout, 1)):
            # encoder: strided conv, DConv, rewrite (kernel 1 + 2 context_enc)
            macs += pos * (chin * c * k + _dconv(c, cfg) + c * 2 * c * (1 + 2 * ctx_e) ** square)
            # decoder at this depth: rewrite (kernel 1 + 2 context), transposed conv
            macs += pos * (c * 2 * c * (1 + 2 * ctx_d) ** square + c * chout * k)
    return 2.0 * macs


def transformer_flops_per_chunk(cfg: dict, freq_tokens: int = None, time_tokens: int = None) -> float:
    """The channel samplers and the transformer's layers, one chunk."""
    nf, nt = tokens(cfg) if freq_tokens is None else (freq_tokens, time_tokens)
    c = cfg["channels"] * cfg["growth"] ** (cfg["depth"] - 1)
    d = cfg["bottom_channels"]
    ff = int(d * cfg["t_hidden_scale"])
    macs = 2 * (nf + nt) * c * d  # the samplers up and down, both domains
    for idx in range(cfg["t_layers"]):
        ffn = (nf + nt) * (d * d + 2 * d * ff)  # output projection and FFN, both domains
        if idx % 2:  # cross layers: q from one domain, k and v from the other
            macs += ffn + (nf + nt) * 3 * d * d + 2 * 2 * nf * nt * d
        else:  # self layers: q, k, v from the same tokens
            macs += ffn + (nf + nt) * 3 * d * d + 2 * (nf * nf + nt * nt) * d
    return 2.0 * macs


def flops_per_chunk(cfg: dict) -> float:
    return unet_flops_per_chunk(cfg) + transformer_flops_per_chunk(cfg)


def transformer_bytes(cfg: dict, batch: int, freq_tokens: int, time_tokens: int) -> float:
    """float32 bytes one dispatch's transformer must move at least: its
    weights (samplers, layers, norms) once, and the tokens in and out at
    the U-Net's width."""
    c = cfg["channels"] * cfg["growth"] ** (cfg["depth"] - 1)
    d = cfg["bottom_channels"]
    ff = int(d * cfg["t_hidden_scale"])
    params = 4 * (c * d + d) + 2 * 2 * d  # the samplers and the input norms
    params += 2 * cfg["t_layers"] * (4 * d * d + 4 * d + 2 * d * ff + ff + d + 10 * d)
    return 4.0 * (params + 2 * batch * (freq_tokens + time_tokens) * c)


def transformer_bound_s(cfg: dict, batch: int, freq_tokens: int, time_tokens: int) -> float:
    """Least time of one dispatch's transformer at the float32 peak (TF32
    off) and HBM's rate: the larger of the two."""
    flops = batch * transformer_flops_per_chunk(cfg, freq_tokens, time_tokens)
    return max(flops / PEAKS["float32"],
               transformer_bytes(cfg, batch, freq_tokens, time_tokens) / PEAKS["hbm_bytes_per_s"])
