"""MixFXcloner: FiLM-conditioned temporal convolutional network, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/models/tcn.py`` (reference
``mixing_style_transfer/networks/architectures.py:76-234``): 14 dilated conv
blocks (width 128, kernel 15, dilation ``2**(n % 15)``, non-causal), each
``conv(no bias, zero-pad (k-1)*d/2) -> BN -> LeakyReLU -> FiLM`` plus a
grouped 1x1 residual, then a 1x1 output conv and a clamp to [-1, 1].
Receptive field 229,363 samples; 10,547,970 parameters.

Activations between blocks are channels-last ``[B, T, C]`` (after a block
that does not take the kernel, a view of channels-first data; the kernel
takes it contiguous). A block that
meets the dispatch rule (``TCNBlock.uses_kernel``: eval, k = 15, not causal,
``in_ch == out_ch``, 128 channels, dilation >= 8; blocks 3-13 of the full
config) runs as one fused block through ``ops/cuda/tcn_block.py``: the CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor. Blocks 0-2
(block 0 is 2 -> 128 with a grouped residual; dilations 1, 2, 4) stay
``F.conv1d`` plus elementwise ops, as the JAX package leaves them to XLA:
the channels-first body ``TCNBlock.forward_nch`` that training runs too.

Training mode (``model.train()``) runs the stack channels-first
``[B, C, T]``, as the JAX package trains it (``channels_last=False``,
JAX ``train/converter.py:155-163``): every block is cuDNN's conv plus
elementwise ops, with BN on batch statistics (torch's: momentum 0.1, the
unbiased variance into the running variance, statistics in float32 for a
bf16 input); K1 is eval-only. ``remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``, JAX ``nn.remat``), with the
block's BN buffers put back after the recomputation so they update once a
forward.

Input ``x [B, 2, T]``, ``cond [B, 2048]`` (or one per block); output
``[B, 2, T]``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TCNConfig
from ..ops.cuda.tcn_block import fused_block_applicable, tcn_block
from ..utils.profiling import spanned
from .blocks import LEAKY_SLOPE, BatchNorm1d, FiLM
from .fx_encoder import keep_buffers


class TCNBlock(nn.Module):
    """One TCN block (reference ``architectures.py:177-234``) on
    channels-last ``[B, T, in_ch]`` activations."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int,
        dilation: int,
        cond_dim: int,
        causal: bool = False,
    ):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.dilation, self.causal = kernel_size, dilation, causal
        pad = (kernel_size - 1) * dilation
        self.pad_length = pad if causal else pad // 2
        self.conv1 = nn.Conv1d(
            in_ch, out_ch, kernel_size, padding=self.pad_length, dilation=dilation, bias=False
        )
        self.bn = BatchNorm1d(out_ch)
        self.film = FiLM(cond_dim, out_ch)
        # grouped 1x1 residual, groups=in_ch, no bias (architectures.py:216-220)
        self.res = nn.Conv1d(in_ch, out_ch, 1, groups=in_ch, bias=False)

    def uses_kernel(self) -> bool:
        """Dispatch rule of the fused block (JAX ``tcn.py:44-55``)."""
        return (
            not self.training
            and not self.causal
            and self.kernel_size == 15
            and self.in_ch == self.out_ch
            and fused_block_applicable(self.out_ch, self.dilation)
        )

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Channels-last ``[B, T, in_ch] -> [B, T, out_ch]``, in any memory
        layout. A block the kernel does not take runs :meth:`forward_nch`
        and returns a channels-last view of its channels-first result, so a
        run of such blocks moves no activation between layouts."""
        if self.uses_kernel():
            s, t = self.bn.fold()
            r, b = self.film.rb(cond)
            w, wr = self.conv1.weight.permute(2, 1, 0), self.res.weight[:, 0, 0]  # [K, in, out], [out]
            return tcn_block(x.contiguous(), w, s, t, r, b, wr, self.dilation)
        return self.forward_nch(x.transpose(1, 2), cond).transpose(1, 2)

    @spanned("models.tcn.plain")
    def forward_nch(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The block on channels-first ``[B, in_ch, T]`` activations: the
        training layout (JAX ``tcn.py:110-126``), and the body of every
        block that does not take the fused kernel (span
        ``models.tcn.plain``)."""
        h = self.conv1(x)
        if self.causal:
            h = h[..., : -self.pad_length]
        h = self.film(F.leaky_relu(self.bn(h), LEAKY_SLOPE), cond)
        # the residual in h's dtype: under bf16 autocast the stream stays bf16
        x, wr = x.to(h.dtype), self.res.weight[:, 0].to(h.dtype)  # wr [out, 1]
        if self.out_ch != self.in_ch:
            # grouped 1x1 residual: out channel o = i * (out/in) + j reads input channel i
            return h + (x.unsqueeze(2) * wr.view(self.in_ch, -1, 1)).flatten(1, 2)
        return h + x * wr


class MixFXcloner(nn.Module):
    """TCN-based mixing-style converter (reference ``architectures.py:76-147``)."""

    def __init__(self, config: Optional[TCNConfig] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        cfg = self.config = config or TCNConfig()
        blocks = []
        in_ch = cfg.ninputs
        for n in range(cfg.nblocks):
            out_ch = in_ch * cfg.channel_growth if cfg.channel_growth > 1 else cfg.channel_width
            blocks.append(
                TCNBlock(
                    in_ch, out_ch, cfg.kernel_size, cfg.dilation_growth ** (n % cfg.stack_size),
                    cfg.condition_dimension, causal=cfg.causal,
                )
            )
            in_ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        # 1x1 output conv with bias (architectures.py:133)
        self.output = nn.Conv1d(in_ch, cfg.noutputs, 1, bias=True)

    def receptive_field(self) -> int:
        return self.config.receptive_field()

    @spanned("models.tcn")
    def forward(
        self, x: torch.Tensor, cond: Union[torch.Tensor, Sequence[torch.Tensor]]
    ) -> torch.Tensor:
        per_block_cond = isinstance(cond, (list, tuple))
        if self.training:
            return self._forward_train(x, cond if per_block_cond else [cond] * len(self.blocks))
        h = x.transpose(1, 2)  # [B, T, C]
        for n, block in enumerate(self.blocks):
            h = block(h, cond[n] if per_block_cond else cond)
        out = h @ self.output.weight[:, :, 0].T + self.output.bias
        return out.transpose(1, 2).clamp(-1.0, 1.0)  # (architectures.py:145)

    def _forward_train(self, x: torch.Tensor, conds: Sequence[torch.Tensor]) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        h = x
        for block, c in zip(self.blocks, conds):
            if remat:
                ctx = (lambda b=block: (contextlib.nullcontext(), keep_buffers(b)))
                h = checkpoint(block.forward_nch, h, c, use_reentrant=False, context_fn=ctx)
            else:
                h = block.forward_nch(h, c)
        return self.output(h).clamp(-1.0, 1.0)


# alias matching the reference class name
TCNModel = MixFXcloner
