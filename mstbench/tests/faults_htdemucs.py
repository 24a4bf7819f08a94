"""Faults planted in the program's separator (``models/htdemucs.py``) for
the tests that must see ``correct`` come out false in the ``mixes`` cell."""
from __future__ import annotations


def plant(name) -> None:
    if name is not None:
        FAULTS[name]()


def _cross_layers_skipped():
    """Each cross-attention layer returns its queries unchanged."""
    from music_mixing_style_transfer_tpu_torch.models import htdemucs

    htdemucs.CrossTransformerEncoderLayer.forward = lambda self, q, k: q


def _time_branch_dropped():
    """The waveform branch's last decoder gives zeros: only the spectrogram
    branch reaches the output."""
    import torch

    from music_mixing_style_transfer_tpu_torch.models import htdemucs

    forward = htdemucs.HDecLayer.forward

    def dropped(self, x, skip, length):
        z = forward(self, x, skip, length)
        return torch.zeros_like(z) if self.last and not self.freq else z

    htdemucs.HDecLayer.forward = dropped


def _frequency_embedding_dropped():
    """The frequency embedding adds nothing after the first encoder."""
    import torch

    from music_mixing_style_transfer_tpu_torch.models import htdemucs

    htdemucs.ScaledEmbedding.forward = lambda self, x: torch.zeros(
        x.shape + (self.embedding.embedding_dim,), device=x.device)


def _outputs_in_bf16():
    """The separated sources rounded to bfloat16."""
    import torch

    from music_mixing_style_transfer_tpu_torch.models import htdemucs

    separate = htdemucs.HTDemucsSeparator._separate

    def rounded(self, mix):
        return separate(self, mix).to(torch.bfloat16).float()

    htdemucs.HTDemucsSeparator._separate = rounded


FAULTS = {"cross_layers_skipped": _cross_layers_skipped,
          "time_branch_dropped": _time_branch_dropped,
          "frequency_embedding_dropped": _frequency_embedding_dropped,
          "outputs_in_bf16": _outputs_in_bf16}
