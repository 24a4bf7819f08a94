"""Faults planted in the program for the tests that must see ``correct``
come out false: each breaks the timed path where it produces its answer."""
from __future__ import annotations


def plant(name) -> None:
    if name is None:
        return
    FAULTS[name]()


def _altered_mixture():
    """A stem's converted audio scaled by 0.9 before the sum."""
    from music_mixing_style_transfer_tpu_torch.infer.pipeline import MixingStyleTransfer

    finish = MixingStyleTransfer._finish_pcm

    def altered(self, y, *a, **k):
        return finish(self, y * 0.9, *a, **k)

    MixingStyleTransfer._finish_pcm = altered


def _frozen_state():
    """A train step that computes the loss and returns the state unchanged."""
    import torch

    from music_mixing_style_transfer_tpu_torch.train.converter import converter_loss_fn
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedConverterPipeline

    def train(self, state, views):
        with torch.no_grad():
            loss = converter_loss_fn(state.model, self.encoder, *views, self.rms_weight)
        state.step += 1
        return state, loss

    FusedConverterPipeline._train = train


def _half_batch():
    """A train step on the first half of the triplets, the mean over them."""
    from music_mixing_style_transfer_tpu_torch.train.fused import FusedConverterPipeline

    train = FusedConverterPipeline._train

    def half(self, state, views):
        return train(self, state, tuple(v[: v.shape[0] // 2] for v in views))

    FusedConverterPipeline._train = half


FAULTS = {"altered_mixture": _altered_mixture, "frozen_state": _frozen_state, "half_batch": _half_batch}
