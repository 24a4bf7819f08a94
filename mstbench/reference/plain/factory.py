"""FX-chain factories mirroring the reference chain topology, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/fx/factory.py``
(reference ``mixing_manipulator/audio_effects_chain.py:17-164``), with the
same stage trees, probabilities and defaults.

Per-instrument chain (``create_inst_effects_augmentation_chain``):
  1. [eq (p=.9), comp (p=.9)] in shuffled order
  2. [pan (p=.3), imager (p=.8)] in shuffled order
  3. reverb stage:
     - drums: two parallel branches — low-passed reverb (high_shelf -50 dB
       @100 Hz) at p=reverb*0.01 with dry weight 0.8, and high-passed reverb
       (low_shelf -50 dB @100 Hz) at p=reverb with dry weight 0.6
     - others: single parallel reverb with random dry weight in (0, 0.5)
  4. gain (p=.5)

Every processor except Gain and sub-chains is RMS-normalized after
application (``audio_effects_chain.py:92``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .chain import AugmentationChain, Stage
from .processors import (
    AlgorithmicReverb,
    Compressor,
    ConvolutionalReverb,
    Distortion,
    Equaliser,
    Gain,
    MidSideImager,
    Monauralize,
    Panner,
    SwapChannels,
)

DEFAULT_APPLY_PROB = {"eq": 0.9, "comp": 0.9, "pan": 0.3, "imager": 0.8, "gain": 0.5}
DEFAULT_REVERB_PROB = {"drums": 0.5, "bass": 0.01, "vocals": 0.9, "other": 0.7}


def _make_processor(name: str, sample_rate: int, ir_bank: Optional[np.ndarray]):
    name = name.lower()
    if name == "gain":
        return Gain()
    if "eq" in name:
        return Equaliser(sample_rate=sample_rate)
    if "comp" in name:
        return Compressor(sample_rate=sample_rate)
    if "expand" in name:
        # upward expander == compressor with ratio < 1 (the reference names
        # an Expander in its factory but never defines it, audio_effects_chain.py:53)
        return Compressor(sample_rate=sample_rate, ratio_range=(1.0 / 40.0, 1.0 / 4.0))
    if "pan" in name:
        return Panner()
    if "image" in name:
        return MidSideImager()
    if "algorithmic" in name:
        return AlgorithmicReverb(sample_rate=sample_rate)
    if "reverb" in name:
        if ir_bank is None:
            return AlgorithmicReverb(sample_rate=sample_rate)
        return ConvolutionalReverb(ir_bank, sample_rate=sample_rate)
    if "distortion" in name:
        return Distortion()
    if "swap" in name:
        return SwapChannels()
    if "mono" in name:
        return Monauralize()
    raise ValueError(f"unknown fx name: {name}")


def create_effects_augmentation_chain(
    effects: Sequence,
    ir_bank: Optional[np.ndarray] = None,
    sample_rate: int = 44100,
    shuffle: bool = False,
    parallel: bool = False,
    parallel_weight_factor: Optional[float] = None,
) -> AugmentationChain:
    """Build a chain from ``effects`` — each entry a name, (name, prob) tuple,
    processor instance, or nested chain (reference ``audio_effects_chain.py:17-95``)."""
    stages = []
    for fx in effects:
        prob, prob_name, prob_scale = 1.0, None, 1.0
        if isinstance(fx, tuple):
            if len(fx) == 2:
                fx, prob = fx
            else:
                # (fx, prob, prob_name[, prob_scale]): the stage's gate can
                # then be driven at draw time by the chain's `probs` dict
                fx, prob, prob_name, *rest = fx
                prob_scale = rest[0] if rest else 1.0
        if isinstance(fx, str):
            fx = _make_processor(fx, sample_rate, ir_bank)
        rms_norm = not (isinstance(fx, AugmentationChain) or getattr(fx, "name", "") == "gain")
        stages.append(Stage(fx, prob, rms_norm, prob_name, prob_scale))
    return AugmentationChain(
        stages, shuffle=shuffle, parallel=parallel,
        parallel_weight_factor=parallel_weight_factor,
    )


def create_inst_effects_augmentation_chain(
    inst: str,
    apply_prob_dict: Optional[Dict[str, float]] = None,
    ir_bank: Optional[np.ndarray] = None,
    algorithmic: bool = False,
    sample_rate: int = 44100,
) -> AugmentationChain:
    """Per-instrument FXmanipulator (reference ``audio_effects_chain.py:99-164``)."""
    p = dict(DEFAULT_APPLY_PROB)
    if apply_prob_dict:
        p.update(apply_prob_dict)
    if "reverb" not in p:
        p["reverb"] = DEFAULT_REVERB_PROB.get(inst, 0.7)

    reverb_name = "algorithmic" if algorithmic else "reverb"

    eq_comp = create_effects_augmentation_chain(
        [("eq", p["eq"], "eq"), ("comp", p["comp"], "comp")],
        ir_bank=ir_bank, sample_rate=sample_rate, shuffle=True,
    )
    pan_image = create_effects_augmentation_chain(
        [("pan", p["pan"], "pan"), ("imager", p["imager"], "imager")],
        ir_bank=ir_bank, sample_rate=sample_rate, shuffle=True,
    )

    if inst == "drums":
        low_pass_eq = Equaliser(
            sample_rate=sample_rate,
            bands=("high_shelf",),
            fixed_params={"high_shelf_gain": -50.0, "high_shelf_freq": 100.0},
        )
        reverb_low = create_effects_augmentation_chain(
            [low_pass_eq, (reverb_name, p["reverb"] * 0.01, "reverb", 0.01)],
            ir_bank=ir_bank, sample_rate=sample_rate,
            parallel=True, parallel_weight_factor=0.8,
        )
        high_pass_eq = Equaliser(
            sample_rate=sample_rate,
            bands=("low_shelf",),
            fixed_params={"low_shelf_gain": -50.0, "low_shelf_freq": 100.0},
        )
        reverb_high = create_effects_augmentation_chain(
            [high_pass_eq, (reverb_name, p["reverb"], "reverb")],
            ir_bank=ir_bank, sample_rate=sample_rate,
            parallel=True, parallel_weight_factor=0.6,
        )
        reverb_stage = create_effects_augmentation_chain(
            [reverb_low, reverb_high], ir_bank=ir_bank, sample_rate=sample_rate
        )
    else:
        reverb_stage = create_effects_augmentation_chain(
            [(reverb_name, p["reverb"], "reverb")],
            ir_bank=ir_bank, sample_rate=sample_rate, parallel=True,
        )

    return create_effects_augmentation_chain(
        [eq_comp, pan_image, reverb_stage, ("gain", p["gain"], "gain")],
        ir_bank=ir_bank, sample_rate=sample_rate,
    )


def create_reverb_send_chain(
    low_shelf_gain_db: float = 0.0,
    high_shelf_gain_db: Optional[float] = None,
    ir_bank: Optional[np.ndarray] = None,
    sample_rate: int = 44100,
    parallel: bool = True,
    shuffle: bool = False,
    bands: Sequence[str] = ("low_shelf", "high_shelf"),
) -> AugmentationChain:
    """Reverb send: band-shaping EQ into a reverb, mixed in parallel
    (reference ``get_reverb_send``, ``utils_data_normalization.py:436-477``,
    used for dataset preparation)."""

    gain = low_shelf_gain_db
    fixed = {}
    for band in bands:
        fixed[f"{band}_gain"] = gain if high_shelf_gain_db is None else (
            gain if band == "low_shelf" else high_shelf_gain_db
        )
    eq = Equaliser(sample_rate=sample_rate, bands=tuple(bands), fixed_params=fixed,
             gain_range=(gain, gain))
    reverb = _make_processor("reverb", sample_rate, ir_bank)
    return AugmentationChain(
        [Stage(eq, 1.0, False), Stage(reverb, 1.0, False)],
        shuffle=shuffle,
        parallel=parallel,
    )


def make_instrument_manipulators(
    instruments: Sequence[str] = ("drums", "bass", "other", "vocals"),
    apply_prob_dict: Optional[Dict[str, float]] = None,
    reverb_prob: Optional[Dict[str, float]] = None,
    ir_bank: Optional[np.ndarray] = None,
    sample_rate: int = 44100,
) -> Dict[str, AugmentationChain]:
    """Chain per instrument with per-inst reverb probabilities
    (reference ``data_loader.py:148-178``)."""
    rp = dict(DEFAULT_REVERB_PROB)
    if reverb_prob:
        rp.update(reverb_prob)
    out = {}
    for inst in instruments:
        p = dict(apply_prob_dict or DEFAULT_APPLY_PROB)
        p["reverb"] = rp.get(inst, 0.7)
        out[inst] = create_inst_effects_augmentation_chain(
            inst, apply_prob_dict=p, ir_bank=ir_bank, sample_rate=sample_rate
        )
    return out
