"""Configuration tree for the PyTorch/CUDA mixing-style-transfer port.

The port's own copy of ``music_mixing_style_transfer_tpu/config.py``: the
same dataclasses, fields and defaults (a test holds the two equal), so the
port never imports the JAX package. Single dataclass-based config
(YAML-loadable) replacing the reference's three mechanisms (argparse groups
+ ``networks/configs.yaml`` + in-class constants; see reference
``inference/style_transfer.py:346-389``,
``mixing_style_transfer/networks/configs.yaml``).

``InferenceConfig.sequence_parallel`` selects the time-sharded conversion
of a mesh engine (``infer/seqpar.py``). The ``TrainConfig`` mesh settings
are kept for compatibility and ignored: the port's trainers take their
ranks from the ``torch.distributed`` process group (``parallel/mesh.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FXencoderConfig:
    """FXencoder architecture (reference ``networks/configs.yaml:5-15``).

    Stereo in -> 12 residual conv blocks -> global average pool -> 2048-D
    style embedding. ~81.4M parameters.
    """

    channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 256, 512, 512, 1024, 1024, 2048, 2048)
    kernels: Tuple[int, ...] = (25, 25, 15, 15, 10, 10, 10, 10, 5, 5, 5, 5)
    strides: Tuple[int, ...] = (4, 4, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1)
    dilation: Tuple[int, ...] = (1,) * 12
    bias: bool = True
    norm: str = "batch"
    conv_block: str = "res"
    activation: str = "relu"
    in_channels: int = 2

    @property
    def embed_dim(self) -> int:
        return self.channels[-1]


@dataclass(frozen=True)
class TCNConfig:
    """MixFXcloner / TCN architecture (reference ``networks/configs.yaml:19-29``).

    14 dilated conv blocks, width 128, kernel 15, dilation 2**(n % 15)
    -> receptive field 229,363 samples = 5.2 s @ 44.1 kHz. ~10.5M params.
    """

    condition_dimension: int = 2048
    nblocks: int = 14
    dilation_growth: int = 2
    kernel_size: int = 15
    channel_width: int = 128
    stack_size: int = 15
    causal: bool = False
    ninputs: int = 2
    noutputs: int = 2
    channel_growth: int = 1
    grouped: bool = False

    def receptive_field(self) -> int:
        """Receptive field in samples (reference ``architectures.py:149-155``)."""
        rf = self.kernel_size
        for n in range(1, self.nblocks):
            dilation = self.dilation_growth ** (n % self.stack_size)
            rf += (self.kernel_size - 1) * dilation
        return rf


@dataclass(frozen=True)
class NormalizationConfig:
    """Audio-effects normalization settings (reference
    ``mixing_manipulator/data_normalization.py:26-68``)."""

    effects: Tuple[str, ...] = ("loudness", "eq", "compression", "imager", "loudness")
    stems: Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    sample_rate: int = 44100
    fft_size: int = 2 ** 16
    hop_length: int = 2 ** 14
    ntaps: int = 1001
    lufs: float = -30.0
    min_db: float = -40.0
    comp_peak_norm: float = -10.0
    comp_min_th: float = -40.0
    comp_max_ratio: int = 20
    comp_percentile: int = 75
    comp_use_expander: bool = False
    comp_true_peak: bool = False
    # per-stem compressor settings: (attack ms, release ms, ratio, n_mels)
    comp_settings: Dict[str, Tuple[float, float, int, int]] = field(
        default_factory=lambda: {
            "vocals": (7.5, 400.0, 4, 128),
            "drums": (10.0, 180.0, 6, 128),
            "bass": (10.0, 500.0, 5, 16),
            "other": (15.0, 666.0, 4, 128),
        }
    )


@dataclass(frozen=True)
class InferenceConfig:
    """Style-transfer inference pipeline settings (reference
    ``inference/style_transfer.py:346-383``)."""

    sample_rate: int = 44100
    segment_length: int = 2 ** 19
    segment_length_ref: int = 2 ** 19
    batch_size: int = 1
    instruments: Tuple[str, ...] = ("drums", "bass", "other", "vocals")
    stem_level_directory_name: str = "separated"
    separation_model: str = "mdx_extra"
    save_each_inst: bool = False
    do_not_separate: bool = False
    normalize_input: bool = True
    interpolation: bool = False
    interpolate_segments: int = 30
    input_file_name: str = "input"
    reference_file_name: str = "reference"
    reference_file_name_2interpolate: str = "reference_B"
    # compute dtype for the network forward passes ("float32" or "bfloat16")
    dtype: str = "float32"
    # context halo per segment (samples) to suppress boundary artifacts;
    # 0 = reference behaviour (independent zero-context segments)
    segment_halo: int = 0
    # device-resident whole-song path: upload stems once (int16 PCM, or
    # float32 for 24/32-bit/float sources), normalize/segment/encode/convert/
    # sum on device, download one int16 mixture (5x less host<->device
    # traffic; covers the plain and interpolation modes, falls back to the
    # per-stage host path only for segment_halo > 0)
    pcm_fast_path: bool = True
    # with a mesh engine: convert each whole stem in ONE sequence-sharded
    # forward (time axis over chips, ppermute conv halos) — boundary-free
    # output, ~3% redundant compute (infer/seqpar.py). Ignored without a
    # mesh and in interpolation mode (its conditioning varies along time).
    sequence_parallel: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (contrastive + converter)."""

    batch_size_per_device: int = 4
    num_strong_negatives: int = 1
    temperature: float = 0.1
    segment_length: int = 2 ** 17
    segment_length_ref: int = 2 ** 18
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    eps: float = 1e-7
    seed: int = 0
    # LR schedule: "constant" | "warmup_cosine" | "step" (reference-style
    # epoch decay). The schedule is a pure function of the optax step counter
    # (inside opt_state), so orbax resume reproduces the unbroken-run LR
    # sequence exactly — the analogue of the reference checkpointing its
    # torch scheduler state (modules/training_utils.py:13-29).
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 10_000  # cosine horizon (total steps)
    lr_end_factor: float = 0.0  # final LR as a fraction of peak (cosine)
    lr_step_size: int = 1_000  # steps between decays ("step")
    lr_gamma: float = 0.5  # decay factor ("step")
    # "bfloat16" runs model fwd/bwd on the MXU's fast passes while params,
    # optimizer state, and losses stay float32 (measured ~2x converter step)
    compute_dtype: str = "float32"
    # rematerialize conv blocks on backward (jax.checkpoint): ~1 extra
    # forward of FLOPs for O(1-block) activation HBM — enables longer
    # segments / bigger per-chip batches than activations would otherwise fit
    remat: bool = False
    # FX apply-probability schedule (probability scheduling from the paper)
    apply_prob: Dict[str, float] = field(
        default_factory=lambda: {"eq": 0.9, "comp": 0.9, "pan": 0.3, "imager": 0.8, "gain": 0.5}
    )
    reverb_prob: Dict[str, float] = field(
        default_factory=lambda: {"drums": 0.5, "bass": 0.01, "vocals": 0.9, "other": 0.7}
    )
    # mesh axis names: data parallel over 'data'
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class Config:
    encoder: FXencoderConfig = field(default_factory=FXencoderConfig)
    converter: TCNConfig = field(default_factory=TCNConfig)
    normalization: NormalizationConfig = field(default_factory=NormalizationConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _update(cfg, updates: Dict[str, Any]):
    kw = {}
    for k, v in updates.items():
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _update(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a config, optionally updated from a YAML file and/or dict."""
    cfg = Config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path, "r") as f:
            data = yaml.safe_load(f) or {}
        cfg = _update(cfg, data)
    if overrides:
        cfg = _update(cfg, overrides)
    return cfg
