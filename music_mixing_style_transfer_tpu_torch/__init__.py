"""PyTorch/CUDA port of ``music_mixing_style_transfer_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's layout; each module has its counterpart at the
same relative path there. The package imports ``torch``, ``numpy`` and the
stdlib only, never JAX or the JAX package.

- ``models``: FXencoder and MixFXcloner as ``nn.Module``s whose parameter
  names follow the published reference state dicts.
- ``ops.cuda``: hand-written CUDA kernels for Hopper (``csrc/``), each with
  its plain PyTorch version beside it.
- ``infer``: the whole-song style-transfer pipeline, its CLI and the
  feature-extraction CLI; ``serve``: the HTTP server.
- ``normalize``: FX normalization, batched and per channel.
- ``metrics`` and ``tools``: evaluation and the inference profiler.
- ``data``: WAV I/O and song segmentation (numpy).
- ``examples``: the demo (synthetic stems through the whole stack).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

SAMPLE_RATE = 44100
STEMS = ("drums", "bass", "other", "vocals")
EMBED_DIM = 2048
