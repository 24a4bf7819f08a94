"""Mixing-style-transfer inference pipeline, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/infer/pipeline.py``
(reference ``inference/style_transfer.py:27-301``):

- whole songs are cut into ``[n_segments, 2, L]`` and run as ONE batched
  forward; the segment axis is padded to a small set of bucket sizes;
- reference embeddings are masked means over real segments, on the device;
- ``transfer_song_pcm`` uploads int16 stem stacks once, FX-normalizes them
  on the device (with a normalizer and ``normalize_input``), converts every
  stem's segments in one converter dispatch, and sums and quantizes on the
  device.

Entry points run on ``device="cuda"`` and raise when there is no card,
unless the caller passes ``device="cpu"``. In ``bfloat16`` every parameter,
BN statistics and FiLM weights included, is cast to bfloat16, as in the JAX
engine; the fused blocks fold BN and FiLM in float32 from the cast values.
The engine owns its precision: its forward passes run with TF32 off in
cuDNN convolutions and matmuls (``_engine_forward``), whatever PyTorch's
process-wide flags say, and they are restored afterwards. The fused blocks
(K1) compute their float32 products as 3xTF32 on the tensor cores, at
float32's accuracy (measured against float64 in ``PERF.md``).

FX normalization always runs in float32, also under a bf16 engine.

With a ``mesh`` (``parallel/mesh.py``; JAX ``pipeline.py:55-71``), one
process drives every shard, as the JAX controller does (no
``torch.distributed``): the weights are replicated once on each distinct
device of the mesh, each segment batch is rounded up to a multiple of the
mesh size and split over the shards, each shard's encoder and converter
pass runs on its own device, and the results are gathered on the first
device, where the means, the sum and the int16 quantization run. With
``InferenceConfig.sequence_parallel`` the PCM path converts each whole
stem in one time-sharded forward instead (``infer/seqpar.py``).

``transfer_mix_pcm`` takes ``[2, T]`` mixtures instead of stems: it
separates them on the device with the HTDemucs separator it was given
(``models/htdemucs.py``) and hands the stem stacks, still on the
device, to the same device stages. ``run_directory`` and the CLI take that
path when ``separation_model == "htdemucs"`` and ``do_not_separate`` is
false; any other separation model shells out to the ``demucs`` CLI, as the
reference does (``separate_with_demucs``).

Traced (``utils/profiling.py``), ``transfer_song_pcm`` and
``transfer_mix_pcm`` are the span ``infer.request`` (separation included),
with ``infer.upload`` around each host-to-device copy of a stem stack and
``infer.finish`` around the sum, quantization and download; the counter
``infer.request`` records ``{"samples": T, "ok": bool}`` a call (``T`` the
input's length), and ``infer.segments`` ``(model, real, dispatched)`` where
the PCM path pads a batch of segments to its bucket.
"""
from __future__ import annotations

import copy
import functools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FXencoderConfig, InferenceConfig, TCNConfig
from ..data.segments import pad_to_batches, reassemble_song, segment_song, segment_song_halo
from ..data.wavio import read_wav_stereo_ct, read_wav_stereo_ct_i16, write_wav
from ..models import FXencoder, MixFXcloner
from ..models.checkpoints import load_model_state
from ..models.fast_init import fast_init
from ..parallel.mesh import Mesh
from ..utils import profiling
from ..utils.device import full_float32, resolve_device
from ..utils.logging import get_logger

log = get_logger(__name__)


def _bucket(n: int, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _build(module: torch.nn.Module, ckpt: Optional[str], seed: int, name: str):
    """``module`` (built on the meta device) with a checkpoint's weights, or
    seeded random ones when ``ckpt`` is missing; on the CPU, in float32."""
    module = module.to_empty(device="cpu")
    if ckpt and os.path.exists(ckpt):
        load_model_state(ckpt, module)
        log.info("loaded %s checkpoint: %s", name, ckpt)
    else:
        if ckpt:
            log.warning("%s checkpoint %s missing - random init", name, ckpt)
        fast_init(module, seed=seed)
    return module.eval()


def _engine_forward(fn):
    """Run ``fn`` in inference mode with TF32 off in cuDNN convolutions and
    matmuls; the process-wide flags are restored afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_float32(), torch.inference_mode():
            return fn(*args, **kwargs)

    return wrapped


class StyleTransferEngine:
    """FXencoder + MixFXcloner on one device, or replicated over a mesh's
    devices, in full float32 or bfloat16."""

    def __init__(
        self,
        encoder_cfg: Optional[FXencoderConfig] = None,
        converter_cfg: Optional[TCNConfig] = None,
        ckpt_path_enc: Optional[str] = None,
        ckpt_path_conv: Optional[str] = None,
        dtype: str = "float32",
        seed: int = 0,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        """``mesh``: shard every segment batch over its devices (weights
        replicated, segment buckets rounded up to the mesh size); the
        engine's ``device`` is then the mesh's first, where results are
        gathered, and ``device`` is not used."""
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0] if mesh is not None else device)
        self._n_shards = mesh.size if mesh is not None else 1
        self.encoder_cfg = encoder_cfg or FXencoderConfig()
        self.converter_cfg = converter_cfg or TCNConfig()
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        with torch.device("meta"):
            encoder = FXencoder(self.encoder_cfg)
            converter = MixFXcloner(self.converter_cfg)
        encoder = _build(encoder, ckpt_path_enc, seed, "FXencoder")
        converter = _build(converter, ckpt_path_conv, seed + 1, "MixFXcloner")
        self.encoder = encoder.to(self.device, self.dtype)
        self.converter = converter.to(self.device, self.dtype)
        # one replica of the weights on each distinct device of the mesh
        self._replicas = {self.device: (self.encoder, self.converter)}
        for dev in mesh.distinct if mesh is not None else ():
            if dev not in self._replicas:
                self._replicas[dev] = (copy.deepcopy(encoder).to(dev, self.dtype),
                                       copy.deepcopy(converter).to(dev, self.dtype))

    def replica(self, dev: torch.device) -> Tuple[FXencoder, MixFXcloner]:
        """The (encoder, converter) on ``dev``."""
        return self._replicas[dev]

    def _pad_bucket(self, n: int) -> int:
        """Bucket size for n segments, rounded to a multiple of the mesh
        size (JAX ``pipeline.py:171-175``)."""
        k = self._n_shards
        return -(-_bucket(n) // k) * k

    def _shards(self, *batches):
        """``(device, *parts)`` for each shard: the batches split into the
        mesh's equal blocks on dim 0 (whole, on the engine's device,
        without a mesh)."""
        if self.mesh is None:
            return [(self.device, *batches)]
        parts = [torch.as_tensor(b).chunk(self._n_shards) for b in batches]
        return [(dev, *(p[i] for p in parts)) for i, dev in enumerate(self.mesh.devices)]

    def _gather(self, outs) -> torch.Tensor:
        """The shards' results on the engine's device, in shard order."""
        return torch.cat([o.to(self.device, non_blocking=True) for o in outs])

    def _in(self, segments, dev=None) -> torch.Tensor:
        """Segments onto ``dev`` (the engine's device by default) in the
        engine dtype; int16 PCM is dequantized there (``/32768``) in the
        engine dtype."""
        x = torch.as_tensor(segments).to(dev or self.device, non_blocking=True)
        if x.dtype == torch.int16:
            return x.to(self.dtype) * (1.0 / 32768.0)
        return x.to(self.dtype)

    def _embed(self, segments) -> torch.Tensor:
        """FXencoder embeddings ``[N, D]`` (float32) of ``[N, 2, L]``, each
        shard on its device, gathered on the engine's device."""
        return self._gather(
            self.replica(dev)[0](self._in(part, dev)).float() for dev, part in self._shards(segments)
        )

    @_engine_forward
    def _encode_mean(self, segments, mask) -> torch.Tensor:
        """``[N, 2, L]`` -> masked mean embedding ``[D]`` (float32)."""
        emb = self._embed(segments)
        w = torch.as_tensor(mask, device=self.device).float()[:, None]
        return (emb * w).sum(0) / w.sum().clamp_min(1.0)

    @_engine_forward
    def _encode_group_mean(self, segments, group_onehot) -> torch.Tensor:
        """``[N, 2, L]`` + group one-hot ``[G, N]`` -> per-group means ``[G, D]``."""
        emb = self._embed(segments)
        w = torch.as_tensor(group_onehot, device=self.device).float()
        return (w @ emb) / w.sum(1, keepdim=True).clamp_min(1.0)

    @_engine_forward
    def _convert_multi(self, segments, embeddings) -> torch.Tensor:
        """Converter over ``[N, 2, L]`` with one embedding per segment
        ``[N, D]``; returns float32 ``[N, 2, L]``, each shard converted on
        its device and gathered on the engine's."""
        return self._gather(
            self.replica(dev)[1](self._in(x, dev), self._in(cond, dev)).float()
            for dev, x, cond in self._shards(segments, embeddings)
        )

    def _convert(self, segments, embedding) -> torch.Tensor:
        """Converter over ``[N, 2, L]`` with one embedding ``[D]`` for all."""
        emb = torch.as_tensor(embedding)
        return self._convert_multi(segments, emb[None, :].expand(len(segments), -1))

    # ------------------------------------------------------------------
    def embed_song(self, audio: np.ndarray, segment_length: int) -> np.ndarray:
        """Mean FXencoder embedding of a whole ``[2, T]`` song. Stems up to
        twice the segment length are encoded whole (reference
        ``style_transfer.py:133``), bucketed to 4096 samples."""
        T = audio.shape[-1]
        if T <= 2 * segment_length:
            Tb = max(-(-T // 4096) * 4096, 4096)
            segments = np.pad(audio, ((0, 0), (0, Tb - T)))[None]
        else:
            segments, _ = segment_song(audio, segment_length)
        n_valid = segments.shape[0]
        segments, _ = pad_to_batches(segments, self._pad_bucket(n_valid))
        mask = np.arange(segments.shape[0]) < n_valid
        return _numpy(self._encode_mean(segments, mask))

    def convert_song(
        self,
        audio: np.ndarray,
        embedding: np.ndarray,
        segment_length: int,
        halo: int = 0,
    ) -> np.ndarray:
        """Convert a whole ``[2, T]`` song conditioned on one embedding;
        ``halo > 0`` gives every segment that many samples of real context
        on each side and trims it from the output."""
        T = audio.shape[-1]
        if halo <= 0:
            if T < segment_length:
                audio = np.pad(audio, ((0, 0), (0, segment_length - T)))
            segments, _ = segment_song(audio, segment_length)
            n_valid = segments.shape[0]
            segments, _ = pad_to_batches(segments, self._pad_bucket(n_valid))
            out = self._convert(segments, embedding)
            return reassemble_song(_numpy(out)[:n_valid], T)

        segs = segment_song_halo(audio, segment_length, halo)
        n_valid = segs.shape[0]
        segs, _ = pad_to_batches(segs, self._pad_bucket(n_valid))
        out = _numpy(self._convert(segs, embedding))[:n_valid, :, halo : halo + segment_length]
        return reassemble_song(out, T)

    def convert_song_interpolated(
        self,
        audio: np.ndarray,
        emb_a: np.ndarray,
        emb_b: np.ndarray,
        n_chunks: int,
    ) -> np.ndarray:
        """Interpolation mode: ``n_chunks`` equal chunks, chunk i conditioned
        on ``w*embA + (1-w)*embB`` with ``w = (N-1-i)/(N-1)`` (reference
        ``style_transfer.py:181-270``)."""
        T = audio.shape[-1]
        chunk_len = T // n_chunks + 1
        segments, _ = segment_song(audio, chunk_len)
        n_valid = segments.shape[0]
        segments, _ = pad_to_batches(segments, self._pad_bucket(n_valid))
        w = np.clip((n_chunks - 1 - np.arange(segments.shape[0])) / max(n_chunks - 1, 1), 0, 1)
        embs = w[:, None] * emb_a[None, :] + (1 - w)[:, None] * emb_b[None, :]
        out = self._convert_multi(segments, embs.astype(np.float32))
        return reassemble_song(_numpy(out)[:n_valid], T)


class MixingStyleTransfer:
    """Whole-song, stem-wise mixing style transfer
    (reference ``Mixing_Style_Transfer_Inference``)."""

    def __init__(
        self,
        engine: StyleTransferEngine,
        inference_cfg: Optional[InferenceConfig] = None,
        normalizer=None,
        separator=None,
    ):
        """``separator``: the in-process separator for ``transfer_mix_pcm``
        (``models.htdemucs.HTDemucsSeparator``); without one, that path
        raises."""
        self.engine = engine
        self.cfg = inference_cfg or InferenceConfig()
        self.normalizer = normalizer
        self.separator = separator

    def separates_in_process(self) -> bool:
        """Whether the directory path reads mixtures and separates them
        here (HTDemucs) rather than reading stems."""
        return not self.cfg.do_not_separate and self.cfg.separation_model == "htdemucs"

    # ------------------------------------------------------------------
    def transfer_stems(
        self,
        input_stems: Dict[str, np.ndarray],
        reference_stems: Dict[str, np.ndarray],
        reference_stems_b: Optional[Dict[str, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Host path: FX-normalize the float stems (with a normalizer and
        ``normalize_input``), then convert them toward the reference's style.
        Returns ``(mixture [2, T], per-stem outputs)``."""
        cfg = self.cfg
        if self.normalizer is not None and cfg.normalize_input:
            t0 = time.perf_counter()
            if hasattr(self.normalizer, "normalize_stems"):
                normalized = self.normalizer.normalize_stems(
                    {i: input_stems[i] for i in cfg.instruments}
                )
            else:  # a per-channel normalizer (normalize_audio only)
                normalized = {
                    inst: self.normalizer.normalize_audio(x, src=inst)
                    for inst, x in input_stems.items()
                }
            input_stems = {i: np.clip(v, -1.0, 1.0) for i, v in normalized.items()}
            log.info("fx-normalization: %.1fs", time.perf_counter() - t0)
        if reference_stems_b is None:
            t0 = time.perf_counter()
            out = self._transfer_batched(input_stems, reference_stems)
            log.info("embed+convert: %.1fs", time.perf_counter() - t0)
            return out

        outputs: Dict[str, np.ndarray] = {}
        mixture = None
        for inst in cfg.instruments:
            emb_a = self.engine.embed_song(reference_stems[inst], cfg.segment_length_ref)
            emb_b = self.engine.embed_song(reference_stems_b[inst], cfg.segment_length_ref)
            y = self.engine.convert_song_interpolated(
                input_stems[inst], emb_a, emb_b, cfg.interpolate_segments
            )
            outputs[inst] = y
            mixture = y if mixture is None else mixture + y
        return mixture, outputs

    def _transfer_batched(
        self,
        input_stems: Dict[str, np.ndarray],
        reference_stems: Dict[str, np.ndarray],
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        cfg = self.cfg
        insts = list(cfg.instruments)

        # reference embeddings: stems long enough to segment share one
        # grouped encoder dispatch; short stems are encoded whole
        long_insts = [
            i for i in insts if reference_stems[i].shape[-1] > 2 * cfg.segment_length_ref
        ]
        emb_by_inst: Dict[str, np.ndarray] = {}
        if long_insts:
            ref_segs, ref_groups = [], []
            for gi, inst in enumerate(long_insts):
                segs, _ = segment_song(reference_stems[inst], cfg.segment_length_ref)
                ref_segs.append(segs)
                ref_groups.extend([gi] * segs.shape[0])
            ref_all = np.concatenate(ref_segs, axis=0)
            ref_all, _ = pad_to_batches(ref_all, self.engine._pad_bucket(ref_all.shape[0]))
            onehot = np.zeros((len(long_insts), ref_all.shape[0]), np.float32)
            for j, g in enumerate(ref_groups):
                onehot[g, j] = 1.0
            grouped = _numpy(self.engine._encode_group_mean(ref_all, onehot))
            emb_by_inst.update({i: grouped[gi] for gi, i in enumerate(long_insts)})
        for inst in insts:
            if inst not in emb_by_inst:
                emb_by_inst[inst] = self.engine.embed_song(
                    reference_stems[inst], cfg.segment_length_ref
                )
        embs = np.stack([emb_by_inst[i] for i in insts])  # [n_inst, D]

        # input: one converter dispatch over all stems' segments
        halo = int(cfg.segment_halo or 0)
        in_segs, in_lens, in_counts = [], [], []
        for inst in insts:
            x = input_stems[inst]
            in_lens.append(x.shape[-1])
            if halo > 0:
                segs = segment_song_halo(x, cfg.segment_length, halo)
            else:
                if x.shape[-1] < cfg.segment_length:
                    x = np.pad(x, ((0, 0), (0, cfg.segment_length - x.shape[-1])))
                segs, _ = segment_song(x, cfg.segment_length)
            in_segs.append(segs)
            in_counts.append(segs.shape[0])
        in_all = np.concatenate(in_segs, axis=0)
        in_all, _ = pad_to_batches(in_all, self.engine._pad_bucket(in_all.shape[0]))
        cond = np.zeros((in_all.shape[0], embs.shape[1]), np.float32)
        ofs = 0
        for gi, cnt in enumerate(in_counts):
            cond[ofs : ofs + cnt] = embs[gi]
            ofs += cnt
        out = _numpy(self.engine._convert_multi(in_all, cond))

        outputs: Dict[str, np.ndarray] = {}
        mixture = None
        ofs = 0
        for inst, cnt, T in zip(insts, in_counts, in_lens):
            seg_out = out[ofs : ofs + cnt]
            if halo > 0:
                seg_out = seg_out[:, :, halo : halo + cfg.segment_length]
            y = reassemble_song(seg_out, T)
            ofs += cnt
            outputs[inst] = y
            mixture = y if mixture is None else mixture + y
        return mixture, outputs

    # ------------------------------------------------------------------
    def _embed_group_pcm(self, ref_dev: torch.Tensor, Tr: int) -> torch.Tensor:
        """Per-stem mean embeddings ``[S, D]`` from a device-resident stem
        stack ``[S, 2, Tr]`` (int16 PCM or float32), segments straight to
        the encoder."""
        Lr = self.cfg.segment_length_ref
        S = ref_dev.shape[0]
        if Tr > 2 * Lr:
            # zero-pad the trailing partial segment like segment_song
            nr = -(-Tr // Lr)
            ref_seg = F.pad(ref_dev, (0, nr * Lr - Tr))
            ref_seg = ref_seg.reshape(S, 2, nr, Lr).permute(0, 2, 1, 3).reshape(S * nr, 2, Lr)
        else:
            nr = 1
            ref_seg = F.pad(ref_dev, (0, max(-(-Tr // 4096) * 4096, 4096) - Tr))
        B_ref = self.engine._pad_bucket(S * nr)
        profiling.count("infer.segments", ("encoder", S * nr, B_ref))
        ref_seg = F.pad(ref_seg, (0, 0, 0, 0, 0, B_ref - S * nr))
        onehot = np.zeros((S, B_ref), np.float32)
        for s in range(S):
            onehot[s, s * nr : (s + 1) * nr] = 1.0
        return self.engine._encode_group_mean(ref_seg, onehot)  # [S, D] on device

    @torch.inference_mode()
    def transfer_song_pcm(
        self,
        input_pcm: np.ndarray,
        reference_pcm: np.ndarray,
        want_stems: bool = False,
        reference_pcm_b: Optional[np.ndarray] = None,
        sync: bool = True,
    ):
        """Device-resident whole-song transfer from ``[S, 2, T]`` int16 (or
        float32) stem stacks in ``cfg.instruments`` order: one upload, one
        converter dispatch over every stem's segments, sum and int16
        quantization on the device, one download.

        With ``reference_pcm_b``, interpolation mode (reference
        ``style_transfer.py:181-270``): ``cfg.interpolate_segments`` chunks,
        chunk ``i`` conditioned on ``w*embA + (1-w)*embB``.

        With a normalizer and ``cfg.normalize_input``, the stems are
        FX-normalized on the device first, in both modes.

        Returns ``(mixture_pcm [2, T] int16, stems dict | None)``, as numpy
        arrays, or as device tensors when ``sync=False``. A call that raises
        (``torch.OutOfMemoryError`` among others) is recorded with ``ok``
        false, and the exception passes through unchanged.
        """
        ok = False
        try:
            with profiling.span("infer.request"):
                out = self._transfer_song_pcm(input_pcm, reference_pcm, want_stems,
                                              reference_pcm_b, sync)
            ok = True
            return out
        finally:
            profiling.count("infer.request", {"samples": int(input_pcm.shape[-1]), "ok": ok})

    @torch.inference_mode()
    def transfer_mix_pcm(
        self,
        input_mix,
        reference_mix,
        want_stems: bool = False,
        reference_mix_b=None,
        sync: bool = True,
    ):
        """``transfer_song_pcm`` from ``[2, T]`` mixtures (int16 or float32):
        each mixture is separated on the device (``self.separator``, in
        ``cfg.instruments`` order, which must be the separator's sources)
        and the stem stacks go on, still on the device, through the same
        stages. One ``infer.request`` span and record for the whole call,
        separation included; a call that raises is recorded with ``ok``
        false and the exception passes through."""
        ok = False
        try:
            with profiling.span("infer.request"):
                sep = self.separator
                if sep is None:
                    raise ValueError("transfer_mix_pcm needs a separator "
                                     "(MixingStyleTransfer(separator=HTDemucsSeparator(...)))")
                if tuple(sep.cfg.sources) != tuple(self.cfg.instruments):
                    raise ValueError(f"the separator's sources {sep.cfg.sources} are not the "
                                     f"instruments {self.cfg.instruments}")
                stems = [None if m is None else sep.separate(m)
                         for m in (input_mix, reference_mix, reference_mix_b)]
                out = self._transfer_song_pcm(stems[0], stems[1], want_stems, stems[2], sync)
            ok = True
            return out
        finally:
            profiling.count("infer.request", {"samples": int(input_mix.shape[-1]), "ok": ok})

    def _transfer_song_pcm(self, input_pcm, reference_pcm, want_stems, reference_pcm_b, sync):
        """The device stages; stem stacks are host arrays or, from
        ``transfer_mix_pcm``, float32 tensors on the device."""
        cfg = self.cfg
        insts = list(cfg.instruments)
        S = len(insts)
        L = cfg.segment_length
        for name, a in (
            ("input", input_pcm),
            ("reference", reference_pcm),
            ("reference_b", reference_pcm_b),
        ):
            on_device = isinstance(a, torch.Tensor)
            kinds = (torch.int16, torch.float32) if on_device else (np.int16, np.float32)
            if a is not None and a.dtype not in kinds:
                raise ValueError(f"{name} stems must be int16 or float32, got {a.dtype}")
        dev = self.engine.device
        T = input_pcm.shape[-1]

        def to_dev(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            with profiling.span("infer.upload"):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def upload(a):
            x = to_dev(a)
            return x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x

        Tb = -(-max(T, 1) // L) * L  # song-length bucket = whole segments
        if self.normalizer is not None and cfg.normalize_input:
            # FX normalization on the device, in float32 whatever the engine's
            # dtype; the samples past T are zeroed like the host path's padding
            # (the normalizer may smear ~ntaps/2 samples of FIR tail past T)
            fft = self.normalizer.cfg.fft_size
            x = F.pad(upload(input_pcm), (fft, fft + Tb - T))
            x = self.normalizer.batched().normalize_device(x, insts, [T] * S)
            y_in = x[:, :, fft : fft + Tb].clamp(-1.0, 1.0)
            y_in = y_in * (torch.arange(Tb, device=dev) < T)
        else:
            y_in = F.pad(upload(input_pcm), (0, Tb - T))
        ref_dev = to_dev(reference_pcm)
        embs = self._embed_group_pcm(ref_dev, reference_pcm.shape[-1])  # [S, D]

        if reference_pcm_b is not None:
            ref_b_dev = to_dev(reference_pcm_b)
            embs_b = self._embed_group_pcm(ref_b_dev, reference_pcm_b.shape[-1])
            n_interp = int(cfg.interpolate_segments)
            L = T // n_interp + 1  # chunk length (reference style_transfer.py:241)
            n = -(-T // L)
            Tb = n * L
            y_in = y_in[:, :, :Tb] if y_in.shape[-1] >= Tb else F.pad(y_in, (0, Tb - y_in.shape[-1]))
            w = np.clip((n_interp - 1 - np.arange(n)) / max(n_interp - 1, 1), 0.0, 1.0)
            wd = torch.as_tensor(w, dtype=torch.float32, device=dev)[None, :, None]
            cond = (wd * embs[:, None, :] + (1.0 - wd) * embs_b[:, None, :]).reshape(S * n, -1)
        elif cfg.sequence_parallel and self.engine._n_shards > 1:
            # one boundary-free time-sharded forward per stem (JAX pipeline.py:527-537)
            from .seqpar import seq_parallel_convert_device

            y = seq_parallel_convert_device(self.engine, y_in[:, :, :T], embs)
            return self._finish_pcm(y, want_stems, insts, sync)
        else:
            n = Tb // L
            cond = embs.repeat_interleave(n, dim=0)

        # convert all stems' segments in one dispatch
        segs = y_in.reshape(S, 2, n, L).permute(0, 2, 1, 3).reshape(S * n, 2, L)
        B_in = self.engine._pad_bucket(S * n)
        profiling.count("infer.segments", ("converter", S * n, B_in))
        segs = F.pad(segs, (0, 0, 0, 0, 0, B_in - S * n))
        cond = F.pad(cond, (0, 0, 0, B_in - S * n))
        out = self.engine._convert_multi(segs, cond)

        # reassemble + sum + quantize on the device; download once
        y = out[: S * n].reshape(S, n, 2, L).permute(0, 2, 1, 3).reshape(S, 2, n * L)
        return self._finish_pcm(y[:, :, :T], want_stems, insts, sync)

    @profiling.spanned("infer.finish")
    def _finish_pcm(self, y: torch.Tensor, want_stems: bool, insts, sync: bool):
        """Sum converted stems ``[S, 2, T]``, quantize to int16 on the device
        (round half to even, as ``jnp.round``), download once unless
        ``sync=False``."""

        def to_pcm16(a):
            return torch.round(a * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)

        pcm = to_pcm16(y.sum(0))
        stems_out = None
        if want_stems:
            spcm = to_pcm16(y)
            stems_out = {
                inst: (_numpy(spcm[s]) if sync else spcm[s]) for s, inst in enumerate(insts)
            }
        return (_numpy(pcm) if sync else pcm), stems_out

    # ------------------------------------------------------------------
    def run_directory(self, target_dir: str, output_dir: Optional[str] = None) -> List[str]:
        """Process every song directory under ``target_dir``; expects
        pre-separated stems at
        ``<song>/<stem_level_dir>[/<separation_model>]/<input|reference>/<inst>.wav``
        (reference directory contract, ``data_loader.py:545-603``), or, when
        :meth:`separates_in_process`, the mixtures
        ``<song>/<input|reference>.wav``, separated here
        (``transfer_mix_pcm``; the stems are not written).

        A reader thread loads song i+1's WAVs while song i computes, and a
        writer thread downloads and writes song i-1's results."""
        import concurrent.futures as cf
        import glob

        cfg = self.cfg
        output_dir = output_dir or target_dir
        sep_dir = (
            cfg.stem_level_directory_name
            if cfg.do_not_separate
            else os.path.join(cfg.stem_level_directory_name, cfg.separation_model)
        )
        tag = "output" if cfg.normalize_input else "output_notnormed"
        if cfg.interpolation:
            tag += "_interpolation"

        io_pool = cf.ThreadPoolExecutor(2, thread_name_prefix="mst-io")
        write_futs: List = []  # ordered; joined (in order) before returning
        MAX_PENDING_WRITES = 4  # cap device buffers pinned by lagging disk IO

        def _finish(p):
            out_dir, mixture, outputs = p
            if len(write_futs) >= MAX_PENDING_WRITES:
                write_futs[-MAX_PENDING_WRITES].result()

            def _write():
                os.makedirs(out_dir, exist_ok=True)
                if cfg.save_each_inst and outputs:
                    for inst, y in outputs.items():
                        write_wav(
                            os.path.join(out_dir, f"{inst}_{tag}.wav"),
                            _numpy(y).T,
                            cfg.sample_rate,
                        )
                out_path = os.path.join(out_dir, f"mixture_{tag}.wav")
                # _numpy here is the device->host download, on the writer thread
                write_wav(out_path, _numpy(mixture).T, cfg.sample_rate)
                return out_path

            write_futs.append(io_pool.submit(_write))

        song_dirs = sorted(glob.glob(os.path.join(target_dir, "*/")))
        prefetch_ok = cfg.pcm_fast_path and cfg.segment_halo == 0
        mixes = self.separates_in_process()
        if mixes and not prefetch_ok:
            raise ValueError("in-process separation (separation_model htdemucs) runs on the "
                             "device-resident path: pcm_fast_path true and segment_halo 0")

        def load(song_dir):
            return self._load_mix_pcm(song_dir) if mixes else self._load_song_pcm(song_dir, sep_dir)

        next_fut = None
        if prefetch_ok and song_dirs:
            next_fut = io_pool.submit(load, song_dirs[0])

        pending = None  # (out_dir, mixture, outputs), device tensors in flight
        try:
            for i, song_dir in enumerate(song_dirs):
                log.info("song: %s", song_dir)
                out_dir = os.path.join(output_dir, os.path.relpath(song_dir, target_dir))

                dispatched = None
                if prefetch_ok:
                    try:
                        bundle = next_fut.result()
                    except ValueError as e:  # e.g. sample-rate mismatch
                        if mixes:  # no stems on disk to fall back to
                            raise
                        bundle = None
                        log.warning(
                            "%s: PCM fast path unavailable (%s); per-stage host path",
                            song_dir, e,
                        )
                    if i + 1 < len(song_dirs):
                        next_fut = io_pool.submit(load, song_dirs[i + 1])
                    if bundle is not None:
                        dispatched = self._dispatch_song_pcm(bundle)

                if pending is not None:
                    _finish(pending)
                    pending = None

                if dispatched is not None:
                    pending = (out_dir,) + dispatched
                    continue

                def load_stems(name):
                    return {
                        inst: read_wav_stereo_ct(
                            os.path.join(song_dir, sep_dir, name, inst + ".wav"),
                            expected_rate=cfg.sample_rate,
                        ).clip(-1, 1)
                        for inst in cfg.instruments
                    }

                input_stems = load_stems(cfg.input_file_name)
                reference_stems = load_stems(cfg.reference_file_name)
                ref_b = (
                    load_stems(cfg.reference_file_name_2interpolate)
                    if cfg.interpolation
                    else None
                )
                mixture, outputs = self.transfer_stems(input_stems, reference_stems, ref_b)
                _finish((out_dir, mixture, outputs))

            if pending is not None:
                _finish(pending)
            written = [f.result() for f in write_futs]  # song order
        finally:
            # on a mid-loop failure, drain queued writes before unwinding
            io_pool.shutdown(wait=True)
        return written

    def _read_pcm(self, path: str) -> np.ndarray:
        """One WAV as ``[2, T]`` int16 PCM, or float32 for a source that is
        not 16-bit."""
        try:
            return read_wav_stereo_ct_i16(path, expected_rate=self.cfg.sample_rate)
        except ValueError:
            # non-16-bit source: float32 upload, same device stages
            return (read_wav_stereo_ct(path, expected_rate=self.cfg.sample_rate)
                    .clip(-1.0, 1.0).astype(np.float32))

    def _load_mix_pcm(self, song_dir: str):
        """Read one song's mixtures (``<song>/<name>.wav``) for
        ``transfer_mix_pcm`` (reader thread). Returns
        ``(input [2,T], reference [2,Tr], reference_b | None)``."""
        cfg = self.cfg

        def mix(name):
            return self._read_pcm(os.path.join(song_dir, name + ".wav"))

        return (
            mix(cfg.input_file_name),
            mix(cfg.reference_file_name),
            mix(cfg.reference_file_name_2interpolate) if cfg.interpolation else None,
        )

    def _load_song_pcm(self, song_dir: str, sep_dir: str):
        """Read one song's stem WAVs as raw PCM stacks (host I/O only, run
        on the reader thread). Returns
        ``(input [S,2,T], reference [S,2,Tr], reference_b | None)``."""
        cfg = self.cfg

        def load_pcm(name):
            stems = [self._read_pcm(os.path.join(song_dir, sep_dir, name, inst + ".wav"))
                     for inst in cfg.instruments]
            if any(s.dtype != np.int16 for s in stems):
                stems = [
                    s.astype(np.float32) * (1.0 / 32768.0) if s.dtype == np.int16 else s
                    for s in stems
                ]
            T = max(s.shape[-1] for s in stems)
            return np.stack([np.pad(s, ((0, 0), (0, T - s.shape[-1]))) for s in stems])

        return (
            load_pcm(cfg.input_file_name),
            load_pcm(cfg.reference_file_name),
            load_pcm(cfg.reference_file_name_2interpolate) if cfg.interpolation else None,
        )

    def _dispatch_song_pcm(self, bundle):
        """Run one preloaded PCM bundle through the device-resident path;
        returns device tensors (downloaded when the pipeline drains)."""
        in_pcm, ref_pcm, ref_b_pcm = bundle
        t0 = time.perf_counter()
        transfer = self.transfer_mix_pcm if self.separates_in_process() else self.transfer_song_pcm
        mixture, stems_out = transfer(
            in_pcm, ref_pcm, self.cfg.save_each_inst, ref_b_pcm, sync=False
        )
        log.info("device-resident dispatch: %.1fs", time.perf_counter() - t0)
        return mixture, stems_out


def separate_with_demucs(
    song_path: str, out_dir: str, model: str = "mdx_extra", device: str = "cpu"
) -> None:
    """Optional external source separation, interface-compatible with the
    reference (``style_transfer.py:82-90``): shells out to the ``demucs``
    CLI exactly as the reference does and fails clearly if it is absent."""
    import shutil
    import subprocess

    if shutil.which("demucs") is None:
        raise RuntimeError(
            "demucs CLI not found; pre-separate stems and use do_not_separate=True, "
            "or separate in-process on the card with --separation_model htdemucs"
        )
    subprocess.run(
        ["demucs", song_path, "-n", model, "-d", device, "-o", out_dir], check=True
    )
