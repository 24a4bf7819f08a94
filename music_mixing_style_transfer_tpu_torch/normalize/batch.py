"""Batched multi-stem FX normalization, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/normalize/batch.py``: every
stage runs once for all stems' channels, on the device of the input:

- loudness: BS.1770 per stem + per-stem gains;
- EQ matching: batched average spectrum, per-channel FIR design and
  zero-phase filtering, all on the device;
- compression matching: one (candidate x channel) sweep of the first
  candidate block through the envelope kernel (K2) in time slabs, the
  first satisfying candidate per channel, and the final compression (K2);
  a host-stepped sweep over further blocks only when some channel needs it;
- imager: mid/side balancing per stem.

Same stage math and skip rules as the JAX package; after each call
``last_compression`` holds the compression stage's choice per channel.

Spans (``utils/profiling.py``): ``normalize.batch`` around the whole call,
``normalize.<stage>`` around each stage, ``normalize.compression.sync``
around the host round trip and ``normalize.compression.host_sweep``
around the host-stepped sweep; the counter ``normalize.compression``
records ``{"fallback": bool}`` a call.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import NormalizationConfig
from ..ops.biquad import _odd_ext
from ..ops.compressor import CompressorStream, compress_and_clip
from ..ops.loudness import integrated_loudness
from ..ops.stft import sqrt_hann_window, stft
from ..utils import profiling
from .imager import normalize_imager
from .matching import (
    _comp_grid,
    design_eq_fir_batch,
    frame_peak_features,
    mean_peak_from_frames,
    measure_mean_peak,
    onset_mask_from_features,
)

# lanes of the first candidate block: the TPU kernel's block width, kept so
# the sweep's blocks (and so the choices) are the JAX package's
BLOCK_LANES = 1024


# ---------------------------------------------------------------------------
# batched primitives
# ---------------------------------------------------------------------------
def _apply_gain_peak_protect(stems: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Reference lufs_normalize tail: gain then divide by max(1, peak+1e-6)."""
    y = stems * gains[:, None, None]
    return y / torch.clamp_min(1e-6 + y.abs().amax((1, 2), keepdim=True), 1.0)


def _batched_avg_spectrum(ch: torch.Tensor, valid_frames: torch.Tensor, n_fft: int, hop: int):
    """[N, T] -> [N, bins] mean |STFT| over each lane's first
    ``valid_frames[n]`` frames only: lanes are zero-padded to the longest
    stem, and the padding frames would dilute the spectrum."""
    spec = stft(ch, n_fft, hop, sqrt_hann_window(n_fft), center=False).abs()  # [N, F, bins]
    F = spec.shape[-2]
    mask = (torch.arange(F, device=ch.device)[None, :] < valid_frames[:, None]).to(spec.dtype)
    return (spec * mask[..., None]).sum(-2) / valid_frames[:, None].clamp_min(1)


def _grouped_fir_filtfilt(ch: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Zero-phase per-lane FIR, ``ch [N, T]`` with ``taps [N, K]``: scipy
    ``filtfilt(b, 1, x, padtype='odd')``, evaluated as a spectral multiply by
    |B(w)|^2 at the rfft bins of the odd-extended signal."""
    N, T = ch.shape
    K = taps.shape[-1]
    padlen = 3 * K
    ext = _odd_ext(ch, padlen)  # [N, T + 2*padlen]
    n = 1 << int(np.ceil(np.log2(ext.shape[-1] + 2 * K)))  # room for the filter tail
    H = torch.fft.rfft(taps, n=n, dim=-1)
    H2 = (H * torch.conj(H)).real.to(torch.complex64)  # |B|^2, zero phase
    y = torch.fft.irfft(torch.fft.rfft(ext, n=n, dim=-1) * H2, n=n, dim=-1)
    # zero-phase: same indices; negative lags wrap into the padding region
    return y[:, padlen : padlen + T].to(ch.dtype)


def _stream_peaks_batch(
    ch: torch.Tensor,  # [N, T]
    ratios,            # [N, Gc] effective ratios (already inverted for 'up')
    ths,               # [N, Gc]
    attacks,           # [N]
    releases,          # [N]
    sample_rate: int,
    percentile: float = 75.0,
    slab_T: int = 1 << 18,
) -> torch.Tensor:
    """Peaks feature for every (channel, candidate) pair: ``[N, Gc]``.

    Each time slab feeds the ``N*Gc`` lanes, lane ``n*Gc + g`` reading
    channel n's row (the envelope kernel's ``rows``, so the slab is read once
    and never copied per candidate), compressed with the envelope carried
    across slabs (:class:`CompressorStream`), clipped, and reduced to
    per-frame features; only the ``[N*Gc, F]`` frame arrays
    persist, so memory stays at ``O(lanes * slab_T)``. The unconditional
    clip equals the reference's rule "clip only when max|y| >= 1"."""
    dev = ch.device
    ratios = torch.as_tensor(ratios, dtype=torch.float32, device=dev)
    ths = torch.as_tensor(ths, dtype=torch.float32, device=dev)
    N, Gc = ratios.shape
    T_used = (int(ch.shape[-1]) // 1024) * 1024
    stream = CompressorStream(
        ths.reshape(-1),
        torch.as_tensor(np.repeat(attacks, Gc), device=dev),
        torch.as_tensor(np.repeat(releases, Gc), device=dev),
        ratios.reshape(-1),
        sample_rate,
    )
    rows = torch.arange(N, device=dev).repeat_interleave(Gc)
    hfcs, fmaxs, fdbs = [], [], []
    for s0 in range(0, T_used, slab_T):
        xs = ch[:, s0 : min(s0 + slab_T, T_used)]
        h, fm, fd = frame_peak_features(stream.process(xs, rows=rows).clamp_(-1.0, 1.0))
        hfcs.append(h)
        fmaxs.append(fm)
        fdbs.append(fd)
    mask = onset_mask_from_features(torch.cat(hfcs, -1), torch.cat(fdbs, -1))
    peaks, _ = mean_peak_from_frames(torch.cat(fmaxs, -1), mask, percentile=percentile)
    return peaks.reshape(N, Gc)


# ---------------------------------------------------------------------------
# batched normalizer
# ---------------------------------------------------------------------------
class BatchedAudioEffectsNormalizer:
    """``normalize_stems({'drums': [2, T], ...}) -> same structure`` with every
    stage run once for all stems, on ``device`` (``normalize_device`` runs
    on its input's device)."""

    def __init__(
        self,
        features: Dict[str, Dict[str, np.ndarray]],
        config: Optional[NormalizationConfig] = None,
        device="cuda",
    ):
        self.cfg = config or NormalizationConfig()
        self.features = features
        self.device = torch.device(device)
        self.last_compression: Optional[Dict[str, np.ndarray]] = None

    # -- stages -------------------------------------------------------
    def _stage_loudness(self, stems: torch.Tensor, insts: Sequence[str]) -> torch.Tensor:
        targets = torch.tensor(
            [float(np.ravel(self.features["loudness"][i])[0]) for i in insts],
            dtype=torch.float32, device=stems.device,
        )
        loud = integrated_loudness(stems.transpose(1, 2) + 1e-10, self.cfg.sample_rate)  # [S]
        # fully-gated stems measure -inf LUFS -> inf gain; skip them
        gains = torch.where(torch.isfinite(loud), torch.pow(10.0, (targets - loud) / 20.0), 1.0)
        return _apply_gain_peak_protect(stems, gains)

    def _stage_eq(
        self, stems: torch.Tensor, insts: Sequence[str], lengths: Sequence[int]
    ) -> torch.Tensor:
        cfg = self.cfg
        S = stems.shape[0]
        dev = stems.device
        ch = stems.reshape(S * 2, -1)  # [N, T]
        # silent channels skip the stage (the per-stem path's min_db rule)
        silent = 20.0 * torch.log10(ch.abs().amax(-1) + 1e-30) <= cfg.min_db
        # per-channel LUFS normalization (each channel as a mono signal)
        loud = integrated_loudness(ch[:, :, None] + 1e-10, cfg.sample_rate)
        gains = torch.where(torch.isfinite(loud), torch.pow(10.0, (cfg.lufs - loud) / 20.0), 1.0)
        y = ch * gains[:, None]
        y = y / torch.clamp_min(1e-6 + y.abs().amax(-1, keepdim=True), 1.0)
        # frames within each stem's own (padded) span only
        spans = np.asarray([2 * cfg.fft_size + lengths[n // 2] for n in range(S * 2)])
        valid = np.maximum(1 + (spans - cfg.fft_size) // cfg.hop_length, 1)
        specs = _batched_avg_spectrum(
            y, torch.as_tensor(valid, device=dev), cfg.fft_size, cfg.hop_length
        )
        refs = torch.as_tensor(
            np.stack([self.features["eq"][insts[n // 2]] for n in range(S * 2)]),
            dtype=torch.float32, device=dev,
        )
        out = _grouped_fir_filtfilt(y, design_eq_fir_batch(specs, refs, cfg.ntaps))
        return torch.where(silent[:, None], ch, out).reshape(S, 2, -1)

    def _comp_static(self, insts: Sequence[str]):
        """Config-only per-channel compression constants and BOTH mode grids
        (edge-padded to a common width), so the data-dependent mode choice
        can happen on the device."""
        cfg = self.cfg
        N = len(insts) * 2
        comp = [self.features["compression"][insts[n // 2]] for n in range(N)]
        ref_peak = np.asarray([float(c[0]) for c in comp])
        ref_std = np.asarray([float(c[1]) for c in comp])
        settings = [cfg.comp_settings[insts[n // 2]] for n in range(N)]
        attacks = np.asarray([s[0] for s in settings], np.float32)
        releases = np.asarray([s[1] for s in settings], np.float32)

        per_mode = []
        for s in settings:
            Rd, Td = _comp_grid(float(s[2]), cfg.comp_min_th, cfg.comp_max_ratio, expander=False)
            Ru, Tu = _comp_grid(float(s[2]), cfg.comp_min_th, cfg.comp_max_ratio, expander=True)
            per_mode.append(((Rd, Td), (1.0 / Ru, Tu)))
        Gm = max(1, max(max(len(g[0][0]), len(g[1][0])) for g in per_mode))
        grids = {}  # mode -> (grid_r [N, Gm], grid_t [N, Gm])
        for mi, mode in enumerate(("down", "up")):
            gr = np.ones((N, Gm), np.float32)
            gt = np.zeros((N, Gm), np.float32)
            for n in range(N):
                R, T = per_mode[n][mi]
                if len(R) == 0:
                    # empty grid (narrow comp configs): identity candidates,
                    # the channel falls through uncompressed as in the reference
                    continue
                gr[n, : len(R)], gt[n, : len(R)] = R, T
                gr[n, len(R) :], gt[n, len(R) :] = R[-1], T[-1]
            grids[mode] = (gr, gt)
        return ref_peak, ref_std, attacks, releases, grids, Gm

    def _stage_compression(self, stems: torch.Tensor, insts: Sequence[str]) -> torch.Tensor:
        """Compression matching. The mode decision, the first candidate
        block's sweep, the first-satisfying selection and the final
        compression run on the device; the one host round trip (did every
        active channel find a candidate in block 0?) comes after the final
        compression is queued. Channels whose candidate lies beyond block 0
        take the host-stepped sweep."""
        cfg = self.cfg
        S = stems.shape[0]
        N = S * 2
        dev = stems.device
        ch = stems.reshape(N, -1)

        # per-channel peak-normalize to -10 dB (reference pyln.normalize.peak)
        peaks = ch.abs().amax(-1, keepdim=True)
        x = ch * (10 ** (cfg.comp_peak_norm / 20.0) / peaks.clamp_min(1e-30))
        featd, _ = measure_mean_peak(x, percentile=float(cfg.comp_percentile))

        ref_peak, ref_std, attacks, releases, grids, Gm = self._comp_static(insts)
        lo_d = torch.as_tensor(ref_peak - ref_std, dtype=torch.float32, device=dev)
        hi_d = torch.as_tensor(ref_peak + ref_std, dtype=torch.float32, device=dev)

        in_band = (featd > lo_d) & (featd < hi_d)
        down_d = ~in_band & (featd > lo_d)
        up_d = ~in_band & ~down_d & bool(cfg.comp_use_expander)
        active_d = (down_d | up_d) & torch.isfinite(featd)

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        grid_r = torch.where(down_d[:, None], on_dev(grids["down"][0]), on_dev(grids["up"][0]))
        grid_t = torch.where(down_d[:, None], on_dev(grids["down"][1]), on_dev(grids["up"][1]))

        Gc = int(min(Gm, max(1, BLOCK_LANES // max(N, 1))))
        pk = _stream_peaks_batch(
            x, grid_r[:, :Gc], grid_t[:, :Gc], attacks, releases,
            cfg.sample_rate, float(cfg.comp_percentile),
        )  # [N, Gc]
        ok = torch.where(down_d[:, None], pk < hi_d[:, None], pk > lo_d[:, None])
        any0 = ok.any(1)
        # first satisfying candidate; the reference falls through to the LAST
        # candidate when none satisfies (edge padding makes Gm-1 per-channel)
        idx = torch.where(any0, ok.to(torch.uint8).argmax(1), Gm - 1)
        sel_r = torch.where(active_d, grid_r.gather(1, idx[:, None])[:, 0], 1.0)
        sel_t = torch.where(active_d, grid_t.gather(1, idx[:, None])[:, 0], 0.0)
        y = compress_and_clip(
            x, sel_t, on_dev(attacks), on_dev(releases), sel_r, cfg.sample_rate
        )
        # inactive (in-band) channels keep the peak-normalized x (reference :379-381)
        y = torch.where(active_d[:, None], y, x)

        # the ONE host round trip, behind the final compression queued above
        with profiling.span("normalize.compression.sync"):
            fallback = Gc < Gm and bool((active_d & ~any0).any())
            active = active_d.cpu().numpy()
            if fallback:
                y, sel_r, sel_t = self._comp_host_sweep(
                    x, down_d.cpu().numpy(), active, grid_r.cpu().numpy(), grid_t.cpu().numpy(),
                    ref_peak, ref_std, attacks, releases, Gc, Gm,
                )
            self.last_compression = {
                "ratio": sel_r.cpu().numpy(),
                "threshold": sel_t.cpu().numpy(),
                "active": active,
                "fallback": np.asarray(fallback),
            }
        profiling.count("normalize.compression", {"fallback": fallback})
        return y.reshape(S, 2, -1)

    @profiling.spanned("normalize.compression.host_sweep")
    def _comp_host_sweep(
        self, x, down, active, grid_r, grid_t, ref_peak, ref_std, attacks, releases, Gc, Gm,
    ):
        """Host-stepped early-exit sweep over the full grid (the rare path:
        some channel's first satisfying candidate lies beyond block 0).
        Returns ``(y, ratios, thresholds)``."""
        cfg = self.cfg
        N = x.shape[0]
        chosen = np.full(N, Gm - 1, np.int64)
        found = ~active
        for lo in range(0, Gm, Gc):
            if found.all():
                break
            r = grid_r[:, lo : lo + Gc]
            t = grid_t[:, lo : lo + Gc]
            if r.shape[1] < Gc:
                r = np.pad(r, ((0, 0), (0, Gc - r.shape[1])), mode="edge")
                t = np.pad(t, ((0, 0), (0, Gc - t.shape[1])), mode="edge")
            pk = _stream_peaks_batch(
                x, r, t, attacks, releases, cfg.sample_rate, float(cfg.comp_percentile)
            ).cpu().numpy()
            n_valid = min(Gc, Gm - lo)
            ok = np.where(
                down[:, None], pk < (ref_peak + ref_std)[:, None],
                pk > (ref_peak - ref_std)[:, None],
            )[:, :n_valid]
            for n in range(N):
                if not found[n] and ok[n].any():
                    chosen[n] = lo + int(np.argmax(ok[n]))
                    found[n] = True

        dev = x.device
        rows = np.arange(N)
        sel_r, sel_t = (
            torch.as_tensor(np.where(active, g[rows, chosen], v), dtype=torch.float32, device=dev)
            for g, v in ((grid_r, 1.0), (grid_t, 0.0))
        )
        y = compress_and_clip(
            x, sel_t, torch.as_tensor(attacks, device=dev),
            torch.as_tensor(releases, device=dev), sel_r, cfg.sample_rate,
        )
        return torch.where(torch.as_tensor(active, device=dev)[:, None], y, x), sel_r, sel_t

    def _stage_imager(self, stems: torch.Tensor, insts: Sequence[str]) -> torch.Tensor:
        dev = stems.device
        targets = torch.tensor([float(self.features["imager"][i]) for i in insts], device=dev)
        thresholds = torch.tensor([0.99 if i == "bass" else 0.975 for i in insts], device=dev)
        return normalize_imager(
            stems, target_side_mid_bal=targets, mono_threshold=thresholds,
            sr=self.cfg.sample_rate,
        )

    # -- orchestration --------------------------------------------------
    @profiling.spanned("normalize.batch")
    def normalize_device(
        self, x: torch.Tensor, insts: Sequence[str], length_list: Sequence[int]
    ) -> torch.Tensor:
        """Device-resident core: ``x [S, 2, fft + T + fft]`` (margin-padded,
        float32, on the device) -> the same shape on that device."""
        cfg = self.cfg
        # per-stem skip mask; selection only, so it stays on the device
        skip = 20.0 * torch.log10(x.abs().amax((1, 2)) + 1e-30) <= cfg.min_db
        cur = x
        for effect in cfg.effects:
            with profiling.span("normalize." + effect):
                if effect == "loudness":
                    y = self._stage_loudness(cur, insts)
                elif effect == "eq":
                    y = self._stage_eq(cur, insts, length_list)
                elif effect == "compression":
                    y = self._stage_compression(cur, insts)
                elif effect == "imager":
                    y = self._stage_imager(cur, insts)
                else:
                    raise ValueError(f"unsupported batched effect: {effect}")
                cur = torch.where(skip[:, None, None], cur, y)
        return cur

    @torch.inference_mode()
    def normalize_stems(self, stems: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        insts = list(stems.keys())
        T = max(v.shape[-1] for v in stems.values())
        x = np.stack(
            [
                np.pad(
                    np.asarray(v, np.float32),
                    ((0, 0), (cfg.fft_size, cfg.fft_size + T - v.shape[-1])),
                )
                for v in stems.values()
            ]
        )  # [S, 2, T + 2*fft]
        lengths = [stems[i].shape[-1] for i in insts]
        out = self.normalize_device(torch.from_numpy(x).to(self.device), insts, lengths)
        out_np = out.cpu().numpy()
        return {
            inst: out_np[s, :, cfg.fft_size : cfg.fft_size + lengths[s]]
            for s, inst in enumerate(insts)
        }
