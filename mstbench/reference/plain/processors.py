"""FXmanipulator processors, in PyTorch.

Counterpart of ``music_mixing_style_transfer_tpu/fx/processors.py`` (the
reference suite ``mixing_manipulator/common_audioeffects.py``). Every
processor is a pair of functions:

    sample(gen, n)   -> params   (n parameter sets drawn from a torch.Generator)
    apply(params, x) -> y        (x: [..., 2, T] channel-first audio)

``sample`` draws with the JAX package's ranges and distributions; torch
cannot reproduce JAX's keys, so parity tests sample in JAX and hand the
same parameters to both ``apply``s. ``apply`` is a plain function of
tensors: each ``[2, T]`` slice of ``x`` is one signal, and a parameter is a
scalar or a tensor whose shape is a prefix of ``x.shape[:-2]`` (one value
per draw), so one call applies every draw of a batch. The substitutions of
the JAX package are kept: the Equaliser as log-depth scans (a spectral
multiply from 32768 samples on), the compressor through the envelope
wrapper (``ops/cuda/envelope.py``: K2 on the card), Freeverb as its exact
transfer function at rfft bins.

The FX normalizer's imager uses the Haas draw of ``PRNGKey(0)``
(``haas_params(sr)``): ``feedback`` and ``left`` do not depend on the rate,
and ``delay`` is JAX's ``randint`` arithmetic on two fixed words at any
rate (pinned against JAX in ``tests/test_torch_imager_rates.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .biquad import biquad_apply, biquad_apply_scan, biquad_cascade_fft, rbj_coeffs, rbj_poles
from .compressor import compressor_process
from .fftconv import fft_convolve_full

# Haas(44100).sample(jax.random.PRNGKey(0)) with the JAX package's bounds
HAAS_PARAMS_44K: Dict[str, object] = {
    "delay": 1281,
    "feedback": 0.3324069678783417,  # float32
    "left": False,
}
# The two uint32 words behind that draw's delay. Haas.sample splits
# PRNGKey(0) in 3 and draws the delay as randint(k1, (), dmin, dmax + 1);
# randint splits k1 in 2 and takes 32 random bits from each half (high word
# first, then low word). Neither word depends on the rate: they are
# jax.random.bits(split(split(PRNGKey(0), 3)[0])[i], (), uint32) for i = 0, 1
# (JAX 0.9.0, threefry).
HAAS_DELAY_WORDS = (1214273199, 447923887)


def haas_params(sample_rate: int = 44100) -> Dict[str, object]:
    """``Haas(sample_rate).sample(jax.random.PRNGKey(0))`` without JAX: the
    delay is JAX's ``randint`` reduction of :data:`HAAS_DELAY_WORDS` onto
    ``[int(-0.04 sr), int(0.04 sr)]`` in uint32 arithmetic,
    ``dmin + ((hi % span) * m + lo % span) % span`` with
    ``m = (2^16 % span)^2 % span``, the square wrapping at 2^32 as JAX's
    does (it is 0 once ``span`` exceeds 2^16, from 819.2 kHz up)."""
    haas = Haas(sample_rate)
    span = (haas.dmax + 1 - haas.dmin) & 0xFFFFFFFF
    hi, lo = HAAS_DELAY_WORDS
    m = (((2**16 % span) ** 2) & 0xFFFFFFFF) % span
    offset = ((((hi % span) * m) & 0xFFFFFFFF) + lo % span) & 0xFFFFFFFF
    return {**HAAS_PARAMS_44K, "delay": haas.dmin + offset % span}


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen)


def _coin(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=gen) < 0.5


def _p(v, x: torch.Tensor, nd: int, dtype=torch.float32) -> torch.Tensor:
    """Parameter ``v`` on x's device, shaped to broadcast against a tensor of
    ``nd`` dims whose leading dims are ``v``'s (one value per draw)."""
    v = torch.as_tensor(v, device=x.device)
    if dtype is not None and v.dtype != torch.bool:
        v = v.to(dtype)
    return v.reshape(tuple(v.shape) + (1,) * (nd - v.dim()))


def rms_normalize(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Match ``y``'s energy to ``x``'s over their last two axes (reference
    ``AugmentationChain.apply_processor``, ``common_audioeffects.py:142-146``)."""
    ex = (x * x).mean((-2, -1), keepdim=True)
    ey = (y * y).mean((-2, -1), keepdim=True)
    return y * torch.sqrt(ex / ey.clamp_min(eps))


class Gain:
    """Random gain in dB with random polarity inversion
    (reference ``common_audioeffects.py:1011-1051``)."""

    name = "gain"

    def __init__(self, gain_range=(-6.0, 9.0)):
        self.gain_range = gain_range

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {"gain_db": _uniform(gen, n, *self.gain_range), "invert": _coin(gen, n)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        g = torch.pow(10.0, _p(params["gain_db"], x, x.dim()) / 20.0)
        return torch.where(_p(params["invert"], x, x.dim()), -g, g) * x


class Panner:
    """Stereo panner with -4.5 dB / linear / constant-power laws
    (reference ``common_audioeffects.py:860-952``)."""

    name = "pan"

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {
            "pan": _uniform(gen, n, 0.0, 1.0),
            "law": torch.randint(0, 3, (n,), generator=gen),  # 0=-4.5dB, 1=linear, 2=constant_power
        }

    @staticmethod
    def gains(pan: torch.Tensor, law: torch.Tensor) -> torch.Tensor:
        """Channel gains ``[..., 2]`` for ``pan`` and ``law`` of one shape."""
        theta = pan * (math.pi / 2)
        lin = torch.stack([((math.pi / 2) - theta) * (2 / math.pi), theta * (2 / math.pi)], -1)
        cp = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
        m45 = torch.sqrt(lin * cp)
        law = law[..., None]
        return torch.where(law == 0, m45, torch.where(law == 1, lin, cp))

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        pan = _p(params["pan"], x, x.dim() - 2)
        law = _p(params["law"], x, x.dim() - 2, dtype=torch.int64)
        return x * self.gains(pan, law)[..., None]


class MidSideImager:
    """Mid/side balance (reference ``common_audioeffects.py:956-1007``):
    bal in [0, 1] narrows toward mono, (1, 2] widens up to full side energy."""

    name = "imager"

    def __init__(self, bal_range=(0.0, 2.0)):
        self.bal_range = bal_range

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {"bal": _uniform(gen, n, *self.bal_range)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        mid = x[..., 0, :] + x[..., 1, :]
        side = x[..., 0, :] - x[..., 1, :]
        mid_e = (mid * mid).sum(-1, keepdim=True)
        side_e = (side * side).sum(-1, keepdim=True)
        total_e = mid_e + side_e
        max_side = torch.sqrt(total_e / (side_e + 1e-3))
        bal = torch.round(_p(params["bal"], x, x.dim() - 1), decimals=3)
        side_gain = torch.where(bal <= 1.0, bal, max_side * (bal - 1.0))
        new_side = side * side_gain
        new_side_e = side_e * side_gain**2
        mid_gain = torch.sqrt((total_e - new_side_e).clamp_min(0.0) / (mid_e + 1e-3))
        new_mid = mid * mid_gain
        return torch.stack([(new_mid + new_side) / 2, (new_mid - new_side) / 2], dim=-2)


class Haas:
    """Haas stereoization: a feedback-scaled, circularly delayed copy added
    to one channel (reference ``common_audioeffects.py:768-856``)."""

    name = "haas"

    def __init__(self, sample_rate=44100, delay_range=(-0.040, 0.040)):
        self.dmin = int(delay_range[0] * sample_rate)
        self.dmax = int(delay_range[1] * sample_rate)

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {
            "delay": torch.randint(self.dmin, self.dmax + 1, (n,), generator=gen),
            "feedback": _uniform(gen, n, 0.33, 0.66),
            "left": _coin(gen, n),
        }

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """``x [..., 2, T]`` -> the same with the delayed copy added to the
        left (``params["left"]``) or the right channel."""
        T = x.shape[-1]
        src = torch.remainder(  # a circular roll by each draw's delay
            torch.arange(T, device=x.device) - _p(params["delay"], x, x.dim(), dtype=torch.int64), T
        )
        rolled = torch.gather(x, -1, src.expand(x.shape))
        left = _p(params["left"], x, x.dim())
        to_ch = torch.cat([left, ~left], dim=-2)  # [..., 2, 1]: the channel it adds to
        return x + torch.where(to_ch, _p(params["feedback"], x, x.dim()) * rolled, 0.0)


class SwapChannels:
    """Random channel swap (reference ``common_audioeffects.py:1055-1091``)."""

    name = "swap"

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {"swap": _coin(gen, n)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        return torch.where(_p(params["swap"], x, x.dim()), x.flip(-2), x)


class Monauralize:
    """Every channel overwritten with one seed channel
    (reference ``common_audioeffects.py:1095-1128``)."""

    name = "mono"

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {"seed_right": _coin(gen, n)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        seed = torch.where(_p(params["seed_right"], x, x.dim()), x[..., 1:2, :], x[..., 0:1, :])
        return seed.expand(x.shape)


class Distortion:
    """hard_clip / overdrive / soft_sine / tanh / bit_crusher, in the
    reference's mode order (``common_audioeffects.py:296-366``). 'overdrive'
    is the JAX package's libsox-free version (pre-gain, colour offset, cubic
    soft clip, a DC-blocking one-pole, 3:1 wet/dry); no shipped chain uses it.
    Its DC blocker is a sequential biquad, run only when a draw asks for it."""

    name = "distortion"

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {
            "mode": torch.randint(0, 5, (n,), generator=gen),
            "threshold_db": _uniform(gen, n, -20.0, 0.0),
            "drive_db": _uniform(gen, n, 0.0, 20.0),
            "colour": _uniform(gen, n, 0.0, 100.0),
            "bits": torch.randint(8, 13, (n,), generator=gen),
        }

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        nd = x.dim()
        drive = torch.pow(10.0, _p(params["drive_db"], x, nd) / 20.0)
        thr = torch.pow(10.0, _p(params["threshold_db"], x, nd) / 20.0)
        mode = _p(params["mode"], x, nd, dtype=torch.int64)

        hard = torch.minimum(torch.maximum(x * drive, -thr), thr)
        soft = torch.sin(2.0 * (x * drive).clamp(-math.pi / 4, math.pi / 4))
        tanh = torch.tanh(2.0 * x * drive)
        scale = torch.pow(2.0, _p(params["bits"], x, nd))
        crush = torch.round(x * scale) / scale
        y = torch.where(mode == 0, hard, torch.where(mode == 2, soft, torch.where(mode == 3, tanh, crush)))
        if bool((mode == 1).any()):
            d = x * drive + _p(params.get("colour", 20.0), x, nd) / 200.0
            q = torch.where(d < -1.0, -2.0 / 3.0, torch.where(d > 1.0, 2.0 / 3.0, d - d**3 / 3.0))
            dc_block = torch.tensor([1.0, -1.0, 0.0, -0.995, 0.0], dtype=x.dtype, device=x.device)
            over = 0.75 * biquad_apply_scan(q, dc_block) + 0.25 * x
            y = torch.where(mode == 1, over, y)
        # normalize back up if distortion crushed the amplitude (:359-364)
        x_max = x.abs().amax((-2, -1), keepdim=True) + 1e-8
        y_max = y.abs().amax((-2, -1), keepdim=True) + 1e-8
        return torch.where(x_max > y_max, y * (x_max / y_max), y)


class Equaliser:
    """Five-band parametric EQ: low shelf, 3 peaking bands, high shelf
    (reference ``common_audioeffects.py:370-525``). Each band is an RBJ
    biquad on its analytic poles, designed in float32 as in the JAX package;
    below 32768 samples the bands run as log-depth scans in float64, from
    32768 on the cascade is one spectral multiply (``biquad_cascade_fft``)."""

    name = "eq"

    BAND_FREQS = {
        "low_shelf": (30.0, 200.0),
        "first_band": (200.0, 1000.0),
        "second_band": (1000.0, 3000.0),
        "third_band": (3000.0, 8000.0),
        "high_shelf": (5000.0, 10000.0),
    }

    def __init__(
        self,
        sample_rate=44100,
        gain_range=(-15.0, 15.0),
        q_range=(0.1, 2.0),
        bands=("low_shelf", "first_band", "second_band", "third_band", "high_shelf"),
        hard_clip=False,
        fixed_params: Optional[Dict[str, float]] = None,
    ):
        self.sample_rate = sample_rate
        self.gain_range = gain_range
        self.q_range = q_range
        self.bands = tuple(bands)
        self.hard_clip = hard_clip
        self.fixed_params = fixed_params or {}

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        params = {}
        for band in self.bands:
            ranges = [("gain", self.gain_range), ("freq", self.BAND_FREQS[band])]
            if band not in ("low_shelf", "high_shelf"):
                ranges.append(("q", self.q_range))
            for what, rng in ranges:
                fixed = self.fixed_params.get(f"{band}_{what}")
                params[f"{band}_{what}"] = (
                    torch.full((n,), float(fixed)) if fixed is not None else _uniform(gen, n, *rng)
                )
        # the filters designed here, on the host: the card's float32 cos and pow
        # differ from the CPU's by an ulp, which moves these poles near the unit
        # circle by ~1e-4 of the output; a plan carries one design to both
        cs, ps = self.design(params)
        params["coeffs"], params["poles"] = cs.movedim(0, -2), ps.movedim(0, -2)
        return params

    def design(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """``([n_bands, ..., 5], [n_bands, ..., 2])``: coefficients and poles
        (float32, as the JAX package designs them), with the parameters'
        shape in the middle."""
        cs, ps = [], []
        for band in self.bands:
            if band in ("low_shelf", "high_shelf"):
                q, ftype = 0.707, band
            else:
                q, ftype = torch.as_tensor(params[f"{band}_q"], dtype=torch.float32), "peaking"
            args = (
                ftype, torch.as_tensor(params[f"{band}_gain"], dtype=torch.float32), q,
                torch.as_tensor(params[f"{band}_freq"], dtype=torch.float32), self.sample_rate,
            )
            cs.append(rbj_coeffs(*args).movedim(0, -1))
            ps.append(rbj_poles(*args))
        return torch.stack(cs), torch.stack(ps)

    def coeffs(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws' filters: those ``sample`` designed, else designed here."""
        if "coeffs" in params:
            return params["coeffs"].movedim(-2, 0), params["poles"].movedim(-2, 0)
        return self.design(params)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        cs, ps = self.coeffs(params)
        # [n_bands, *S, k] -> [n_bands, *S, 1, ..., k]: broadcast over x's [..., T]
        pad = (1,) * (x.dim() - 1 - (cs.dim() - 2))
        cs = cs.reshape(cs.shape[:-1] + pad + cs.shape[-1:]).to(x.device)
        ps = ps.reshape(ps.shape[:-1] + pad + ps.shape[-1:]).to(x.device)
        if x.shape[-1] >= 32768:
            y = biquad_cascade_fft(x, cs)
        else:
            # the scans in float64: the float32 scans of these near-unit-circle
            # poles lose ~1e-4 of the output, and the card's rounding (FMAs)
            # differs from the CPU's; in float64 both give the designed filter
            y = x.double()
            for i in range(len(self.bands)):
                y = biquad_apply(y, cs[i].double(), poles=ps[i].to(torch.complex128))
            y = y.to(x.dtype)
        if self.hard_clip:
            y = y.clamp(-1.0, 1.0)
        return y


class Compressor:
    """Single-band compressor (reference ``common_audioeffects.py:590-661``):
    per channel, zero initial envelope, no make-up gain. It runs through
    ``ops/compressor.py:compressor_process``, so on the card through K2;
    ``blockwise=True`` takes the chunk-parallel approximation there (one
    launch over the signal's 4096-sample blocks, each from a zero envelope
    8192 samples earlier). No default chain sets it."""

    name = "comp"

    def __init__(
        self,
        sample_rate=44100,
        threshold_range=(-80.0, -5.0),
        attack_range=(1.0, 20.0),
        release_range=(50.0, 500.0),
        ratio_range=(4.0, 40.0),
        blockwise=False,
    ):
        self.sample_rate = sample_rate
        self.threshold_range = threshold_range
        self.attack_range = attack_range
        self.release_range = release_range
        self.ratio_range = ratio_range
        self.blockwise = blockwise

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {
            "threshold": _uniform(gen, n, *self.threshold_range),
            "attack_ms": _uniform(gen, n, *self.attack_range),
            "release_ms": _uniform(gen, n, *self.release_range),
            "ratio": _uniform(gen, n, *self.ratio_range),
        }

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        nd = x.dim() - 1
        th, att, rel, ratio = (
            _p(params[k], x, nd) for k in ("threshold", "attack_ms", "release_ms", "ratio")
        )
        return compressor_process(x, th, att, rel, ratio, sample_rate=self.sample_rate,
                                  blockwise=self.blockwise)


class AlgorithmicReverb:
    """Freeverb-topology reverb (reference ``common_audioeffects.py:1429-1537``):
    8 damped feedback combs into 4 series allpasses per channel, stereo
    spread 23 samples, input scale 0.2. For fixed parameters the network is
    linear time-invariant, so its exact transfer function, evaluated at rfft
    bins, is applied as one spectral multiply (zero-padded by ``tail``
    seconds so the tail decays).

    ``reference_compat=True`` (default) keeps the reference's overwrite of
    the comb accumulator at comb 5 (``common_audioeffects.py:1478``): only
    combs 5-8 contribute. ``ALLPASS_DELAYS_R`` keeps its 225 -> 255 typo.
    """

    name = "algorithmic_reverb"

    COMB_DELAYS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
    ALLPASS_DELAYS = (556, 441, 341, 225)
    ALLPASS_DELAYS_R = (556, 441, 341, 255)  # reference's 225+ss typo: R4 uses 255+ss
    STEREO_SPREAD = 23
    SCALE_GAIN = 0.2

    def __init__(self, sample_rate=44100, tail: float = 2.0, reference_compat=True):
        self.sample_rate = sample_rate
        self.tail = tail
        self.reference_compat = reference_compat

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        return {
            "room_size": _uniform(gen, n, 0.05, 0.85),
            "damping": _uniform(gen, n, 0.0, 1.0),
            "dry_mix": _uniform(gen, n, 0.0, 1.0),
            "wet_mix": _uniform(gen, n, 0.0, 1.0),
            "width": _uniform(gen, n, 0.0, 1.0),
        }

    def _channel_response(self, omega, rs, dp, spread: int, right: bool) -> torch.Tensor:
        """Exact H(e^{jw}) of one channel's combs and allpasses, complex64;
        ``rs`` and ``dp`` broadcast against ``omega``."""
        damp1, damp2 = dp, 1.0 - dp
        zm1 = torch.exp(-1j * omega)
        comb_delays = self.COMB_DELAYS[4:] if self.reference_compat else self.COMB_DELAYS
        H = torch.zeros((), dtype=torch.complex64, device=omega.device)
        for d in comb_delays:
            zd = torch.exp(-1j * omega * (d + spread))
            # comb: Y/X = z^-d (1 - damp1 z^-1) / (1 - damp1 z^-1 - rs*damp2 z^-d); the
            # epsilon keeps the removable damping -> 1 DC singularity finite
            one_pole = 1.0 - damp1 * zm1
            H = H + zd * one_pole / (one_pole - rs * damp2 * zd + 1e-9)
        for d in self.ALLPASS_DELAYS_R if right else self.ALLPASS_DELAYS:
            zd = torch.exp(-1j * omega * (d + spread))
            # allpass: (-1 + (1+rs) z^-d) / (1 - rs z^-d)
            H = H * (-1.0 + (1.0 + rs) * zd) / (1.0 - rs * zd)
        return H * self.SCALE_GAIN

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[-1]
        n = 1 << int(math.ceil(math.log2(T + int(self.tail * self.sample_rate))))
        freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=x.device)
        omega = 2.0 * math.pi * freqs / n
        nd = x.dim() - 1  # per-channel signals [..., T] and spectra [..., M]
        rs, dp = _p(params["room_size"], x, nd), _p(params["damping"], x, nd)
        H_l = self._channel_response(omega, rs, dp, 0, right=False)
        H_r = self._channel_response(omega, rs, dp, self.STEREO_SPREAD, right=True)

        X = torch.fft.rfft(x, n=n, dim=-1)  # [..., 2, n//2+1]
        xl_wet = torch.fft.irfft(X[..., 0, :] * H_l, n=n, dim=-1)[..., :T]
        xr_wet = torch.fft.irfft(X[..., 1, :] * H_r, n=n, dim=-1)[..., :T]

        wet_mix, width = _p(params["wet_mix"], x, nd), _p(params["width"], x, nd)
        wet1 = wet_mix * (width / 2 + 0.5)
        wet2 = wet_mix * ((1 - width) / 2)
        dry = _p(params["dry_mix"], x, nd)
        out_l = wet1 * xl_wet + wet2 * xr_wet + dry * x[..., 0, :]
        out_r = wet1 * xr_wet + wet2 * xl_wet + dry * x[..., 1, :]
        return torch.stack([out_l, out_r], dim=-2)


class ConvolutionalReverb:
    """IR-bank convolution reverb (reference ``common_audioeffects.py:665-764``):
    an IR bank ``[n_irs, 2, max_len]`` (zero padded), each IR's peak index,
    FFT convolution from the peak on, and a wet/dry mix."""

    name = "reverb"

    def __init__(
        self,
        ir_bank: np.ndarray,
        sample_rate=44100,
        wet=1.0,
        dry=0.0,
        bucket_bounds: Optional[np.ndarray] = None,
    ):
        ir = np.asarray(ir_bank, np.float32)
        assert ir.ndim == 3 and ir.shape[1] == 2, "IR bank must be [n, 2, L]"
        self.ir_bank = torch.from_numpy(ir)
        self.peak_idx = torch.from_numpy(np.argmax(np.max(np.abs(ir), axis=1), axis=-1))  # [n]
        self.sample_rate = sample_rate
        self.wet = wet
        self.dry = dry
        # RT60 buckets: uniform over buckets, then uniform within the bucket
        # (reference samples IRs "according to RT60", common_audioeffects.py:714-717)
        self.bucket_bounds = (
            torch.as_tensor(np.asarray(bucket_bounds), dtype=torch.int64)
            if bucket_bounds is not None else None
        )

    def sample(self, gen, n: int) -> Dict[str, torch.Tensor]:
        if self.bucket_bounds is None:
            return {"index": torch.randint(0, self.ir_bank.shape[0], (n,), generator=gen)}
        b = torch.randint(0, self.bucket_bounds.shape[0] - 1, (n,), generator=gen)
        lo, hi = self.bucket_bounds[b], self.bucket_bounds[b + 1]
        span = torch.maximum(hi, lo + 1) - lo
        u = torch.rand(n, generator=gen, dtype=torch.float64)
        return {"index": lo + torch.minimum((u * span).long(), span - 1)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        index = torch.as_tensor(params["index"], dtype=torch.int64)
        bank = self.ir_bank.to(x.device)
        h = bank[index.to(x.device)]  # [*S, 2, L]
        h = h.reshape(tuple(index.shape) + (1,) * (x.dim() - 2 - index.dim()) + h.shape[-2:])
        y = fft_convolve_full(x, h)
        T = x.shape[-1]
        start = _p(self.peak_idx.to(x.device)[index.to(x.device)], x, x.dim(), dtype=torch.int64)
        pos = start + torch.arange(T, device=x.device)
        y = torch.gather(y, -1, pos.expand(y.shape[:-1] + (T,)))
        return self.dry * x + self.wet * y
