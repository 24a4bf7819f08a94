"""WAV I/O using only stdlib + numpy.

The port's copy of ``music_mixing_style_transfer_tpu/data/wavio.py``.
Replaces the reference's soundfile/librosa loaders
(``data_loader/loader_utils.py:31-70``, ``common_dataprocessing.py:26-89``)
— the deployment image carries neither. Reads 16/24/32-bit integer PCM and
32/64-bit IEEE float, plain or WAVE_FORMAT_EXTENSIBLE, via a minimal RIFF
parser (the stdlib ``wave`` module rejects float and EXTENSIBLE files);
writes 16-bit PCM. Same format coverage as the native C++ bank
(``cpp/mstio.cc``).
"""
from __future__ import annotations

import os
import struct
import wave
from typing import NamedTuple, Optional, Tuple

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


class _WavInfo(NamedTuple):
    rate: int
    channels: int
    width: int  # bytes per sample
    is_float: bool
    data_start: int  # byte offset of sample data
    n_frames: int


def _parse_header(path: str) -> _WavInfo:
    """Minimal RIFF/WAVE header parse: ``fmt `` + ``data`` chunks, other
    chunks skipped (word-aligned), EXTENSIBLE resolved via its sub-format."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate = channels = width = None
        is_float = False
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(size)
                tag, channels, rate = struct.unpack("<HHI", body[:8])
                bits = struct.unpack("<H", body[14:16])[0]
                if tag == _FMT_EXTENSIBLE:
                    if size < 26:
                        raise ValueError(f"{path}: truncated EXTENSIBLE fmt")
                    tag = struct.unpack("<H", body[24:26])[0]
                if tag == _FMT_FLOAT:
                    is_float = True
                elif tag != _FMT_PCM:
                    raise ValueError(f"{path}: unsupported WAV format tag {tag}")
                width = bits // 8
                if size % 2:
                    f.seek(1, 1)
            elif cid == b"data":
                if rate is None:
                    raise ValueError(f"{path}: data chunk before fmt")
                frame = channels * width
                return _WavInfo(
                    rate, channels, width, is_float, f.tell(), size // frame
                )
            else:
                f.seek(size + (size % 2), 1)


def _decode(raw: bytes, info: _WavInfo, path: str) -> np.ndarray:
    """Decode interleaved sample bytes to float32 in [-1, 1]."""
    if info.is_float:
        if info.width == 4:
            return np.frombuffer(raw, dtype="<f4").astype(np.float32)
        if info.width == 8:
            return np.frombuffer(raw, dtype="<f8").astype(np.float32)
        raise ValueError(f"{path}: unsupported float width {info.width * 8}-bit")
    if info.width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 2.0**15
    if info.width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x -= (x & 0x800000) << 1  # sign-extend 24-bit
        return x.astype(np.float32) / 2.0**23
    if info.width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2.0**31
    raise ValueError(f"{path}: unsupported sample width {info.width * 8}-bit")


def wav_length(path: str) -> int:
    """Number of frames in a WAV file (reference ``load_wav_length``)."""
    return _parse_header(path).n_frames


def total_wav_length(paths) -> int:
    """Frames summed over WAV files."""
    return sum(wav_length(p) for p in paths)


def read_wav(
    path: str,
    start: int = 0,
    duration: Optional[int] = None,
    expected_rate: Optional[int] = 44100,
) -> Tuple[np.ndarray, int]:
    """Read (a segment of) a WAV file: int PCM 16/24/32-bit or float 32/64.

    Returns ``(audio [T, C] float32 in [-1, 1], sample_rate)``.
    """
    info = _parse_header(path)
    if expected_rate is not None and info.rate != expected_rate:
        raise ValueError(
            f"{path}: sample rate {info.rate} != expected {expected_rate}"
        )
    if duration is None:
        duration = info.n_frames - start
    duration = max(0, min(duration, info.n_frames - start))
    frame = info.channels * info.width
    with open(path, "rb") as f:
        f.seek(info.data_start + start * frame)
        raw = f.read(duration * frame)
    return _decode(raw, info, path).reshape(-1, info.channels), info.rate


def write_wav(path: str, audio: np.ndarray, rate: int = 44100) -> None:
    """Write audio ``[T, C]`` (or ``[T]``) as 16-bit PCM.

    Float input is scaled/clipped; ``int16`` input is written verbatim (the
    device-resident inference path quantizes on device and downloads PCM)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if audio.dtype == np.int16:
        pcm = audio.astype("<i2", copy=False)
    else:
        audio = np.nan_to_num(audio, nan=0.0, posinf=1.0, neginf=-1.0)
        pcm = np.clip(np.round(audio * 2.0**15), -(2.0**15), 2.0**15 - 1).astype("<i2")
    with wave.open(path, "w") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def read_wav_stereo_ct(path: str, expected_rate: Optional[int] = 44100) -> np.ndarray:
    """Read whole file as ``[2, T]`` float32, duplicating mono to stereo."""
    x, _ = read_wav(path, expected_rate=expected_rate)
    x = x.T  # [C, T]
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    return x


def read_wav_stereo_ct_i16(path: str, expected_rate: Optional[int] = 44100) -> np.ndarray:
    """Read whole 16-bit PCM file as RAW ``[2, T]`` int16 (mono duplicated).

    The device-resident inference path uploads PCM and dequantizes on device
    — half the host->device traffic of float32 with zero quality loss
    (``x/32768`` reproduces :func:`read_wav` exactly)."""
    info = _parse_header(path)
    if expected_rate is not None and info.rate != expected_rate:
        raise ValueError(
            f"{path}: sample rate {info.rate} != expected {expected_rate}"
        )
    if info.width != 2 or info.is_float:
        raise ValueError(f"{path}: int16 fast path needs 16-bit PCM")
    frame = info.channels * 2
    with open(path, "rb") as f:
        f.seek(info.data_start)
        raw = f.read(info.n_frames * frame)
    x = np.frombuffer(raw, dtype="<i2").reshape(-1, info.channels).T
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    return np.ascontiguousarray(x)
