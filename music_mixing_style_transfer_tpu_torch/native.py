"""ctypes bindings for the native host library built from ``cpp/``.

The port's own copy of ``music_mixing_style_transfer_tpu/native.py``. The
library (``cpp/mstdsp.cc``: the sequential compressor envelope follower and
biquad cascade; ``cpp/mstio.cc``: the wav bank) serves as

- the host oracles of the recurrent DSP (``compressor_process``,
  ``biquad_lfilter``, ``biquad_cascade``), held against the port's plain
  versions in the tests;
- the training datasets' segment reader (``data/native_loader.py``).

It is compiled at first use by ``g++`` from the ``cpp/`` sources as they are
into ``_build/libmstdsp-<hash>.so`` inside the package, keyed by a hash of
the sources and the flags, under a file lock (test workers build at once),
through a temporary name and an atomic rename. It never writes
``cpp/libmstdsp.so``, the JAX package's build. The flags leave out the
Makefile's ``-march=native``: a build directory copied with the checkout
to another host must still run there. Every entry point reports
unavailability (``None`` / ``RuntimeError``) where there is no compiler.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CPP_DIR = os.path.join(os.path.dirname(PKG_DIR), "cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("mstdsp.cc", "mstio.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 120


def library_path() -> str:
    """``_build/libmstdsp-<hash of the sources and flags>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CPP_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmstdsp-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` without a compiler or when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH for the native library")
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libmstdsp.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # another process built it meanwhile
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(CPP_DIR, s) for s in SOURCES)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"g++ timed out after {BUILD_TIMEOUT_S} s") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for the native library:\n{proc.stderr}")
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
            return path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, f64p, i64p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_double, ctypes.c_int64))
    i64, dbl = ctypes.c_int64, ctypes.c_double
    lib.mst_compressor_process_mc.restype = None
    lib.mst_compressor_process_mc.argtypes = [f32p, f32p, i64, i64] + [dbl] * 6
    lib.mst_biquad_lfilter.restype = None
    lib.mst_biquad_lfilter.argtypes = [f32p, f32p, i64, f64p]
    lib.mst_biquad_cascade.restype = None
    lib.mst_biquad_cascade.argtypes = [f32p, f32p, i64, f64p, i64]
    lib.mst_wavbank_create.restype = ctypes.c_void_p
    lib.mst_wavbank_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64]
    for name, res in (("mst_wavbank_ok", ctypes.c_int32), ("mst_wavbank_rate", ctypes.c_int32),
                      ("mst_wavbank_channels", ctypes.c_int32), ("mst_wavbank_frames", i64)):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p, i64]
    lib.mst_wavbank_read_segments.restype = i64
    lib.mst_wavbank_read_segments.argtypes = [
        ctypes.c_void_p, i64p, i64p, i64, i64, f32p, ctypes.c_int32,
    ]
    lib.mst_wavbank_destroy.restype = None
    lib.mst_wavbank_destroy.argtypes = [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; ``None`` if it cannot be
    built or loaded (the result, either way, holds for the process)."""
    try:
        return _bind(ctypes.CDLL(build()))
    except (RuntimeError, OSError):
        return None


def available() -> bool:
    return get_lib() is not None


def _lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable (no compiler?)")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def compressor_process(
    x: np.ndarray,
    threshold: float,
    attack_ms: float,
    release_ms: float,
    ratio: float,
    makeup_db: float = 0.0,
    sample_rate: float = 44100.0,
) -> np.ndarray:
    """The reference's branchy compressor loop over the last axis of
    ``x [..., T]`` (channels independent, zero initial envelope)."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    x2 = x.reshape(-1, x.shape[-1])
    y = np.empty_like(x2)
    lib.mst_compressor_process_mc(
        _fptr(x2), _fptr(y), x2.shape[0], x2.shape[1], float(threshold), float(attack_ms),
        float(release_ms), float(ratio), float(makeup_db), float(sample_rate),
    )
    return y.reshape(x.shape)


def biquad_lfilter(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """DF2T biquad over 1-D ``x``; ``coeffs = [b0, b1, b2, a1, a2]``."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    c = np.ascontiguousarray(coeffs, np.float64)
    y = np.empty_like(x)
    lib.mst_biquad_lfilter(_fptr(x), _fptr(y), x.shape[0], _dptr(c))
    return y


def biquad_cascade(x: np.ndarray, coeffs_list: np.ndarray) -> np.ndarray:
    """Biquads in series over 1-D ``x``; ``coeffs_list [n_filters, 5]``."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    c = np.ascontiguousarray(coeffs_list, np.float64)
    y = np.empty_like(x)
    lib.mst_biquad_cascade(_fptr(x), _fptr(y), x.shape[0], _dptr(c), c.shape[0])
    return y
