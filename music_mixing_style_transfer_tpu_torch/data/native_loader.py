"""Native wav bank: multithreaded C++ segment reads for the training data.

The port's copy of ``music_mixing_style_transfer_tpu/data/native_loader.py``.
The reference hides WAV-read latency behind ``DataLoader(num_workers=...)``
worker processes (reference ``style_transfer.py:67-71``, reads via stdlib
``wave`` in ``loader_utils.py:47-70``). The bank (``cpp/mstio.cc``, built
by ``native.py``) parses the headers once, then reads a whole batch
``[n, 2, duration]`` with ``pread`` on a thread pool in one ctypes call: no
worker processes, no Python loop over segments.

:func:`open_wav_bank` returns ``None`` when the library is unavailable or a
file fails to parse; callers then read through ``wavio``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from .. import native


class WavBank:
    """Persistent native handle over a fixed list of WAV files.

    ``read_segments(file_idx, starts, duration)`` returns ``[n, 2, duration]``
    float32: mono duplicated to stereo, >2 channels truncated, reads past EOF
    zero-padded: the ``wavio.read_wav`` conventions, byte for byte
    (``tests/test_torch_native.py``).
    """

    def __init__(self, paths: Sequence[str], lib: ctypes.CDLL):
        self._lib = lib
        self._paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = lib.mst_wavbank_create(arr, len(self._paths))
        self.ok = [bool(lib.mst_wavbank_ok(self._handle, i)) for i in range(len(self._paths))]
        self.frames = [int(lib.mst_wavbank_frames(self._handle, i)) for i in range(len(self._paths))]
        self.rates = [int(lib.mst_wavbank_rate(self._handle, i)) for i in range(len(self._paths))]
        self.channels = [int(lib.mst_wavbank_channels(self._handle, i)) for i in range(len(self._paths))]

    def __len__(self) -> int:
        return len(self._paths)

    def read_segments(
        self,
        file_idx: Sequence[int],
        starts: Sequence[int],
        duration: int,
        n_threads: int = 0,
    ) -> np.ndarray:
        if self._handle is None:
            raise ValueError("WavBank is closed")
        fi = np.ascontiguousarray(file_idx, np.int64)
        st = np.ascontiguousarray(starts, np.int64)
        if fi.shape != st.shape or fi.ndim != 1:
            raise ValueError("file_idx and starts must be equal-length 1-D")
        if duration <= 0:
            raise ValueError(f"duration must be positive, got {duration}")
        if fi.size and (fi.min() < 0 or fi.max() >= len(self._paths)):
            raise IndexError(f"file index out of range [0, {len(self._paths)})")
        if fi.size and st.min() < 0:
            raise ValueError("segment starts must be non-negative")
        out = np.empty((fi.shape[0], 2, duration), np.float32)
        n_ok = self._lib.mst_wavbank_read_segments(
            self._handle,
            fi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            fi.shape[0],
            duration,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(n_threads),
        )
        if n_ok != fi.shape[0]:
            # name the failing files by single-segment retries (the error path
            # only, such as a file truncated or unlinked after the bank opened)
            bad = sorted(
                {
                    self._paths[int(f)]
                    for f, s in zip(fi, st)
                    if self._lib.mst_wavbank_read_segments(
                        self._handle,
                        np.asarray([f], np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        np.asarray([s], np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        1, duration,
                        np.empty((1, 2, duration), np.float32).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        1,
                    )
                    != 1
                }
            )
            raise IOError(
                f"native wav bank failed on {fi.shape[0] - n_ok} of {fi.shape[0]} "
                f"segments; failing files: {bad or 'transient (retry succeeded)'}"
            )
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.mst_wavbank_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def open_wav_bank(paths: Sequence[str]) -> Optional[WavBank]:
    """A native :class:`WavBank` over ``paths``, or ``None`` if the C++
    library is unavailable or any file fails to parse (the caller reads
    through ``wavio`` instead)."""
    lib = native.get_lib()
    if lib is None:
        return None
    bank = WavBank(paths, lib)
    if not all(bank.ok):
        bank.close()
        return None
    return bank
