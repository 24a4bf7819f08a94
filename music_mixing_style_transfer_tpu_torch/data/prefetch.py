"""Background batch prefetching for the training input pipeline.

Counterpart of ``music_mixing_style_transfer_tpu/data/prefetch.py``. The
reference hides data-prep latency behind torch DataLoader worker processes
(``style_transfer.py:67-71``); here host work is only WAV I/O, the crop
plan and the FX plan draw (all FX run on the card), so one prefetch thread
that stays a batch ahead of the card is enough: the card's queued work
overlaps with the next batch's disk reads.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class BatchPrefetcher:
    """Iterate ``make_batch(step_idx)`` results one step ahead on a thread.

    Exceptions raised by ``make_batch`` are re-raised at the consuming site.
    """

    def __init__(self, make_batch: Callable[[int], object], n_steps: int, depth: int = 2):
        self._make = make_batch
        self._n = n_steps
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        for i in range(self._n):
            try:
                self._q.put((None, self._make(i)))
            except Exception as e:  # surfaced to the consumer
                self._q.put((e, None))
                return
        self._q.put((StopIteration(), None))

    def __iter__(self) -> Iterator[object]:
        while True:
            err, batch = self._q.get()
            if isinstance(err, StopIteration):
                return
            if err is not None:
                raise err
            yield batch
