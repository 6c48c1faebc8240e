"""Background-thread batch prefetcher (the port's own copy of
``ssr_speech_tpu/data/prefetch.py``; nothing in it is JAX-specific).

Replaces the reference's DataLoader worker processes (``steps/trainer.py:337``
num_workers) for the host side of training: batch construction (file reads,
span masking, padding) overlaps with the device step. Threads suffice because
the hot parsing runs in the C++ native module (releases the GIL in I/O) and
the device step dominates.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    """Wrap a batch iterator; keeps up to ``depth`` ready batches."""

    def __init__(self, it: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(loader: Callable[[int], Iterator], depth: int = 4
             ) -> Callable[[int], Iterator]:
    """Wrap an epoch->iterator loader with background prefetching."""

    def wrapped(epoch: int):
        return PrefetchIterator(loader(epoch), depth=depth)

    return wrapped
