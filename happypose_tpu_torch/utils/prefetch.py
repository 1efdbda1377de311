"""Background prefetching for host-side data pipelines (PyTorch port of
`happypose_tpu/utils/prefetch.py`).

One worker thread runs the wrapped iterator and keeps up to `depth` items
in a bounded queue. PNG decoding (zlib) and tar reads release the
interpreter lock, so the thread overlaps them with the training step. An
exception in the worker is raised in the consumer, never swallowed; `close`
stops the worker and joins it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_POLL_S = 0.1  # how often a blocked worker looks at the stop flag


class PrefetchIterator(Iterator[T]):
    """Wrap an iterator; a worker thread keeps `depth` items ready. Use it
    as a context manager, or call `close`, so the thread ends with it."""

    def __init__(self, it: Iterable[T], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._work, args=(iter(it),), daemon=True)
        self._thread.start()

    def _put(self, entry) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if not self._put((True, item)):
                    return
        except Exception as e:  # noqa: BLE001 -- raised again in the consumer
            self._put((False, e))
            return
        self._put((False, None))

    def __next__(self) -> T:
        if self._done:
            raise StopIteration
        ok, item = self._q.get()
        if ok:
            return item
        self._done = True
        self._thread.join()
        if item is not None:
            raise item
        raise StopIteration

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker (it ends at its next item) and join it."""
        self._stop.set()
        self._done = True
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the prefetch worker did not stop")

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch(it: Iterable[T], depth: int = 4) -> PrefetchIterator[T]:
    return PrefetchIterator(it, depth)
