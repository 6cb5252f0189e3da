"""Background-thread batch prefetching and an ordered thread map.

The port's copy of pointnet2_tpu/utils/prefetch.py. A daemon thread loads
host batches ahead of the step that consumes them, so host-side loading
and augmentation overlap the card's work; ``parallel_map`` runs a numpy
item producer (the ScanNet crop sampler) on a small thread pool, in order.
"""

from __future__ import annotations

import collections
import queue
import threading
from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor


class _ExceptionWrapper:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


def parallel_map(fn, items: Iterable, workers: int,
                 ahead: int | None = None) -> Iterator:
    """Order-preserving lazy thread map with at most `ahead` results in
    flight (default 2x workers). Numpy-heavy producers release the GIL for
    most of their work, so threads overlap them without process spawns."""
    if workers <= 1:
        for x in items:
            yield fn(x)
        return
    ahead = ahead if ahead is not None else workers * 2
    dq: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        try:
            for x in items:
                dq.append(ex.submit(fn, x))
                if len(dq) >= ahead:
                    yield dq.popleft().result()
            while dq:
                yield dq.popleft().result()
        finally:
            for f in dq:
                f.cancel()


class Prefetcher(Iterator):
    """Produce an iterable's items on a background thread, at most `depth`
    ahead. Exceptions of the iterable re-raise at the consumer. ``close()``
    stops the producer early; it is also safe after exhaustion."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iterable,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, iterable) -> None:
        try:
            for item in iterable:
                if not self._put(item):
                    return
            self._put(_END)
        except BaseException as exc:  # noqa: BLE001 (forwarded)
            self._put(_ExceptionWrapper(exc))

    def __iter__(self) -> "Prefetcher":
        return self

    def waiting(self) -> bool:
        """Whether a ``next()`` now would wait: no item is queued."""
        return self._q.empty()

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, _ExceptionWrapper):
            self._stop.set()
            raise item.exc
        return item

    def close(self) -> None:
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
