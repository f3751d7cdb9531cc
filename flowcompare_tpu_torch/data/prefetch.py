"""Host-side batch prefetching.

Counterpart of `flowcompare_tpu/data/prefetch.py`: one thread builds
batches ahead of the training loop, so FPS and normalization (numpy and
the native ops, which release the GIL) overlap device compute. A thread
and not DataLoader workers: a loader's items draw from one generator in
item order, which worker copies would split.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterator:
    """Iterates `iterable` in a daemon thread, up to `prefetch` items ahead.
    An exception in the thread is raised on the consumer's side. Dropping
    or closing the iterator before the end stops the thread."""

    def __init__(self, iterable: Iterable, prefetch: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._sentinel = sentinel = object()
        self._err: list = []
        q, stop, err = self._queue, self._stop, self._err

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            # the closure holds the queue and the flags, never the iterator,
            # so dropping the iterator reaches __del__ while this runs
            try:
                for item in iterable:
                    if not put(item):
                        return
            except BaseException as e:  # re-raised in the consumer's thread
                err.append(e)
            put(sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._sentinel:
            self._stop.set()
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread; it exits within 0.1 s of its next put."""
        self._stop.set()

    def __del__(self):
        self.close()


class PrefetchedDataset:
    """Wrap a re-iterable batch source with background prefetching."""

    def __init__(self, source: Iterable, prefetch: int = 2):
        self.source = source
        self.prefetch = prefetch

    def __iter__(self):
        return PrefetchIterator(iter(self.source), self.prefetch)

    def __len__(self):
        return len(self.source)
