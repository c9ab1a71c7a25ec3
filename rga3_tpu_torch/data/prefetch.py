"""Background batch prefetching, counterpart of `rga3_tpu/data/prefetch.py`
in its ``indexed=True`` mode, the one the training loop uses.

Worker threads (the per-sample work is PIL, OpenCV and numpy, which release
the GIL) claim increasing batch indices and fill a bounded buffer, so host
batch assembly overlaps the device steps. Batches are delivered in index
order: the k-th batch is `make_batch(k)` whatever the threads' timing.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class PrefetchLoader:
    """Iterator over `make_batch(0)`, `make_batch(1)`, ... produced in
    background threads. `num_workers=0` degrades to synchronous calls."""

    def __init__(self, make_batch: Callable[[int], Any], num_workers: int = 2,
                 buffer_size: int = 4):
        self.make_batch = make_batch
        self.num_workers = num_workers
        self._next_consume = 0
        if num_workers <= 0:
            return
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._cond = threading.Condition(threading.Lock())
        self._next_produce = 0
        self._ready: dict = {}
        self._buffer_size = max(buffer_size, num_workers)
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._cond:
                # bound memory: don't run ahead of the consumer
                while (self._next_produce - self._next_consume >= self._buffer_size
                       and not self._stop.is_set()):
                    self._cond.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                idx = self._next_produce
                self._next_produce += 1
            try:
                batch = self.make_batch(idx)
            except BaseException as e:  # surfaced on the next __next__
                self._error = e
                self._stop.set()
                with self._cond:
                    self._cond.notify_all()
                return
            with self._cond:
                self._ready[idx] = batch
                self._cond.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        if self.num_workers <= 0:
            idx = self._next_consume
            self._next_consume += 1
            return self.make_batch(idx)
        with self._cond:
            while self._next_consume not in self._ready:
                if self._error is not None:
                    raise self._error
                if self._stop.is_set():
                    raise StopIteration
                self._cond.wait(timeout=0.5)
            batch = self._ready.pop(self._next_consume)
            self._next_consume += 1
            self._cond.notify_all()
            return batch

    def close(self):
        if self.num_workers > 0:
            self._stop.set()
            with self._cond:
                self._ready.clear()
                self._cond.notify_all()
            for t in self._threads:
                t.join(timeout=2.0)
