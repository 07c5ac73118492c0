"""Threaded host feed pipeline: producer threads → host ring → scheduler.

≈ reference IO-bound thread pool + ring buffers between hardware sources and the
graph (thread_pool.hpp TaskType::IO_BOUND, BlockingSync.hpp): a producer thread
(file reader, socket, SDR driver) fills a :class:`HostRing`; the scheduler's
feed path drains exactly one time-block per step. The ring absorbs producer
jitter so device dispatch never stalls on IO.

The JAX package's ring is a native double-mapped buffer (``native/ring.py``);
this one is NumPy under a condition variable, with the same calls.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator

import numpy as np

from ..utils import thread_pool


class HostRing:
    """Single-writer, multi-reader ring of ``capacity_items`` samples. The
    writer waits while the slowest reader is a full ring behind."""

    def __init__(self, capacity_items: int, dtype=np.float32):
        self.capacity = int(capacity_items)
        self.buf = np.zeros(self.capacity, dtype=np.dtype(dtype))
        self._written = 0
        self._readers: list[int] = []
        self._eos = False
        self._cv = threading.Condition()

    def add_reader(self) -> int:
        with self._cv:
            self._readers.append(self._written)
            return len(self._readers) - 1

    def _writable(self) -> int:
        oldest = min(self._readers, default=self._written)
        return self.capacity - (self._written - oldest)

    def write(self, data: np.ndarray, *, timeout: float = 30.0) -> int:
        """Copy as much of ``data`` as fits, waiting up to ``timeout`` for
        room; returns the number of items written."""
        data = np.asarray(data, dtype=self.buf.dtype).ravel()
        with self._cv:
            self._cv.wait_for(lambda: self._writable() > 0 or self._eos, timeout)
            n = min(len(data), self._writable())
            if self._eos or n <= 0:
                return 0
            at = self._written % self.capacity
            first = min(n, self.capacity - at)
            self.buf[at:at + first] = data[:first]
            self.buf[:n - first] = data[first:n]
            self._written += n
            self._cv.notify_all()
            return n

    def readable(self, reader: int) -> int:
        with self._cv:
            return self._written - self._readers[reader]

    def read(self, reader: int, max_n: int = 0) -> np.ndarray:
        """A copy of the next ``max_n`` readable items (all when 0); they stay
        in the ring until :meth:`release`."""
        with self._cv:
            pos = self._readers[reader]
            n = self._written - pos
            if max_n:
                n = min(n, max_n)
            idx = (pos + np.arange(n)) % self.capacity
            return self.buf[idx]

    def release(self, reader: int, n: int) -> None:
        with self._cv:
            self._readers[reader] += n
            self._cv.notify_all()

    def wait_readable(self, reader: int, n: int, timeout: float = 30.0) -> int:
        """Wait until ``n`` items are readable or EOS; -1 on timeout."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._written - self._readers[reader] >= n or self._eos,
                timeout)
            return self._written - self._readers[reader] if ok else -1

    def set_eos(self) -> None:
        with self._cv:
            self._eos = True
            self._cv.notify_all()

    @property
    def eos(self) -> bool:
        return self._eos


class ThreadedFeeder:
    """Pumps arrays from an iterator into a ring on a daemon thread."""

    def __init__(self, source: Iterable[np.ndarray] | Iterator[np.ndarray],
                 dtype, *, capacity_items: int = 1 << 20, name: str = "feeder"):
        self.ring = HostRing(capacity_items, dtype=dtype)
        # the consumer slot must exist BEFORE the producer thread starts, else
        # the writer (with no readers) runs ahead and early data is lost
        self.reader = self.ring.add_reader()
        self._iter = iter(source)
        self._name = name
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None
        self._started = False

    def start(self) -> "ThreadedFeeder":
        if not self._started:
            self._started = True
            self._thread = thread_pool.spawn(self._run, name=self._name)
        return self

    def _run(self) -> None:
        try:
            for chunk in self._iter:
                arr = np.asarray(chunk).ravel()
                done = 0
                while done < len(arr):
                    wrote = self.ring.write(arr[done:], timeout=1.0)
                    done += wrote
                    if wrote == 0 and self.ring.eos:
                        return
        except Exception as e:  # surface to the scheduler via error attr
            self.error = e
        finally:
            self.ring.set_eos()

    def stop(self) -> None:
        self.ring.set_eos()


def read_exact(ring: HostRing, reader: int, n: int, *,
               timeout: float = 30.0) -> np.ndarray | None:
    """Wait (on the ring's condition variable, woken by the producer) until
    ``n`` items are readable or the stream ended, and take up to ``n``.
    Returns None at EOS with nothing left."""
    if ring.wait_readable(reader, n, timeout=timeout) == -1:
        raise TimeoutError(f"ring feed starved (< {n} items for {timeout}s)")
    take = min(n, ring.readable(reader))
    if take == 0:
        return None
    out = ring.read(reader, take)
    ring.release(reader, take)
    return out
