"""Threaded host feed pipeline: producer threads → host ring → scheduler.

≈ reference IO-bound thread pool + ring buffers between hardware sources and the
graph (thread_pool.hpp TaskType::IO_BOUND, BlockingSync.hpp): a producer thread
(file reader, socket, SDR driver) fills a :class:`HostRing`; the scheduler's
feed path drains exactly one time-block per step. The ring absorbs producer
jitter so device dispatch never stalls on IO.

The JAX package's ring is a native double-mapped buffer (``native/ring.py``);
this one is NumPy under a condition variable, with the same copying calls
(the native ring's zero-copy ``reserve``/``publish`` are not here).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator

import numpy as np

from ..utils import thread_pool


class HostRing:
    """Multi-reader ring of ``capacity_items`` samples. Writers wait while the
    slowest reader is a full ring behind; concurrent writers take turns.

    Data moves outside the ring's lock: a writer fills the free span before
    it publishes, and a reader copies its span before it releases it, so one
    large write and one large read proceed at the same time. Every call moves
    at most two contiguous slices (the span up to the end of the buffer and
    the wrapped rest)."""

    def __init__(self, capacity_items: int, dtype=np.float32):
        self.capacity = int(capacity_items)
        self.buf = np.zeros(self.capacity, dtype=np.dtype(dtype))
        self._written = 0
        self._readers: list[int] = []
        self._eos = False
        self._cv = threading.Condition()
        self._write_lock = threading.Lock()

    @property
    def dtype(self) -> np.dtype:
        return self.buf.dtype

    def add_reader(self) -> int:
        with self._cv:
            self._readers.append(self._written)
            return len(self._readers) - 1

    def _free(self) -> int:
        oldest = min(self._readers, default=self._written)
        return self.capacity - (self._written - oldest)

    def writable(self) -> int:
        """Items that can be written now without waiting."""
        with self._cv:
            return self._free()

    def write(self, data: np.ndarray, *, block: bool = True,
              timeout: float = 10.0) -> int:
        """Copy ``data`` in. With ``block``, wait for room until all of it is
        written or ``timeout`` seconds have passed; without, write what fits
        now. Returns the number of items written (short only without
        ``block``, on timeout, or once the stream has ended)."""
        data = np.asarray(data, dtype=self.buf.dtype).ravel()
        deadline = time.monotonic() + timeout
        done = 0
        with self._write_lock:
            while done < len(data):
                with self._cv:
                    if self._eos:
                        return done
                    n = min(len(data) - done, self._free())
                    if n <= 0:
                        left = deadline - time.monotonic()
                        if not block or left <= 0:
                            return done
                        self._cv.wait(left)
                        continue
                    at = self._written % self.capacity
                first = min(n, self.capacity - at)
                self.buf[at:at + first] = data[done:done + first]
                self.buf[:n - first] = data[done + first:done + n]
                with self._cv:
                    self._written += n
                    self._cv.notify_all()
                done += n
        return done

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
        at = pos % self.capacity
        first = min(n, self.capacity - at)
        if first == n:
            return self.buf[at:at + n].copy()
        return np.concatenate((self.buf[at:], self.buf[:n - first]))

    def release(self, reader: int, n: int) -> None:
        with self._cv:
            self._readers[reader] += n
            self._cv.notify_all()

    def wait_readable(self, reader: int, n: int, timeout: float = 30.0) -> int:
        """Wait on the condition variable until ``n`` items are readable:
        1 satisfied, 0 the stream ended first (a shorter tail may remain),
        -1 timed out."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._written - self._readers[reader] >= n or self._eos,
                timeout)
            if not ok:
                return -1
            return 1 if self._written - self._readers[reader] >= n else 0

    def wait_writable(self, n: int, timeout: float = 30.0) -> int:
        """Wait until ``n`` items of room are free (1/0/-1 as
        :meth:`wait_readable`)."""
        with self._cv:
            ok = self._cv.wait_for(lambda: self._free() >= n or self._eos,
                                   timeout)
            if not ok:
                return -1
            return 1 if self._free() >= n else 0

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
                    wrote = self.ring.write(arr[done:], block=True, timeout=1.0)
                    done += wrote
                    if wrote == 0 and self.ring.eos:
                        return
        except Exception as e:  # surface to the scheduler via error attr
            self.error = e
        finally:
            self.ring.set_eos()

    def stop(self) -> None:
        self.ring.set_eos()


def read_exact(ring: HostRing, reader: int, n: int, *, timeout: float = 30.0,
               wait: str = "sleep") -> np.ndarray | None:
    """Wait until ``n`` items are readable or the stream ended, and take up to
    ``n``. Returns None at EOS with nothing left; raises TimeoutError after
    ``timeout`` seconds without them.

    ``wait`` selects the back-off (≈ reference WaitStrategy.hpp): 'spin'
    (busy polling, lowest latency), 'yield' (give up the time slice between
    polls), 'sleep' (50 µs naps, the default) and 'block' (parked on the
    ring's condition variable and woken by the writer, ≈
    BlockingWaitStrategy, WaitStrategy.hpp:54).
    """
    if wait not in _NAPS:
        raise ValueError(f"unknown wait strategy {wait!r}; known: {sorted(_NAPS)}")
    nap = _NAPS[wait]
    if nap is None:
        if ring.wait_readable(reader, n, timeout=timeout) == -1:
            raise TimeoutError(f"ring feed starved (< {n} items for {timeout}s)")
    else:
        deadline = time.monotonic() + timeout
        while ring.readable(reader) < n and not ring.eos:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ring feed starved (< {n} items for {timeout}s)")
            if nap >= 0:
                time.sleep(nap)
    take = min(n, ring.readable(reader))
    if take == 0:
        return None
    out = ring.read(reader, take)
    ring.release(reader, take)
    return out


# seconds slept between polls: -1 never (spin), 0 yield, None the condition
# variable
_NAPS = {"spin": -1, "yield": 0.0, "sleep": 50e-6, "block": None}
