"""Threaded host feed pipeline: producer threads → native ring → scheduler.

≈ reference IO-bound thread pool + ring buffers between hardware sources and the
graph (thread_pool.hpp TaskType::IO_BOUND, BlockingSync.hpp): a producer thread
(file reader, socket, SDR driver) fills a :class:`~..native.ring.HostRing`; the
scheduler's feed path drains exactly one time-block per step. The ring absorbs
producer jitter so device dispatch never stalls on IO.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator

import numpy as np

from ..native.ring import HostRing
from ..utils import thread_pool


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
               allow_partial_on_eos: bool = True,
               wait: str = "sleep") -> np.ndarray | None:
    """Wait until ``n`` items are readable or the stream ended, and take up to
    ``n`` as a copy (the ring's view is valid only until the release). At
    EOS a short tail is returned, and None when nothing is left;
    ``allow_partial_on_eos`` is accepted and has no effect, as in the JAX
    package. Raises TimeoutError after ``timeout`` seconds without them.

    ``wait`` selects the back-off (≈ reference WaitStrategy.hpp): 'spin'
    (busy polling, lowest latency), 'yield' (give up the time slice between
    polls), 'sleep' (50 µs naps, the default) and 'block' (parked in the
    kernel on the native ring's futex and woken by the writer's publish, ≈
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
    out = np.array(ring.read(reader, take), copy=True)
    ring.release(reader, take)
    return out


# seconds slept between polls: -1 never (spin), 0 yield, None the ring's
# blocking wait
_NAPS = {"spin": -1, "yield": 0.0, "sleep": 50e-6, "block": None}
