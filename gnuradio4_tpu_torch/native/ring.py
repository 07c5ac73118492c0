"""ctypes wrapper for the native double-mapped ring (+ pure-Python fallback).

The native ring (``ringbuf.cpp``) provides wrap-free contiguous spans: producer
and consumers exchange NumPy views with zero copies, across threads, without
locks. It is the host data plane of the port: the threaded feeds of the file,
network and SDR sources (``core/feeder.py``), ``StreamSource`` and the pipes
between graphs (``core/runtime.py``), the subgraph bridges and the audio
loopback. ≈ reference CircularBuffer (SURVEY §2.1).

Views returned by :meth:`HostRing.read` and :meth:`HostRing.reserve` point into
the ring: they are valid only until the matching :meth:`~HostRing.release` or
:meth:`~HostRing.publish`. A caller that keeps the data copies it first.

The library is built with ``g++`` at first use into ``_build/`` (``build.py``).
The Python fallback (``force_python=True``, or no compiler) keeps the same
calls on a power-of-two NumPy buffer under a lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time

import numpy as np

from .build import build_library

_SOURCES = ("ringbuf.cpp",)
_FLAGS = (("-O3",),)
_lib = None
_lib_blocking = None   # CDLL view of the same library (releases the GIL per call)
_load_lock = threading.Lock()


def build_native(force: bool = False) -> bool:
    """Compile ringbuf.cpp into ``_build/`` (once per source hash). Returns
    success."""
    return build_library("gr4ring", _SOURCES, _FLAGS, force=force) is not None


def _load():
    global _lib, _lib_blocking
    with _load_lock:
        if _lib is not None:
            return _lib
        so = build_library("gr4ring", _SOURCES, _FLAGS)
        if so is None:
            return None
        try:
            # PyDLL: the ring ops are nanosecond-scale and never block, so
            # holding the GIL is cheaper than CDLL's release/reacquire per call
            lib = ctypes.PyDLL(str(so))
            libb = ctypes.CDLL(str(so))
        except OSError:
            return None
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        psz = ctypes.POINTER(ctypes.c_size_t)
        for name, res, args in (
                ("gr4_ring_create", vp, [sz]),
                ("gr4_ring_destroy", None, [vp]),
                ("gr4_ring_capacity", sz, [vp]),
                ("gr4_ring_data", vp, [vp]),
                ("gr4_ring_add_reader", ctypes.c_int, [vp]),
                ("gr4_ring_reserve", vp, [vp, sz, psz]),
                ("gr4_ring_publish", None, [vp, sz]),
                ("gr4_ring_read", vp, [vp, ctypes.c_int, sz, psz]),
                ("gr4_ring_release", None, [vp, ctypes.c_int, sz]),
                ("gr4_ring_readable", sz, [vp, ctypes.c_int]),
                ("gr4_ring_writable", sz, [vp]),
                ("gr4_ring_set_eos", None, [vp]),
                ("gr4_ring_eos", ctypes.c_int, [vp]),
                ("gr4_ring_reserve_mp", vp,
                 [vp, sz, psz, ctypes.POINTER(ctypes.c_uint64)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        # publish_mp spin-waits for predecessor producers and the waits park
        # in a futex: they MUST release the GIL (through PyDLL the waiting
        # thread would hold the GIL the producer it waits for needs: a
        # deadlock), so they go through the CDLL view of the same library
        libb.gr4_ring_publish_mp.restype = None
        libb.gr4_ring_publish_mp.argtypes = [vp, ctypes.c_uint64, sz]
        libb.gr4_ring_wait_readable.restype = ctypes.c_int
        libb.gr4_ring_wait_readable.argtypes = [vp, ctypes.c_int, sz, ctypes.c_long]
        libb.gr4_ring_wait_writable.restype = ctypes.c_int
        libb.gr4_ring_wait_writable.argtypes = [vp, sz, ctypes.c_long]
        _lib_blocking = libb
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


class HostRing:
    """Typed SPMC ring. All span methods return NumPy views (zero-copy on the
    native path) valid until the matching publish/release.

    The native ring's capacity rounds up to a power of two of whole pages,
    the fallback's to a power of two of items; ``capacity`` says what was
    allocated. At most 8 readers (the native ring's slots). A write stops
    once the stream has ended (:meth:`set_eos`)."""

    def __init__(self, capacity_items: int, dtype=np.float32, *,
                 force_python: bool = False, producers: str = "single"):
        """``producers="multi"`` enables the CAS-claim multi-producer path
        (≈ MultiProducerStrategy, ClaimStrategy.hpp:116): concurrent
        :meth:`write` calls from many threads claim disjoint ranges and
        publish in ticket order. Zero-copy reserve/publish stays
        single-producer-only."""
        if producers not in ("single", "multi"):
            raise ValueError("producers must be 'single' or 'multi'")
        self.producers = producers
        self._mp_lock = threading.Lock()  # python-fallback MP serialization
        self.dtype = np.dtype(dtype)
        self.itemsize = self.dtype.itemsize
        lib = None if force_python else _load()
        self._lib = lib
        self._eos = False
        if lib is not None:
            self._h = lib.gr4_ring_create(int(capacity_items) * self.itemsize)
            if not self._h:
                raise MemoryError("gr4_ring_create failed")
            cap_bytes = lib.gr4_ring_capacity(self._h)
            self.capacity = cap_bytes // self.itemsize
            # one persistent typed view over the whole double-mapped region:
            # reserve/read pointers become cheap slices (offset = ptr - base)
            self._base = lib.gr4_ring_data(self._h)
            raw = (ctypes.c_char * (2 * cap_bytes)).from_address(self._base)
            self._view = np.frombuffer(raw, dtype=self.dtype)
        else:
            self._h = None
            self.capacity = 1
            while self.capacity < capacity_items:
                self.capacity <<= 1
            self._buf = np.zeros(self.capacity, self.dtype)
            self._head = 0
            self._tails: list[int] = []
            self._lock = threading.Lock()
            self._wrap_tmp = None

    # -- producer --------------------------------------------------------------
    def reserve(self, n: int) -> np.ndarray:
        """Writable contiguous view of ≤ n items (may be shorter; len 0 = full)."""
        if self.producers == "multi":
            raise RuntimeError(
                "zero-copy reserve/publish is single-producer-only; on a "
                "producers='multi' ring use write() (CAS range claim)")
        return self._reserve_unchecked(n)

    def _reserve_unchecked(self, n: int) -> np.ndarray:
        if self._h is not None:
            avail = ctypes.c_size_t()
            ptr = self._lib.gr4_ring_reserve(self._h, n * self.itemsize,
                                             ctypes.byref(avail))
            cnt = avail.value // self.itemsize
            if not ptr or cnt == 0:
                return np.empty(0, self.dtype)
            off = (ptr - self._base) // self.itemsize
            return self._view[off:off + cnt]
        with self._lock:
            tail = min(self._tails, default=self._head)
            cnt = min(n, self.capacity - (self._head - tail))
            if cnt == 0:
                return np.empty(0, self.dtype)
            start = self._head & (self.capacity - 1)
            if start + cnt <= self.capacity:
                return self._buf[start:start + cnt]
            self._wrap_tmp = np.zeros(cnt, self.dtype)
            return self._wrap_tmp

    def publish(self, n: int) -> None:
        if self._h is not None:
            self._lib.gr4_ring_publish(self._h, n * self.itemsize)
            return
        with self._lock:
            start = self._head & (self.capacity - 1)
            if self._wrap_tmp is not None and start + n > self.capacity:
                first = self.capacity - start
                self._buf[start:] = self._wrap_tmp[:first]
                self._buf[: n - first] = self._wrap_tmp[first:n]
            self._wrap_tmp = None
            self._head += n

    def write(self, data: np.ndarray, *, block: bool = True,
              timeout: float = 10.0) -> int:
        """Copy ``data`` in. With ``block``, wait for room until all of it is
        written or ``timeout`` seconds have passed; without, write what fits
        now. Returns the number of items written (short only without
        ``block``, on timeout, or once the stream has ended).

        Thread-safe across concurrent writers when the ring was created with
        ``producers="multi"`` (CAS range claim + ticket-ordered publish)."""
        data = np.ascontiguousarray(data, dtype=self.dtype).ravel()
        done = 0
        deadline = time.monotonic() + timeout
        multi = self.producers == "multi"
        while done < len(data):
            if self.eos:
                return done
            if multi and self._h is not None:
                avail = ctypes.c_size_t()
                ticket = ctypes.c_uint64()
                ptr = self._lib.gr4_ring_reserve_mp(
                    self._h, (len(data) - done) * self.itemsize,
                    ctypes.byref(avail), ctypes.byref(ticket))
                cnt = avail.value // self.itemsize
                if ptr and cnt:
                    off = (ptr - self._base) // self.itemsize
                    self._view[off:off + cnt] = data[done:done + cnt]
                    _lib_blocking.gr4_ring_publish_mp(self._h, ticket.value,
                                                      cnt * self.itemsize)
                    done += cnt
                    continue
            else:
                with self._mp_lock if multi else contextlib.nullcontext():
                    span = self._reserve_unchecked(len(data) - done)
                    if len(span):
                        span[:] = data[done:done + len(span)]
                        self.publish(len(span))
                        done += len(span)
                        continue
            left = deadline - time.monotonic()
            if not block or left <= 0:
                return done
            self.wait_writable(1, timeout=max(1e-3, left))
        return done

    # -- consumers -------------------------------------------------------------
    def add_reader(self) -> int:
        if self._h is not None:
            rid = self._lib.gr4_ring_add_reader(self._h)
            if rid < 0:
                raise RuntimeError("too many readers (max 8)")
            return rid
        with self._lock:
            if len(self._tails) >= 8:
                raise RuntimeError("too many readers (max 8)")
            self._tails.append(self._head)
            return len(self._tails) - 1

    def read(self, reader: int, max_n: int = 0) -> np.ndarray:
        """Readable contiguous view (≤ max_n items; 0 = all available), valid
        until :meth:`release`."""
        if self._h is not None:
            avail = ctypes.c_size_t()
            ptr = self._lib.gr4_ring_read(self._h, reader, max_n * self.itemsize,
                                          ctypes.byref(avail))
            cnt = avail.value // self.itemsize
            if not ptr or cnt == 0:
                return np.empty(0, self.dtype)
            off = (ptr - self._base) // self.itemsize
            return self._view[off:off + cnt]
        with self._lock:
            tail = self._tails[reader]
            n = self._head - tail
            if max_n:
                n = min(n, max_n)
            if n == 0:
                return np.empty(0, self.dtype)
            start = tail & (self.capacity - 1)
            if start + n <= self.capacity:
                return self._buf[start:start + n]
            return np.concatenate([self._buf[start:],
                                   self._buf[: n - (self.capacity - start)]])

    def release(self, reader: int, n: int) -> None:
        if self._h is not None:
            self._lib.gr4_ring_release(self._h, reader, n * self.itemsize)
            return
        with self._lock:
            self._tails[reader] += n

    def readable(self, reader: int) -> int:
        if self._h is not None:
            return self._lib.gr4_ring_readable(self._h, reader) // self.itemsize
        with self._lock:
            return self._head - self._tails[reader]

    def writable(self) -> int:
        if self._h is not None:
            return self._lib.gr4_ring_writable(self._h) // self.itemsize
        with self._lock:
            return self.capacity - (self._head - min(self._tails,
                                                     default=self._head))

    # -- blocking waits (≈ BlockingWaitStrategy, WaitStrategy.hpp:54) ----------
    def wait_readable(self, reader: int, n: int, timeout: float = 30.0) -> int:
        """Park in the kernel (futex) until ≥ n items are readable.

        Returns 1 = satisfied, 0 = EOS first (partial data may remain),
        -1 = timed out. The Python ring sleep-polls instead.
        """
        if self._h is not None:
            return _lib_blocking.gr4_ring_wait_readable(
                self._h, reader, n * self.itemsize, int(timeout * 1e6))
        deadline = time.monotonic() + timeout
        while self.readable(reader) < n:
            if self.eos:
                return 0
            if time.monotonic() > deadline:
                return -1
            time.sleep(1e-3)
        return 1

    def wait_writable(self, n: int, timeout: float = 30.0) -> int:
        """Park until ≥ n items of free space (1/0/-1 as wait_readable)."""
        if self._h is not None:
            return _lib_blocking.gr4_ring_wait_writable(
                self._h, n * self.itemsize, int(timeout * 1e6))
        deadline = time.monotonic() + timeout
        while self.writable() < n:
            if self.eos:
                return 0
            if time.monotonic() > deadline:
                return -1
            time.sleep(1e-3)
        return 1

    # -- EOS -------------------------------------------------------------------
    def set_eos(self) -> None:
        self._eos = True
        if self._h is not None:
            self._lib.gr4_ring_set_eos(self._h)

    @property
    def eos(self) -> bool:
        if self._h is not None:
            return bool(self._lib.gr4_ring_eos(self._h))
        return self._eos

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and self._lib is not None:
            self._lib.gr4_ring_destroy(h)
            self._h = None

    @property
    def is_native(self) -> bool:
        return self._h is not None

