"""Host span profiler (≈ reference core Profiler.hpp).

Complete ('X') events in the chrome://tracing format, recorded in per-thread
buffers (list-append is atomic under the GIL ≈ the reference's per-thread ring
handlers, Profiler.hpp:247). A :class:`NullProfiler` keeps the disabled path
free (Profiler.hpp:136-153). The scheduler opens ``scheduler.step``,
``scheduler.tags``, ``scheduler.dispatch``, ``scheduler.deliver`` and
``scheduler.compile`` spans; they time the host, not the device (device time
comes from ``torch.profiler`` or CUDA events).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any

_t0 = time.perf_counter_ns()


def _now_us() -> float:
    return (time.perf_counter_ns() - _t0) / 1e3


class NullProfiler:
    """Zero-overhead stand-in; all methods are no-ops."""

    @contextmanager
    def duration(self, name: str, **args: Any):
        yield

    def events(self) -> list[dict]:
        return []


class Profiler(NullProfiler):
    """Collects trace events; thread-safe via per-thread buffers."""

    def __init__(self):
        self._local = threading.local()
        self._buffers: list[list[dict]] = []
        self._lock = threading.Lock()

    def _buf(self) -> list[dict]:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = []
            self._local.buf = buf
            with self._lock:
                self._buffers.append(buf)
        return buf

    def _emit(self, ev: dict) -> None:
        ev.setdefault("pid", 1)
        ev.setdefault("tid", threading.get_ident() % 100000)
        self._buf().append(ev)

    @contextmanager
    def duration(self, name: str, **args: Any):
        ts = _now_us()
        try:
            yield
        finally:
            self._emit({"name": name, "ph": "X", "ts": ts,
                        "dur": _now_us() - ts, "args": args})

    def events(self) -> list[dict]:
        """Every recorded event, all threads, in time order."""
        with self._lock:
            out = []
            for buf in self._buffers:
                out.extend(buf)
        return sorted(out, key=lambda e: e["ts"])

    def write(self, path: str) -> None:
        """Write the events as a chrome://tracing JSON file."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms",
               "otherData": {"process": "gnuradio4_tpu_torch"}}
        with open(path, "w") as f:
            json.dump(doc, f)
