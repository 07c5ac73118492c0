"""chrome://tracing profiler (≈ reference core Profiler.hpp).

Same event taxonomy as the reference (Complete 'X', Instant 'i', Counter 'C',
Begin/End 'B'/'E'; Profiler.hpp:29), recorded in per-thread buffers
(list-append is atomic under the GIL ≈ the reference's per-thread ring
handlers, Profiler.hpp:247), written as a JSON trace that chrome://tracing and
Perfetto load. A :class:`NullProfiler` keeps the disabled path free
(Profiler.hpp:136-153). The scheduler opens ``scheduler.step``,
``scheduler.tags``, ``scheduler.dispatch``, ``scheduler.deliver`` and
``scheduler.compile`` spans, and ``block.host_feed`` / ``block.consume``
around each block's host call; they time the host, not the device. Device
time comes from :meth:`Profiler.device_trace` (``torch.profiler``) or CUDA
events.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any

_t0 = time.perf_counter_ns()
_NO_SPAN = contextlib.nullcontext()
_trace_ids = itertools.count()


def _now_us() -> float:
    return (time.perf_counter_ns() - _t0) / 1e3


class NullProfiler:
    """Zero-overhead stand-in; all methods are no-ops."""

    enabled = False

    def duration(self, name: str, **args: Any):
        return _NO_SPAN

    def instant(self, name: str, **args: Any) -> None: ...
    def counter(self, name: str, **values: float) -> None: ...
    def begin(self, name: str, **args: Any) -> None: ...
    def end(self, name: str) -> None: ...
    def write(self, path: str) -> None: ...

    def events(self) -> list[dict]:
        return []

    @contextmanager
    def device_trace(self, logdir: str):
        yield None

    jax_trace = device_trace


class Profiler(NullProfiler):
    """Collects trace events; thread-safe via per-thread buffers."""

    enabled = True

    def __init__(self, process_name: str = "gnuradio4_tpu_torch"):
        self._local = threading.local()
        self._buffers: list[list[dict]] = []
        self._lock = threading.Lock()
        self.process_name = process_name

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

    def begin(self, name: str, **args: Any) -> None:
        self._emit({"name": name, "ph": "B", "ts": _now_us(), "args": args})

    def end(self, name: str) -> None:
        self._emit({"name": name, "ph": "E", "ts": _now_us()})

    def instant(self, name: str, **args: Any) -> None:
        self._emit({"name": name, "ph": "i", "ts": _now_us(), "s": "t",
                    "args": args})

    def counter(self, name: str, **values: float) -> None:
        self._emit({"name": name, "ph": "C", "ts": _now_us(), "args": values})

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
               "otherData": {"process": self.process_name}}
        with open(path, "w") as f:
            json.dump(doc, f)

    @contextmanager
    def device_trace(self, logdir: str):
        """Trace a region with ``torch.profiler`` (the host's ops, and the
        card's kernels where CUDA is available) and write it into ``logdir``
        as a chrome trace, ``<process_name>.<pid>.<n>.trace.json``. Yields the
        ``torch.profiler.profile`` object. The JAX package's ``jax_trace``
        (the XLA profiler) is an alias of it."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{self.process_name}.{os.getpid()}."
                                    f"{next(_trace_ids)}.trace.json")
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(path)

    jax_trace = device_trace
