"""chrome://tracing profiler (≈ reference core Profiler.hpp).

Same event taxonomy as the reference (Complete 'X', Instant 'i', Counter 'C',
Begin/End 'B'/'E'; Profiler.hpp:29), recorded in per-thread buffers
(list-append is atomic under the GIL ≈ the reference's per-thread ring
handlers, Profiler.hpp:247), written as a JSON trace that chrome://tracing and
Perfetto load. A :class:`NullProfiler` keeps the disabled path free
(Profiler.hpp:136-153).

**Clock.** Events are stamped in µs since the Unix epoch, the clock on which
``torch.profiler`` stamps its events: each Profiler pairs one
``time.time_ns()`` reading with one ``time.perf_counter_ns()`` reading when it
is made, so its stamps stay monotonic within a run. A span can therefore be
placed against the host ops, CUDA runtime calls and kernels of a
``torch.profiler`` trace (:func:`trace_origin_us` gives that trace's origin on
this clock), and :func:`overlay` writes a Profiler's events into a
``torch.profiler`` chrome trace, so that both load as one timeline.

**Spans** (``X``; every one carries ``step``, the scheduler's logical step it
belongs to):

- ``scheduler.step``: one pump step (``Scheduler._pump_once``);
- ``scheduler.compile``: a compile of the graph, ``init()``'s included;
- ``scheduler.tags``: the host tag walk;
- ``scheduler.dispatch``: the compiled graph's eager step (``CompiledGraph
  .step``), inside it ``block.apply`` (args ``block``) around each block's
  ``apply`` (``apply_sp``/``lower_sp`` under time sharding) and around each
  feedback loop group, once a step;
- ``scheduler.retire``: inside ``scheduler.step``, the delivery of the steps
  that left the pipeline (``pipeline_depth`` steps back);
- ``scheduler.deliver``: one step's delivery to the sinks, inside it
  ``scheduler.to_host`` (the sink tensors' copy to the host) and
  ``block.consume`` (args ``block``); a batched record's copy is one
  ``scheduler.to_host`` for the whole batch, before its steps' deliveries;
- ``block.host_feed`` (args ``block``): a host-fed source's feed.

The scheduler opens no counters. The kernel library's build is not a span:
``ops.cuda_kernels.build()`` keeps its seconds and whether ``nvcc`` ran
(``KernelLibrary.seconds``, ``.built``) for a reader to take after warm-up.

**Device ranges.** With ``device_ranges`` on (:meth:`Profiler.device_trace`
turns it on for its region), each span also opens a
``torch.profiler.record_function`` range named ``RANGE_PREFIX + name`` (with
``[block]`` where the span names one). The profiler mirrors each range on the
device, so the kernels a block launches (those of the hand-written library's
own CUDA runtime included) fall inside its range there.
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

RANGE_PREFIX = "gr4t."
_NO_SPAN = contextlib.nullcontext()
_trace_ids = itertools.count()


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


def trace_origin_us(prof) -> float:
    """The origin, on the Profiler's clock (Unix-epoch µs), of the
    ``time_range`` of a finished ``torch.profiler.profile``'s events."""
    return prof.profiler.kineto_results.trace_start_ns() / 1e3


class Profiler(NullProfiler):
    """Collects trace events; thread-safe via per-thread buffers."""

    enabled = True

    def __init__(self, process_name: str = "gnuradio4_tpu_torch", *,
                 device_ranges: bool = False):
        self._local = threading.local()
        self._buffers: list[list[dict]] = []
        self._lock = threading.Lock()
        self.process_name = process_name
        self.device_ranges = device_ranges
        self._epoch_ns = time.time_ns()
        self._pc_ns = time.perf_counter_ns()

    def now_us(self) -> float:
        """The Profiler's clock: Unix-epoch µs."""
        return (self._epoch_ns + time.perf_counter_ns() - self._pc_ns) / 1e3

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
        t0 = time.perf_counter_ns()
        rng = None
        if self.device_ranges:                # opened inside the span
            from torch.profiler import record_function
            block = args.get("block")
            rng = record_function(RANGE_PREFIX + name
                                  + (f"[{block}]" if block is not None else ""))
            rng.__enter__()
        try:
            yield
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
            t1 = time.perf_counter_ns()
            self._emit({"name": name, "ph": "X",
                        "ts": (self._epoch_ns + t0 - self._pc_ns) / 1e3,
                        "dur": (t1 - t0) / 1e3, "args": args})

    def begin(self, name: str, **args: Any) -> None:
        self._emit({"name": name, "ph": "B", "ts": self.now_us(), "args": args})

    def end(self, name: str) -> None:
        self._emit({"name": name, "ph": "E", "ts": self.now_us()})

    def instant(self, name: str, **args: Any) -> None:
        self._emit({"name": name, "ph": "i", "ts": self.now_us(), "s": "t",
                    "args": args})

    def counter(self, name: str, **values: float) -> None:
        self._emit({"name": name, "ph": "C", "ts": self.now_us(),
                    "args": values})

    def events(self) -> list[dict]:
        """Every recorded event, all threads, in time order."""
        with self._lock:
            out = []
            for buf in self._buffers:
                out.extend(buf)
        return sorted(out, key=lambda e: e["ts"])

    def write(self, path: str) -> None:
        """Write the events as a chrome://tracing JSON file (Unix-epoch µs;
        :func:`overlay` puts them into a ``torch.profiler`` trace)."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms",
               "otherData": {"process": self.process_name}}
        with open(path, "w") as f:
            json.dump(doc, f)

    @contextmanager
    def device_trace(self, logdir: str):
        """Trace a region with ``torch.profiler`` (the host's ops, and the
        card's kernels where CUDA is available) and write it into ``logdir``
        as a chrome trace, ``<process_name>.<pid>.<n>.trace.json``, with this
        Profiler's events of the region overlaid (:func:`overlay`) and its
        spans mirrored as device ranges. Yields the
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
        ranges, self.device_ranges = self.device_ranges, True
        t0 = self.now_us()
        try:
            with profile(activities=acts) as prof:
                yield prof
        finally:
            self.device_ranges = ranges
        prof.export_chrome_trace(path)
        t1 = self.now_us()
        overlay(path, [e for e in self.events() if t0 <= e["ts"] <= t1],
                process_name=self.process_name)

    jax_trace = device_trace


def overlay(trace_path: str, events, out_path: str | None = None, *,
            process_name: str = "gnuradio4_tpu_torch") -> None:
    """Add a Profiler's events (a list, or the path of a file
    :meth:`Profiler.write` wrote) to the ``torch.profiler`` chrome trace at
    ``trace_path``, shifted onto that file's time base and shown as a
    process of their own named ``process_name``; written to ``out_path``
    (default: in place)."""
    if isinstance(events, (str, os.PathLike)):
        with open(events) as f:
            events = json.load(f)["traceEvents"]
    with open(trace_path) as f:
        doc = json.load(f)
    base_us = int(doc.get("baseTimeNanoseconds", 0)) / 1e3
    pid = f"{process_name} spans"
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": pid}}]
    for e in events:
        out.append({**e, "pid": pid, "ts": e["ts"] - base_us})
    doc["traceEvents"] = doc.get("traceEvents", []) + out
    with open(out_path or trace_path, "w") as f:
        json.dump(doc, f)
