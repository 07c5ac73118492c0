"""Multi-graph runtime: several flowgraphs, each under its own Scheduler, with
ring-buffered pipes between them.

≈ the reference's ability to run multiple scheduler instances in one process
(each `gr::scheduler::Simple` owns its graph and thread pool; Scheduler.hpp:89,
thread_pool.hpp:725 named-pool Manager) plus `ScheduledBlockGroup` semantics
(Block.hpp:579-585 — a subgraph with its own scheduler). Here each graph gets a
scheduler thread; cross-graph edges are host rings (PipeSink → StreamSource),
so independently-clocked graphs (e.g. an acquisition graph and a slower DSP
graph) compose without sharing one step cadence.

Nothing crosses between the graphs as a tensor: a pipe hands over NumPy
samples. Per step of a piped stream the samples are copied four times: the
producer's delivery copies them off its device, :meth:`PipeSink.consume`
copies them into the ring, the consumer's feed copies them out, and its step
copies them onto its device.

Typical use::

    rt = Runtime()
    acq, dsp = gt.Graph(), gt.Graph()
    ...build acq ending in a PipeSink, dsp starting with a StreamSource...
    rt.add(acq, block_len=8192, sample_rate=1e6)      # device=None: the card
    rt.add(dsp, block_len=4096, sample_rate=1e6)
    rt.pipe(pipe_sink, stream_src)       # connect across graphs
    rt.run_all(timeout=60)               # start all, wait for all
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .block import Port, SinkBlock
from .errors import GrError
from .registry import register_block
from .scheduler import Scheduler
from .settings import Setting
from .tags import Keys


@register_block("PipeSink")
class PipeSink(SinkBlock):
    """Terminates a graph and forwards its samples to another graph's
    StreamSource (set via :meth:`connect_to` or ``Runtime.pipe``)."""

    IN = (Port("in"),)
    forward_eos = Setting(default=True, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._target = None

    def connect_to(self, stream_source) -> None:
        if not hasattr(stream_source, "push"):
            raise GrError(f"{self.name}: pipe target must be a StreamSource-"
                          f"like block with push()/close()")
        self._target = stream_source

    def consume(self, arrays, tags, n_valid, abs_index):
        if self._target is None:
            raise GrError(f"{self.name}: not connected — call "
                          f"Runtime.pipe(sink, source) before running")
        if n_valid > 0:
            # push copies into the ring: the delivered array (a pinned buffer
            # the scheduler may reuse) never aliases the other graph's data
            self._target.push(np.asarray(arrays["in"][..., :n_valid]))
        if bool(self.settings.get("forward_eos")) and any(
                t.map.get(Keys.END_OF_STREAM) for t in tags.get("in", [])):
            self._target.close()

    def stop(self):
        # graph torn down (possibly without an EOS tag): close the pipe so the
        # downstream graph drains instead of starving against its timeout
        if self._target is not None and bool(self.settings.get("forward_eos")):
            try:
                self._target.close()
            except Exception:
                pass


class Runtime:
    """Owns N (graph, scheduler) pairs and the pipes between them."""

    def __init__(self, name: str = "runtime"):
        self.name = name
        self.schedulers: list[Scheduler] = []
        self._pipes: list[tuple[Any, Any]] = []

    def add(self, graph, **scheduler_kwargs) -> Scheduler:
        """Wrap ``graph`` in its own Scheduler (not started yet). The keyword
        arguments are the Scheduler's: ``device`` None (the default) is the
        card, ``device="cpu"`` the CPU."""
        sched = Scheduler(graph, **scheduler_kwargs)
        self.schedulers.append(sched)
        return sched

    def pipe(self, sink: PipeSink, source) -> None:
        """Connect a PipeSink in one graph to a StreamSource in another."""
        sink.connect_to(source)
        self._pipes.append((sink, source))

    def start_all(self) -> None:
        for s in self.schedulers:
            s.start()

    def wait_all(self, timeout: float | None = None) -> None:
        for s in self.schedulers:
            s.wait_done(timeout)

    def stop_all(self) -> None:
        for s in self.schedulers:
            s.request_stop()

    def run_all(self, timeout: float | None = None) -> None:
        """Start every scheduler and block until all graphs finish."""
        self.start_all()
        try:
            self.wait_all(timeout)
        except BaseException:
            self.stop_all()
            raise
