"""Nested-scheduler subgraphs (≈ reference ScheduledBlockGroup / managed
subgraphs, Block.hpp:579-585, qa_ManagedSubGraph).

Two composition modes exist in this framework:

1. **Transparent** (default): nested :class:`~.graph.Graph` blocks are flattened
   into the parent's compiled step (≈ TransparentBlockGroup) — zero cost,
   used by WbfmReceiver etc.
2. **Scheduled** (:class:`ScheduledSubgraph`): the inner graph runs under its OWN
   Scheduler on a separate thread, bridged to the outer graph through host
   ring buffers — for isolating rate domains, host-heavy subgraphs, or different
   block lengths. The inner scheduler runs on the outer graph's device. Data
   crosses host↔device at the boundary with **counted latency**: while the
   inner pipeline warms up, the bridge source reports ``n_valid = 0`` (no
   fabricated samples enter the stream — downstream consumers skip those
   steps), so the consumer's first valid sample IS the producer's first
   sample, a pipeline-fill delay later.

Each bridge ring holds two steps of the larger side (at least 2^20 items;
the JAX package's rings are 2^20 items whatever the step, so there a step
longer than that never completes).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .block import Block, Port, SinkBlock, SourceBlock
from .errors import GrError
from ..native.ring import HostRing
from .feeder import read_exact
from .graph import Graph
from .registry import register_block
from .settings import Setting
from .stream import canonical_dtype


class _BridgeSource(SourceBlock):
    """Inner-graph source draining an outer-side ring."""

    FEED = True

    def __init__(self, ring: HostRing, channels: int, name=None):
        super().__init__(name=name)
        self.out_ports = (Port("out"),)
        self.ring = ring
        self.reader = ring.add_reader()
        self._channels = channels

    def out_channels(self, port, in_channels):
        return self._channels

    def out_dtype(self, port, in_dtypes):
        return self.ring.dtype

    def host_feed(self, n, abs_index):
        ch = max(1, self._channels)
        got = read_exact(self.ring, self.reader, n * ch, timeout=60.0)
        if got is None:
            return None
        nv = len(got) // ch
        if self._channels:
            got = got.reshape(ch, -1, order="F")[:, :nv]
        return {"out": got}, nv

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


class _BridgeSink(SinkBlock):
    """Inner-graph sink filling an outer-side ring."""

    def __init__(self, ring: HostRing, name=None):
        super().__init__(name=name)
        self.in_ports = (Port("in"),)
        self.ring = ring

    def consume(self, arrays, tags, n_valid, abs_index):
        x = arrays["in"][..., :n_valid]
        if x.ndim > 1:
            x = np.asarray(x).reshape(-1, order="F")
        self.ring.write(np.asarray(x).ravel(), block=True, timeout=60.0)

    def stop(self):
        self.ring.set_eos()


@register_block("ScheduledSubgraph")
class ScheduledSubgraph(Block):
    """Runs an inner flowgraph under its own scheduler thread (see module doc).

    The inner graph must have exported in/out ports. ``out_dtypes``/
    ``out_channels_map`` declare boundary types (the outer compiler needs them
    before the inner graph is compiled).
    """

    HOST_TAP = True        # outer runtime delivers this block's inputs to the host
    FEED = True            # and feeds its outputs from the host
    ALLOW_UNDERRUN = True  # partial/empty feeds = warm-up, not EOS

    block_len_inner = Setting(default=0, kind="static",
                              description="0 → inherit outer per-step length")
    starve_timeout = Setting(default=60.0, kind="static", unit="s",
                             description="error if the inner graph produces "
                                         "nothing for this long")

    def __init__(self, inner: Graph, name=None,
                 out_dtypes: dict[str, Any] | None = None,
                 out_channels_map: dict[str, int] | None = None,
                 scheduler_kwargs: dict | None = None, **settings):
        super().__init__(name=name, **settings)
        if not inner._exports_in and not inner._exports_out:
            raise GrError("ScheduledSubgraph needs exported ports on the inner "
                          "graph (export_in/export_out)")
        self.inner = inner
        self.in_ports = tuple(Port(p) for p in inner._exports_in)
        self.out_ports = tuple(Port(p) for p in inner._exports_out)
        self._out_dtypes = {k: canonical_dtype(v)
                            for k, v in (out_dtypes or {}).items()}
        self._out_channels = dict(out_channels_map or {})
        self._sched_kwargs = dict(scheduler_kwargs or {})
        self._in_rings: dict[str, HostRing] = {}
        self._out_rings: dict[str, HostRing] = {}
        self._out_readers: dict[str, int] = {}
        self._inner_sched = None
        self._starved_since: float | None = None
        self._ctx = None

    def out_dtype(self, port, in_dtypes):
        if port in self._out_dtypes:
            return self._out_dtypes[port]
        if in_dtypes:
            return next(iter(in_dtypes.values()))
        return np.dtype(np.float32)

    def out_channels(self, port, in_channels):
        if port in self._out_channels:
            return self._out_channels[port]
        return super().out_channels(port, in_channels)

    def init_state(self, ctx):
        self._ctx = ctx
        return None

    def start(self):
        if self._inner_sched is not None:
            return
        ctx = self._ctx
        from .scheduler import Scheduler
        wrap = Graph(name=f"{self.name}.wrap")
        wrap.add(self.inner)
        lens_in = ctx.in_len if ctx else {}
        lens_out = ctx.out_len if ctx else {}
        n_in = next(iter(lens_in.values()), 0) or next(iter(lens_out.values()), 4096)
        bl = int(self.settings.get("block_len_inner")) or n_in

        def capacity(n_outer: int, ch: int) -> int:
            # two steps of either side, at least 2^20 items: a step longer
            # than its ring could never be read whole
            n_inner = -(-bl * n_outer // n_in)
            return max(1 << 20, 2 * max(n_outer, n_inner) * max(1, ch))

        for pub in self.inner._exports_in:
            dt = np.dtype(ctx.dtype(pub)) if ctx else np.float32
            ch = ctx.channels.get(pub, 0) if ctx else 0
            ring = HostRing(capacity(lens_in.get(pub, n_in), ch), dtype=dt)
            self._in_rings[pub] = ring
            src = _BridgeSource(ring, ch, name=f"{self.name}.{pub}.bridge_in")
            wrap.connect(src, self.inner[pub])
        for pub in self.inner._exports_out:
            dt = np.dtype(self.out_dtype(pub, {p: ctx.dtype(p) for p in
                                               ctx.in_len} if ctx else {}))
            ring = HostRing(capacity(lens_out.get(pub, n_in),
                                     self._out_channels.get(pub, 0)), dtype=dt)
            self._out_rings[pub] = ring
            self._out_readers[pub] = ring.add_reader()
            snk = _BridgeSink(ring, name=f"{self.name}.{pub}.bridge_out")
            wrap.connect(self.inner[pub], snk)
        kw = dict(self._sched_kwargs)
        kw.setdefault("block_len", bl)
        kw.setdefault("sample_rate", ctx.sample_rate if ctx else 1.0)
        kw.setdefault("pipeline_depth", 1)  # minimize bridge latency
        if ctx is not None:
            # the outer graph's device: a CPU caller never gets an inner
            # graph on the card
            kw.setdefault("device", ctx.device)
        self._inner_sched = Scheduler(wrap, name=f"{self.name}.sched", **kw)
        self._inner_sched.start()
        self._starved_since = None

    def stop(self):
        for ring in self._in_rings.values():
            ring.set_eos()
        if self._inner_sched is not None:
            try:
                self._inner_sched.wait_done(timeout=30)
            except TimeoutError:
                self._inner_sched.request_stop()

    # outer sink side: deliver inputs into the inner rings
    def consume(self, arrays, tags, n_valid, abs_index):
        if self._inner_sched is None:
            self.start()
        for pub, ring in self._in_rings.items():
            x = arrays.get(pub)
            if x is None or n_valid == 0:
                continue
            x = np.asarray(x)[..., :n_valid]
            if x.ndim > 1:
                x = x.reshape(-1, order="F")
            ring.write(x.ravel(), block=True, timeout=60.0)
        # forward upstream EOS into the inner graph so it winds down and the
        # bridge's host_feed can report end-of-stream after the drain
        from .tags import Keys
        for port_tags in tags.values():
            if any(t.map.get(Keys.END_OF_STREAM) for t in port_tags):
                for ring in self._in_rings.values():
                    ring.set_eos()
                break

    # outer feed side: produce outputs from the inner rings. Counted latency:
    # whatever the inner graph has produced is served, the rest of the step is
    # reported invalid (n_valid < n) — NO fabricated samples enter the stream,
    # and an empty feed during pipeline fill is not EOS (ALLOW_UNDERRUN).
    def host_feed(self, n, abs_index):
        import time
        if self._inner_sched is None:
            self.start()
        out: dict[str, np.ndarray] = {}
        # one common take (in frames) across ports keeps outputs aligned;
        # multi-channel ports carry ch items per frame (column-major, matching
        # _BridgeSink's layout)
        avail_f: dict[str, int] = {}
        for pub, ring in self._out_rings.items():
            k = max(1, self._out_channels.get(pub, 0))
            avail_f[pub] = ring.readable(self._out_readers[pub]) // k
        eos_all = bool(self._out_rings) and \
            all(ring.eos for ring in self._out_rings.values())
        if eos_all and max(avail_f.values(), default=0) == 0:
            return None   # inner graph finished and fully drained
        if eos_all:
            # wind-down: the inner graph is done but ports may hold unequal
            # tails (rate-changing inner paths). Serve the longest tail;
            # already-drained ports zero-pad inside the valid window rather
            # than starving the bridge and losing the other ports' data.
            nv = min(n, max(avail_f.values()))
        else:
            nv = min([n, *avail_f.values()])
        for pub, ring in self._out_rings.items():
            reader = self._out_readers[pub]
            ch = self._out_channels.get(pub, 0)
            k = max(1, ch)
            buf = np.zeros((ch, n) if ch else n, ring.dtype)
            take = min(nv, avail_f[pub])
            if take:
                # copied out of the ring's view before the release lets the
                # inner graph overwrite it
                got = ring.read(reader, take * k)
                if ch:
                    buf[:, :take] = got.reshape(ch, take, order="F")
                else:
                    buf[:take] = got
                ring.release(reader, take * k)
            out[pub] = buf
        from .lifecycle import State
        if self._inner_sched.state is State.ERROR:
            raise GrError(f"{self.name}: inner scheduler failed: "
                          f"{self._inner_sched.error}")
        if nv == 0:
            now = time.monotonic()
            if self._starved_since is None:
                self._starved_since = now
            elif now - self._starved_since > float(
                    self.settings.get("starve_timeout")):
                raise GrError(f"{self.name}: inner graph produced nothing for "
                              f"{self.settings.get('starve_timeout')}s")
            time.sleep(0.0005)   # don't hot-spin the outer pump during fill
        else:
            self._starved_since = None
        return out, nv

    def apply(self, state, ins, ctx):
        # pass the host-fed arrays through as this block's outputs
        return state, {p.name: ins[p.name] for p in self.out_ports}
