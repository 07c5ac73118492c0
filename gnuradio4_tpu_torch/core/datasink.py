"""DataSink: out-of-graph data egress with pollers (≈ reference
blocks/basic DataSink.hpp: DataSink block :468, DataSinkRegistry + query API :163,
StreamingPoller w/ Backpressure|Drop :21-37,78-100; consumer path SURVEY §3.6).

A DataSink block registers itself (by signal name) in the global
:class:`DataSinkRegistry`; consumer threads attach pollers:

- :class:`StreamingPoller` — continuous chunks (+tags), bounded queue with
  ``Backpressure`` (block the scheduler's deliver) or ``Drop`` policy;
- :class:`TriggerPoller` — pre/post-sample windows around matching trigger tags;
- :class:`MultiplexedPoller` — DataSets spanning start→stop trigger pairs;
- :class:`SnapshotPoller` — single samples at trigger+delay.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import queue
import threading
from typing import Any, Iterable

import numpy as np

from .block import Port, SinkBlock
from .dataset import DataSet
from .registry import register_block
from .settings import Setting
from .tags import Keys, Tag
from .trigger import Matcher, MatchResult, match_trigger


class OverflowPolicy(enum.Enum):
    BACKPRESSURE = "Backpressure"
    DROP = "Drop"


@dataclasses.dataclass
class StreamChunk:
    data: np.ndarray
    tags: list[Tag]
    abs_index: int


@dataclasses.dataclass(frozen=True)
class DataSinkQuery:
    """Sink lookup by block name or signal name (≈ DataSink.hpp DataSinkQuery)."""

    sink_name: str | None = None
    signal_name: str | None = None

    @classmethod
    def sink(cls, name: str) -> "DataSinkQuery":
        return cls(sink_name=name)

    @classmethod
    def signal(cls, name: str) -> "DataSinkQuery":
        return cls(signal_name=name)

    def matches(self, sink) -> bool:
        if self.sink_name is not None and sink.name != self.sink_name:
            return False
        if self.signal_name is not None \
                and sink.get_signal_name() != self.signal_name:
            return False
        return True


class _PollerBase:
    def __init__(self):
        self.finished = False
        # signal metadata stamped by the owning sink at attach/update time
        # (≈ DataSink filling DataSet signal info from its own settings)
        self.sink_meta: dict[str, Any] = {}

    def _feed(self, chunk: StreamChunk) -> None:  # called by the sink
        raise NotImplementedError

    def _eos(self) -> None:
        self.finished = True

    def _meta(self, key: str, default):
        return self.sink_meta.get(key, default)


class StreamingPoller(_PollerBase):
    def __init__(self, *, max_chunks: int = 64,
                 policy: OverflowPolicy = OverflowPolicy.BACKPRESSURE):
        super().__init__()
        self.policy = policy
        self.q: "queue.Queue[StreamChunk]" = queue.Queue(maxsize=max_chunks)
        self.dropped = 0           # dropped samples (Drop policy only)
        self.dropped_tag_count = 0

    # reference spelling (DataSink.hpp StreamingPoller::droppedSampleCount)
    @property
    def dropped_sample_count(self) -> int:
        return self.dropped

    def _feed(self, chunk: StreamChunk) -> None:
        if self.policy is OverflowPolicy.BACKPRESSURE:
            self.q.put(chunk)
        else:
            try:
                self.q.put_nowait(chunk)
            except queue.Full:
                self.dropped += chunk.data.shape[-1]
                self.dropped_tag_count += len(chunk.tags)

    def read(self, timeout: float | None = 1.0) -> StreamChunk | None:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def read_all(self) -> list[StreamChunk]:
        out = []
        while True:
            try:
                out.append(self.q.get_nowait())
            except queue.Empty:
                return out


def _stamp_meta(ds: DataSet, poller: _PollerBase) -> DataSet:
    """Fill DataSet signal info from the owning sink's metadata
    (≈ DataSink.hpp initializing dataset signal_names/units/ranges)."""
    m = poller.sink_meta
    if not m:
        return ds
    s = ds.signals[0]
    s.name = str(m.get(Keys.SIGNAL_NAME, s.name))
    s.unit = str(m.get(Keys.SIGNAL_UNIT, s.unit or "a.u."))
    s.quantity = str(m.get(Keys.SIGNAL_QUANTITY, s.quantity))
    if Keys.SIGNAL_MIN in m:
        s.range_min = float(m[Keys.SIGNAL_MIN])
    if Keys.SIGNAL_MAX in m:
        s.range_max = float(m[Keys.SIGNAL_MAX])
    return ds


class TriggerPoller(_PollerBase):
    """Emits [pre+post] windows around each matched trigger tag."""

    def __init__(self, matcher: Matcher | str, *, pre: int, post: int,
                 max_windows: int = 64, sample_rate: float = 1.0,
                 callback=None):
        super().__init__()
        self.matcher = match_trigger(matcher) if isinstance(matcher, str) else matcher
        self.pre, self.post = pre, post
        self.sample_rate = sample_rate
        self.callback = callback
        self.q: "queue.Queue[DataSet]" = queue.Queue(maxsize=max_windows)
        self._hist: collections.deque = collections.deque(maxlen=1)
        self._tail = None  # np array of last `pre` samples
        self._pending: list[tuple[int, Tag, list[np.ndarray], int]] = []

    def _feed(self, chunk: StreamChunk) -> None:
        data = chunk.data
        # complete pending windows
        still = []
        for (start_abs, tag, parts, have) in self._pending:
            need = self.pre + self.post - have
            take = data[..., :need]
            parts.append(take)
            have += take.shape[-1]
            if have >= self.pre + self.post:
                self._emit(start_abs, tag, parts)
            else:
                still.append((start_abs, tag, parts, have))
        self._pending = still
        # new triggers in this chunk
        for t in chunk.tags:
            if self.matcher(t) is not MatchResult.MATCHED:
                continue
            trig_abs = chunk.abs_index + t.index
            start_rel = t.index - self.pre
            parts: list[np.ndarray] = []
            if start_rel < 0:
                if self._tail is not None and self._tail.shape[-1] >= -start_rel:
                    parts.append(self._tail[..., start_rel:])
                else:  # not enough history: pad with zeros
                    pad = np.zeros(data.shape[:-1] + (-start_rel,), data.dtype)
                    if self._tail is not None:
                        pad[..., -self._tail.shape[-1]:] = self._tail[..., :]
                    parts.append(pad)
                start_rel = 0
            take = data[..., start_rel: t.index + self.post]
            parts.append(take)
            have = sum(p.shape[-1] for p in parts)
            if have >= self.pre + self.post:
                self._emit(trig_abs - self.pre, t, parts)
            else:
                self._pending.append((trig_abs - self.pre, t, parts, have))
        # update history tail
        if self.pre > 0:
            if self._tail is None or data.shape[-1] >= self.pre:
                self._tail = data[..., -self.pre:].copy()
            else:
                joined = np.concatenate([self._tail, data], axis=-1)
                self._tail = joined[..., -self.pre:]

    def _emit(self, start_abs: int, tag: Tag, parts: list[np.ndarray]) -> None:
        win = np.concatenate(parts, axis=-1)[..., : self.pre + self.post]
        ds = DataSet.from_stream(win,
                                 sample_rate=float(self._meta(
                                     Keys.SAMPLE_RATE, self.sample_rate)),
                                 start_index=start_abs,
                                 tags=[Tag(self.pre, dict(tag.map))])
        ds.meta["trigger"] = dict(tag.map)
        _stamp_meta(ds, self)
        if self.callback is not None:
            self.callback(ds)
            return
        try:
            self.q.put_nowait(ds)
        except queue.Full:
            pass

    def read(self, timeout: float | None = 1.0) -> DataSet | None:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class MultiplexedPoller(_PollerBase):
    """Captures DataSets spanning trigger windows.

    Two forms (≈ DataSink.hpp multiplexed listener):

    - ``MultiplexedPoller(start, stop)`` — legacy pair of matchers; a window
      spans a start match to the next stop match.
    - ``MultiplexedPoller(matcher)`` — the reference form: ONE (possibly
      stateful) ``Tag → MatchResult`` matcher. ``MATCHED`` opens a window (or
      closes-and-reopens when one is already open — the "StopAndStart"
      restart), ``NOT_MATCHED`` closes it, ``IGNORE`` is neutral; the window
      spans [opening tag, closing tag). End-of-stream flushes an open window;
      ``max_samples`` caps and closes a runaway window.
    """

    def __init__(self, start: Matcher | str, stop: Matcher | str | None = None,
                 *, max_windows: int = 16, max_samples: int = 1 << 22,
                 sample_rate: float = 1.0, callback=None):
        super().__init__()
        self.start = match_trigger(start) if isinstance(start, str) else start
        self.stop = (match_trigger(stop) if isinstance(stop, str)
                     else stop)  # None → single-matcher mode
        self.callback = callback
        self.q: "queue.Queue[DataSet]" = queue.Queue(maxsize=max_windows)
        self.sample_rate = sample_rate
        self.max_samples = max_samples
        self._open: tuple[int, Tag, list[np.ndarray]] | None = None

    def _feed(self, chunk: StreamChunk) -> None:
        data, tags = chunk.data, sorted(chunk.tags)
        cursor = 0
        for t in tags:
            if self.stop is None:
                m = self.start(t)
                if m is MatchResult.MATCHED:
                    if self._open is not None:   # restart: close at this tag
                        start_abs, st_tag, parts = self._open
                        parts.append(data[..., cursor:t.index])
                        self._emit(start_abs, st_tag, t, parts)
                    self._open = (chunk.abs_index + t.index, t, [])
                    cursor = t.index
                elif m is MatchResult.NOT_MATCHED and self._open is not None:
                    start_abs, st_tag, parts = self._open
                    parts.append(data[..., cursor:t.index])
                    self._emit(start_abs, st_tag, t, parts)
                    self._open = None
                    cursor = t.index
                continue
            if self._open is None:
                if self.start(t) is MatchResult.MATCHED:
                    self._open = (chunk.abs_index + t.index, t, [])
                    cursor = t.index
            else:
                if self.stop(t) is MatchResult.MATCHED:
                    start_abs, st_tag, parts = self._open
                    parts.append(data[..., cursor:t.index])
                    self._emit(start_abs, st_tag, t, parts)
                    self._open = None
                    cursor = t.index
        if self._open is not None:
            start_abs, st_tag, parts = self._open
            parts.append(data[..., cursor:])
            if sum(p.shape[-1] for p in parts) >= self.max_samples:
                # cap the window at max_samples and close it (overflow close)
                joined = np.concatenate(parts, axis=-1)
                self._emit(start_abs, st_tag, None,
                           [joined[..., :self.max_samples]])
                self._open = None

    def _eos(self) -> None:
        if self._open is not None:    # flush the open window at end-of-stream
            start_abs, st_tag, parts = self._open
            self._emit(start_abs, st_tag, None, parts)
            self._open = None
        super()._eos()

    def _emit(self, start_abs: int, start_tag: Tag, stop_tag: Tag | None,
              parts: list[np.ndarray]) -> None:
        parts = [p for p in parts if p.shape[-1]]
        if not parts:
            return
        win = np.concatenate(parts, axis=-1)
        ds = DataSet.from_stream(win,
                                 sample_rate=float(self._meta(
                                     Keys.SAMPLE_RATE, self.sample_rate)),
                                 start_index=start_abs,
                                 tags=[Tag(0, dict(start_tag.map))])
        ds.meta["trigger_start"] = dict(start_tag.map)
        if stop_tag is not None:
            ds.meta["trigger_stop"] = dict(stop_tag.map)
        _stamp_meta(ds, self)
        if self.callback is not None:
            self.callback(ds)
            return
        try:
            self.q.put_nowait(ds)
        except queue.Full:
            pass

    def read(self, timeout: float | None = 1.0) -> DataSet | None:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class SnapshotPoller(_PollerBase):
    """Single samples at trigger + delay (≈ DataSink.hpp snapshot listener).

    ``delay_samples`` counts samples; ``delay_s`` counts seconds, resolved
    against the sink's (tag-updated) sample rate at trigger time. ``read()``
    keeps the legacy ``(abs_index, value, trigger_map)`` tuples;
    ``emit='dataset'`` switches to reference-style one-sample DataSets whose
    timing event sits at ``-delay`` (the trigger, relative to the snapshot)."""

    def __init__(self, matcher: Matcher | str, *, delay_samples: int = 0,
                 delay_s: float | None = None, max_items: int = 256,
                 emit: str = "tuple", callback=None):
        super().__init__()
        self.matcher = match_trigger(matcher) if isinstance(matcher, str) else matcher
        self.delay = delay_samples
        self.delay_s = delay_s
        self.emit = emit
        self.callback = callback
        self.q: "queue.Queue[Any]" = queue.Queue(maxsize=max_items)
        self._armed: list[tuple[int, int, dict]] = []  # (abs idx, delay, map)

    def _delay_samples(self) -> int:
        if self.delay_s is None:
            return self.delay
        fs = float(self._meta(Keys.SAMPLE_RATE, 1.0))
        return int(round(self.delay_s * fs))

    def _feed(self, chunk: StreamChunk) -> None:
        for t in chunk.tags:
            if self.matcher(t) is MatchResult.MATCHED:
                d = self._delay_samples()
                self._armed.append((chunk.abs_index + t.index + d, d,
                                    dict(t.map)))
        still = []
        hi = chunk.abs_index + chunk.data.shape[-1]
        for (target, d, tmap) in self._armed:
            if chunk.abs_index <= target < hi:
                val = chunk.data[..., target - chunk.abs_index]
                self._deliver(target, d, val, tmap)
            elif target >= hi:
                still.append((target, d, tmap))
        self._armed = still

    def _deliver(self, target: int, delay: int, val, tmap: dict) -> None:
        if self.emit == "dataset" or self.callback is not None:
            ds = DataSet.from_stream(
                np.asarray([val]),
                sample_rate=float(self._meta(Keys.SAMPLE_RATE, 1.0)),
                start_index=target, tags=[Tag(-delay, dict(tmap))])
            ds.meta["trigger"] = dict(tmap)
            _stamp_meta(ds, self)
            item = ds
        else:
            item = (target, val, tmap)
        if self.callback is not None:
            self.callback(item)
            return
        try:
            self.q.put_nowait(item)
        except queue.Full:
            pass

    def read(self, timeout: float | None = 1.0):
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class DataSetPoller(_PollerBase):
    """Queue of DataSets published by a DataSet-producing sink
    (≈ DataSink.hpp DataSetPoller / DataSetSink)."""

    def __init__(self, *, max_items: int = 256, callback=None):
        super().__init__()
        self.callback = callback
        self.q: "queue.Queue[DataSet]" = queue.Queue(maxsize=max_items)
        self.drop_count = 0

    def _feed_dataset(self, ds: DataSet) -> None:
        if self.callback is not None:
            self.callback(ds)
            return
        try:
            self.q.put_nowait(ds)
        except queue.Full:
            self.drop_count += 1

    def _feed(self, chunk: StreamChunk) -> None:  # not stream-fed
        pass

    def read(self, timeout: float | None = 1.0) -> DataSet | None:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def read_all(self) -> list[DataSet]:
        out = []
        while True:
            try:
                out.append(self.q.get_nowait())
            except queue.Empty:
                return out


class _StreamingCallback(_PollerBase):
    """Chunk-splitting streaming callback listener (≈ DataSink.hpp
    ContinuousListener with callback): re-chunks deliveries to at most
    ``max_chunk_size`` samples and dispatches on the callback's arity —
    ``fn(data)``, ``fn(data, tags)``, or ``fn(data, tags, sink)``."""

    def __init__(self, fn, max_chunk_size: int, sink):
        super().__init__()
        import inspect
        self.fn = fn
        self.max_chunk = int(max_chunk_size)
        self.sink = sink
        try:
            params = inspect.signature(fn).parameters.values()
            # count positional slots only; *args means "takes everything"
            self.arity = 3 if any(
                p.kind is inspect.Parameter.VAR_POSITIONAL
                for p in params) else sum(
                p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
                for p in params)
        except (TypeError, ValueError):
            self.arity = 1

    def _feed(self, chunk: StreamChunk) -> None:
        n = chunk.data.shape[-1]
        for lo in range(0, n, self.max_chunk):
            hi = min(lo + self.max_chunk, n)
            data = chunk.data[..., lo:hi]
            tags = [t.shifted(-lo) for t in chunk.tags if lo <= t.index < hi]
            if self.arity <= 1:
                self.fn(data)
            elif self.arity == 2:
                self.fn(data, tags)
            else:
                self.fn(data, tags, self.sink)


class DataSinkRegistry:
    """Global sink registry with poller/callback attachment (≈ DataSink.hpp:163
    DataSinkRegistry + the register*Callback/get*Poller query API).

    Lookup accepts either a plain string (legacy: signal name, raising
    ``KeyError`` when absent) or a :class:`DataSinkQuery` (reference
    semantics: ``None``/``False`` when no sink matches — callers poll-retry)."""

    def __init__(self):
        self._sinks: dict[str, Any] = {}     # signal name → sink (legacy view)
        self._all: list[Any] = []
        self._lock = threading.Lock()

    def register(self, sink) -> None:
        with self._lock:
            self._sinks[sink.get_signal_name()] = sink
            # a re-created sink with the same identity replaces the stale one
            self._all = [s for s in self._all
                         if not (s.name == sink.name
                                 and s.get_signal_name()
                                 == sink.get_signal_name())]
            self._all.append(sink)

    def unregister(self, sink) -> None:
        with self._lock:
            if self._sinks.get(sink.get_signal_name()) is sink:
                self._sinks.pop(sink.get_signal_name(), None)
            if sink in self._all:
                self._all.remove(sink)

    def sinks(self) -> list[str]:
        with self._lock:
            return sorted(self._sinks)

    def _get(self, signal_name: str):
        with self._lock:
            if signal_name not in self._sinks:
                raise KeyError(f"no DataSink registered for {signal_name!r}; "
                               f"have {sorted(self._sinks)}")
            return self._sinks[signal_name]

    def _find(self, query, *, dtype=None):
        """Resolve a query/str to a sink; str raises, query returns None.

        ``dtype`` mirrors the reference's typed ``getStreamingPoller<T>``
        (qa_DataSink.cpp:338 invalidTypePoller): a sink with a *declared*
        dtype only matches the same dtype; undeclared sinks are polymorphic
        (dtype resolves at graph compile here) and match any request."""
        if isinstance(query, str):
            return self._get(query)
        with self._lock:
            for s in self._all:
                if query.matches(s):
                    declared = getattr(s, "declared_dtype", lambda: None)()
                    if dtype is not None and declared is not None \
                            and np.dtype(dtype) != declared:
                        continue
                    return s
        return None

    def _attach(self, query, poller, *, dtype=None):
        sink = self._find(query, dtype=dtype)
        if sink is None or not hasattr(sink, "attach"):
            return None
        return sink.attach(poller)

    # -- poller getters ---------------------------------------------------------

    def get_streaming_poller(self, query, *, dtype=None, **kw
                             ) -> StreamingPoller | None:
        return self._attach(query, StreamingPoller(**kw), dtype=dtype)

    def get_trigger_poller(self, query, matcher, **kw) -> TriggerPoller | None:
        return self._attach(query, TriggerPoller(matcher, **kw))

    def get_multiplexed_poller(self, query, start, stop=None, **kw
                               ) -> MultiplexedPoller | None:
        return self._attach(query, MultiplexedPoller(start, stop, **kw))

    def get_snapshot_poller(self, query, matcher, **kw
                            ) -> SnapshotPoller | None:
        return self._attach(query, SnapshotPoller(matcher, **kw))

    def get_dataset_poller(self, query, **kw) -> DataSetPoller | None:
        sink = self._find(query)
        if sink is None or not hasattr(sink, "attach_dataset_listener"):
            return None
        p = DataSetPoller(**kw)
        sink.attach_dataset_listener(p)
        return p

    # -- callback registration (≈ register*Callback, return False = not found) --

    def register_streaming_callback(self, query, max_chunk_size: int, fn
                                    ) -> bool:
        sink = self._find(query)
        if sink is None:
            return False
        sink.attach(_StreamingCallback(fn, max_chunk_size, sink))
        return True

    def register_trigger_callback(self, query, matcher, pre: int, post: int,
                                  fn) -> bool:
        sink = self._find(query)
        if sink is None:
            return False
        sink.attach(TriggerPoller(matcher, pre=pre, post=post, callback=fn))
        return True

    def register_multiplexed_callback(self, query, matcher, max_samples: int,
                                      fn) -> bool:
        sink = self._find(query)
        if sink is None:
            return False
        sink.attach(MultiplexedPoller(matcher, None, max_samples=max_samples,
                                      callback=fn))
        return True

    def register_snapshot_callback(self, query, matcher, fn, *,
                                   delay_samples: int = 0,
                                   delay_s: float | None = None) -> bool:
        sink = self._find(query)
        if sink is None:
            return False
        sink.attach(SnapshotPoller(matcher, delay_samples=delay_samples,
                                   delay_s=delay_s, emit="dataset",
                                   callback=fn))
        return True

    def register_dataset_callback(self, query, fn) -> bool:
        sink = self._find(query)
        if sink is None or not hasattr(sink, "attach_dataset_listener"):
            return False
        sink.attach_dataset_listener(DataSetPoller(callback=fn))
        return True


global_data_sink_registry = DataSinkRegistry()


_META_KEYS = (Keys.SAMPLE_RATE, Keys.SIGNAL_NAME, Keys.SIGNAL_UNIT,
              Keys.SIGNAL_QUANTITY, Keys.SIGNAL_MIN, Keys.SIGNAL_MAX)


@register_block("DataSink")
class DataSink(SinkBlock):
    """Terminal block feeding registered pollers (≈ DataSink.hpp:468).

    Publishes a metadata tag (sample_rate + signal name/unit/quantity/min/max
    from its own settings) ahead of the first delivered chunk — the reference
    DataSink does the same on start (qa_DataSink.cpp:310 "metadata tag
    published by DataSink") — and keeps its signal metadata updated from
    incoming tags, stamping it onto every DataSet the pollers emit."""

    IN = (Port("in"),)
    signal_name = Setting(default="", kind="static",
                          description="registry key (defaults to block name)")
    dtype = Setting(default="", kind="static",
                    description="declared sample dtype ('' = polymorphic)")
    signal_unit = Setting(default="a.u.", kind="static")
    signal_quantity = Setting(default="", kind="static")
    signal_min = Setting(default=float("-inf"), kind="static")
    signal_max = Setting(default=float("inf"), kind="static")
    sample_rate = Setting(default=1.0, kind="static")

    def __init__(self, name=None, registry: DataSinkRegistry | None = None,
                 **settings):
        super().__init__(name=name, **settings)
        self.registry = registry or global_data_sink_registry
        if not self.settings.get("signal_name"):
            self.settings.set({"signal_name": self.name})
            self.settings.apply_staged()
        self._pollers: list[_PollerBase] = []
        self._plock = threading.Lock()
        self._meta = {
            Keys.SAMPLE_RATE: float(self.settings.get("sample_rate")),
            Keys.SIGNAL_NAME: str(self.settings.get("signal_name")),
            Keys.SIGNAL_UNIT: str(self.settings.get("signal_unit")),
            Keys.SIGNAL_QUANTITY: str(self.settings.get("signal_quantity")),
        }
        for k, s in ((Keys.SIGNAL_MIN, "signal_min"),
                     (Keys.SIGNAL_MAX, "signal_max")):
            v = float(self.settings.get(s))
            if np.isfinite(v):
                self._meta[k] = v
        self._meta_published = False
        self.registry.register(self)

    # NOTE: no @property here — it would shadow the Setting descriptor and
    # prevent its registration in _settings_spec.
    def get_signal_name(self) -> str:
        return str(self.settings.get("signal_name"))

    def declared_dtype(self):
        d = str(self.settings.get("dtype"))
        return np.dtype(d) if d else None

    def attach(self, poller: _PollerBase):
        with self._plock:
            poller.sink_meta = self._meta
            self._pollers.append(poller)
        return poller

    def consume(self, arrays, tags, n_valid, abs_index):
        data = arrays["in"][..., :n_valid]
        in_tags = [t for t in tags.get("in", []) if t.index <= n_valid]
        for t in in_tags:   # auto-update signal metadata from incoming tags
            for k in _META_KEYS:
                if k in t.map:
                    self._meta[k] = t.map[k]
        if not self._meta_published and n_valid:
            # only when this chunk actually reaches the pollers — an empty
            # first delivery (warm-up underrun) must not swallow the one-shot
            # metadata tag
            self._meta_published = True
            in_tags.insert(0, Tag(0, dict(self._meta)))
        chunk = StreamChunk(data=data, tags=in_tags, abs_index=abs_index)
        eos = any(t.map.get(Keys.END_OF_STREAM) for t in chunk.tags)
        with self._plock:
            pollers = list(self._pollers)
        for p in pollers:
            if n_valid:
                p._feed(chunk)
            if eos:
                p._eos()

    def stop(self):
        with self._plock:
            for p in self._pollers:
                p._eos()
        # the reference registry stops handing out pollers once the sink's
        # run ended (qa_DataSink.cpp:390 pollerAfterStop == nullptr)
        self.registry.unregister(self)
