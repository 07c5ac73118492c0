"""Acquisition blocks: StreamToDataSet windows + DataSetSink
(≈ reference blocks/basic StreamToDataSet.hpp:27, DataSink.hpp DataSetSink).

DataSet assembly is host-side egress (device streams carry only dense sample
blocks); the trigger windowing reuses the DataSink poller machinery,
so a StreamToDataSet is a sink whose ``datasets`` queue yields the captured
windows — the same capability surface as the reference's DataSet stream feeding a
DataSetSink."""

from __future__ import annotations

import queue

import numpy as np
import torch

from ..core.block import Block, Port, SinkBlock
from ..core.dataset import DataSet
from ..core.datasink import MultiplexedPoller, StreamChunk, TriggerPoller
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.tags import Keys
from .misc import _gate, _open_intervals


class _TransformingQueue:
    """Queue facade applying a DataSet transform on put (pollers only put)."""

    def __init__(self, q, transform):
        self._q, self._transform = q, transform

    def put(self, ds, *a, **kw):
        self._q.put(self._transform(ds), *a, **kw)

    def put_nowait(self, ds):
        self._q.put_nowait(self._transform(ds))


@register_block("StreamToDataSet")
class StreamToDataSet(SinkBlock):
    """Trigger-windowed stream capture → DataSets.

    ``mode='auto'`` (default) is the reference-fidelity path
    (StreamToDataSet.hpp:25 ``StreamFilterImpl<T, false>``): the single
    ``filter`` string selects start/stop pairs (``"[A/ctx1, B/ctx2]"``,
    ``^``-prefixed parts for inclusive "ends" windows) or a bare single-trigger
    matcher; overlapping windows accumulate concurrently with FIFO start/stop
    pairing; in-window tags land in ``DataSet.timing_events`` and merged
    auto-forward tags ride ``self.out_tags`` (see core/stream_capture.py).

    Legacy modes: 'triggered' (pre/post around the old matcher DSL),
    'multiplexed' (separate ``filter_stop``), 'continuous' (fixed-length
    back-to-back windows).
    """

    IN = (Port("in"),)
    mode = Setting(default="auto", kind="static",
                   choices=("auto", "triggered", "multiplexed", "continuous"))
    filter = Setting(default="", kind="static",
                     description="trigger matcher DSL (start matcher)")
    filter_stop = Setting(default="", kind="static",
                          description="stop matcher for multiplexed mode")
    n_pre = Setting(default=0, kind="static", limits=(0, 1 << 24))
    n_post = Setting(default=0, kind="static", limits=(0, 1 << 24))
    n_max = Setting(default=0, kind="static", limits=(0, 1 << 30),
                    description="max DataSet size (0: infinite)")
    n_length = Setting(default=1024, kind="static", limits=(1, 1 << 24),
                       description="window length for continuous mode")
    sample_rate_hint = Setting(default=1.0, kind="static")
    signal_name = Setting(default="", kind="static")
    signal_quantity = Setting(default="", kind="static")
    signal_unit = Setting(default="", kind="static")
    signal_min = Setting(default=0.0, kind="static")
    signal_max = Setting(default=1.0, kind="static")

    def __init__(self, name=None, registry=None, **settings):
        # legacy surface compatibility: n_post used to default to 1024 for the
        # poller modes — keep that when a legacy mode is chosen explicitly
        if settings.get("mode") in ("triggered", "multiplexed") \
                and "n_post" not in settings:
            settings["n_post"] = 1024
        super().__init__(name=name, **settings)
        self.datasets: "queue.Queue[DataSet]" = queue.Queue()
        self.out_tags: list = []   # merged auto-forward tags at DataSet indices
        # DataSet consumer endpoint (≈ DataSetSink<T> + getDataSetPoller,
        # DataSink.hpp): register so DataSinkQuery.sink/signal finds us
        from ..core.datasink import global_data_sink_registry
        self._ds_listeners: list = []
        self.registry = registry or global_data_sink_registry
        self.registry.register(self)
        mode = self.settings.get("mode")
        fs = float(self.settings.get("sample_rate_hint"))
        self._engine = None
        self._impl = None
        if mode == "auto":
            from ..core.stream_capture import CaptureEngine
            self._engine = CaptureEngine(
                str(self.settings.get("filter")),
                n_pre=int(self.settings.get("n_pre")),
                n_post=int(self.settings.get("n_post")),
                n_max=int(self.settings.get("n_max")),
                stream_out=False, sample_rate=fs,
                signal_name=str(self.settings.get("signal_name")) or "",
                signal_quantity=str(self.settings.get("signal_quantity")),
                signal_unit=str(self.settings.get("signal_unit")),
                signal_min=float(self.settings.get("signal_min")),
                signal_max=float(self.settings.get("signal_max")))
            self._drained = 0
        elif mode == "triggered":
            self._impl = TriggerPoller(str(self.settings.get("filter")),
                                       pre=int(self.settings.get("n_pre")),
                                       post=int(self.settings.get("n_post")),
                                       sample_rate=fs, max_windows=1024)
            self._impl.q = _TransformingQueue(self.datasets,
                                              self.transform_dataset)
        elif mode == "multiplexed":
            self._impl = MultiplexedPoller(str(self.settings.get("filter")),
                                           str(self.settings.get("filter_stop")),
                                           sample_rate=fs, max_windows=1024)
            self._impl.q = _TransformingQueue(self.datasets,
                                              self.transform_dataset)
        else:
            self._acc: list[np.ndarray] = []
            self._acc_n = 0
            self._start_abs = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        data = arrays["in"][..., :n_valid]
        if n_valid == 0:
            return
        if self._engine is not None:
            self._engine.feed(np.asarray(data),
                              [t for t in tags.get("in", [])
                               if t.index < n_valid])
            while self._drained < len(self._engine.datasets):
                ds = self.transform_dataset(self._engine.datasets[self._drained])
                self.datasets.put(ds)
                for lst in self._ds_listeners:
                    lst._feed_dataset(ds)
                self._drained += 1
            self.out_tags = self._engine.ds_tags
            return
        if self._impl is not None:
            self._impl._feed(StreamChunk(
                data=data, tags=[t for t in tags.get("in", [])
                                 if t.index <= n_valid],
                abs_index=abs_index))
            return
        # continuous windows
        n_len = int(self.settings.get("n_length"))
        self._acc.append(data)
        self._acc_n += data.shape[-1]
        while self._acc_n >= n_len:
            joined = np.concatenate(self._acc, axis=-1)
            win, rest = joined[..., :n_len], joined[..., n_len:]
            self.datasets.put(self.transform_dataset(DataSet.from_stream(
                win, sample_rate=float(self.settings.get("sample_rate_hint")),
                start_index=self._start_abs, signal_name=self.name)))
            self._start_abs += n_len
            self._acc = [rest] if rest.shape[-1] else []
            self._acc_n = rest.shape[-1]

    def transform_dataset(self, ds: DataSet) -> DataSet:
        """Hook: subclasses may post-process each captured DataSet before it
        reaches the queue/listeners (identity here). Used by
        :class:`SavitzkyGolayDataSetFilter`."""
        return ds

    def read(self, timeout: float | None = 1.0) -> DataSet | None:
        try:
            return self.datasets.get(timeout=timeout)
        except queue.Empty:
            return None

    def read_all(self) -> list[DataSet]:
        out = []
        while True:
            try:
                out.append(self.datasets.get_nowait())
            except queue.Empty:
                return out

    # -- DataSet consumer endpoint (registry-facing) ----------------------------

    def get_signal_name(self) -> str:
        return str(self.settings.get("signal_name")) or self.name

    def attach_dataset_listener(self, listener):
        self._ds_listeners.append(listener)
        return listener

    def stop(self):
        for lst in self._ds_listeners:
            lst._eos()
        self.registry.unregister(self)


@register_block("SyncSink")
class SyncSink(SinkBlock):
    """Reference-fidelity multi-stream synchronizer endpoint
    (≈ blocks/basic SyncBlock.hpp:12): aligns N equal-rate streams on
    trigger tags with matching ``trigger_time`` (within ``tolerance``),
    accounting dropped samples via ``n_dropped_samples`` tags and bounding
    desynchronized history by ``max_history_size``.

    Variable per-port drops are a variable-rate transform, so the exact
    reference semantics live at the host boundary (core/sync_engine.py);
    the in-graph device form with bounded skew is ``blocks.misc.SyncBlock``.
    Read aligned streams with :meth:`data` / :meth:`out_tags`."""

    PER_PORT_VALID = True   # Async inputs progress independently
    n_ports = Setting(default=2, kind="static", limits=(1, 32))
    max_history_size = Setting(default=32000, kind="static")
    filter = Setting(default="", kind="static",
                     description="trigger name filter ('' = any)")
    tolerance = Setting(default=5, kind="static",
                        description="trigger time tolerance [ns]")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        from ..core.sync_engine import SyncEngine
        n = int(self.settings.get("n_ports"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n))
        self.engine = SyncEngine(
            n, max_history_size=int(self.settings.get("max_history_size")),
            filter=str(self.settings.get("filter")),
            tolerance=int(self.settings.get("tolerance")))

    def consume(self, arrays, tags, n_valid, abs_index):
        # PER_PORT_VALID: n_valid is {port: count} — each stream advances by
        # its own upstream's validity (≈ Async ports, SyncBlock.hpp:124)
        for i in range(len(self.in_ports)):
            nv = n_valid[f"in{i}"] if isinstance(n_valid, dict) else n_valid
            if nv <= 0:
                continue
            self.engine.feed(i, np.asarray(arrays[f"in{i}"][..., :nv]),
                             [t for t in tags.get(f"in{i}", [])
                              if t.index < nv], pump=False)
        self.engine.pump()

    def data(self, port: int) -> np.ndarray:
        return self.engine.data(port)

    def out_tags(self, port: int):
        return self.engine.out_tags[port]


@register_block("StreamFilterSink")
class StreamFilterSink(SinkBlock):
    """Reference-fidelity *stream-out* trigger capture
    (StreamToDataSet.hpp:23 ``StreamFilter`` = ``StreamFilterImpl<T, true>``):
    publishes only the samples inside trigger windows as a compacted stream
    with tags re-indexed to the output grid, including the merged
    auto-forward tag semantics.

    Static device shapes forbid a variable-rate in-graph stream, so the
    compacted stream terminates here at the host boundary: read it with
    :meth:`data` / :attr:`tags` (the in-graph gate-to-zero form is
    ``blocks.misc.StreamFilter``)."""

    IN = (Port("in"),)
    filter = Setting(default="", kind="static",
                     description="'[start/ctx1, stop/ctx2]' or single matcher")
    n_pre = Setting(default=0, kind="static", limits=(0, 1 << 24))
    n_post = Setting(default=0, kind="static", limits=(0, 1 << 24))
    sample_rate_hint = Setting(default=1.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        from ..core.stream_capture import CaptureEngine
        self._engine = CaptureEngine(
            str(self.settings.get("filter")),
            n_pre=int(self.settings.get("n_pre")),
            n_post=int(self.settings.get("n_post")),
            stream_out=True,
            sample_rate=float(self.settings.get("sample_rate_hint")))

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid == 0:
            return
        self._engine.feed(np.asarray(arrays["in"][..., :n_valid]),
                          [t for t in tags.get("in", []) if t.index < n_valid])

    def data(self) -> np.ndarray:
        return self._engine.data()

    @property
    def tags(self):
        return self._engine.out_tags


@register_block("TriggerGate")
class TriggerGate(Block):
    """Device-side trigger-windowed gating (the TagArrays device path).

    Passes samples inside ``[tag − n_pre, tag + n_post)`` windows around each
    matching trigger tag and zeroes everything else — trigger capture *inside
    the data path*, the analog of the reference gating streams on TriggerMatcher
    hits in DataSink::processBulk (blocks/basic DataSink.hpp:468,
    core TriggerMatcher.hpp:19). The host packs this step's matching tags into
    fixed-capacity index/valid arrays (:class:`~..core.tags.TagArrays`, capacity
    = ``Scheduler(max_tags_per_step=)``), as in the JAX package; a window
    extending past the step boundary is carried into the next step (``n_pre``
    cannot reach backwards across a step boundary — pre-trigger history is a
    host-side capture concern, see :class:`StreamToDataSet`).

    The windows are host numbers (the tags' indices), so the gate is their
    union as [lo, hi) runs, found on the host, and the step is one zero fill
    plus a copy per run: the same samples as the JAX package's ``[capacity,
    T]`` mask, without that mask. The carry (samples of an open window still
    to pass) is a 0-d int32 host tensor.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    WANTS_TAG_ARRAYS = True
    filter = Setting(default="", kind="static",
                     description="trigger matcher DSL; empty = every trigger tag")
    n_pre = Setting(default=0, kind="static", limits=(0, 1 << 20))
    n_post = Setting(default=1024, kind="static", limits=(1, 1 << 24))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        from ..core.trigger import MatchResult, match_trigger
        patt = str(self.settings.get("filter"))
        if patt:
            m = match_trigger(patt)
            self._matches = lambda t: m(t) is MatchResult.MATCHED
        else:
            self._matches = lambda t: Keys.TRIGGER_NAME in t.map
        # populated by the scheduler's tag walk each step (WANTS_TAG_ARRAYS)
        self._step_in_tags = []
        self._tag_capacity = 64

    def init_state(self, ctx):
        # samples of an open window still to pass at the start of the next step
        return torch.zeros((), dtype=torch.int32)

    def prepare_params(self, params):
        from ..core.tags import TagArrays
        ta = TagArrays.from_tags(
            [t for t in self._step_in_tags if self._matches(t)],
            self._tag_capacity)
        params = dict(params)
        params["tag_idx"] = ta.indices
        params["tag_valid"] = ta.valid
        return params

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = x.shape[-1]
        pre = int(self.settings.get("n_pre"))
        post = int(self.settings.get("n_post"))
        idx = ctx.params.get("tag_idx", np.zeros(0, np.int32))
        valid = ctx.params.get("tag_valid", np.zeros(0, bool))
        lo_hi = [(int(i) - pre, int(i) + post)
                 for i, v in zip(idx, valid) if v]
        carried = int(state)
        # the window carried over from the previous step covers [0, carried)
        deltas = [(0, 1), (carried, -1)] if carried > 0 else []
        for lo, hi in lo_hi:
            deltas += [(lo, 1), (hi, -1)]
        runs, _ = _open_intervals(0, deltas, n)
        carry = max(carried - n, 0, *(hi - n for _, hi in lo_hi))
        return torch.tensor(carry, dtype=torch.int32), {"out": _gate(x, runs)}


@register_block("DataSetSink")
class DataSetSink(StreamToDataSet):
    """Continuous fixed-window capture (DataSet consumer endpoint)."""

    def __init__(self, name=None, **settings):
        settings.setdefault("mode", "continuous")
        super().__init__(name=name, **settings)


@register_block("SavitzkyGolayDataSetFilter")
class SavitzkyGolayDataSetFilter(StreamToDataSet):
    """Zero-phase Savitzky-Golay smoothing on captured DataSets
    (≈ blocks/filter SavitzkyGolayFilter.hpp:90 SavitzkyGolayDataSetFilter:
    forward-backward S-G over signal_values — |H|² response, no phase
    distortion, Reflect/Replicate boundary policy).

    The reference block is PortIn<DataSet> → PortOut<DataSet>; here DataSets
    live on the host once captured, so this block IS the capture sink with
    the S-G transform applied to every delivered window
    (:meth:`transform_dataset`). For direct host use on an existing DataSet
    call :func:`gnuradio4_tpu_torch.ops.dataset_math.apply_savgol`.
    """

    window_size = Setting(default=11, kind="static", limits=(3, 4097))
    poly_order = Setting(default=4, kind="static", limits=(0, 32))
    deriv_order = Setting(default=0, kind="static", limits=(0, 8))
    boundary_policy = Setting(default="Reflect", kind="static",
                              choices=("Reflect", "Replicate"))

    def __init__(self, name=None, **settings):
        settings.setdefault("mode", "continuous")
        super().__init__(name=name, **settings)

    def transform_dataset(self, ds: DataSet) -> DataSet:
        from ..ops.dataset_math import apply_savgol
        return apply_savgol(
            ds, int(self.settings.get("window_size")),
            int(self.settings.get("poly_order")),
            deriv=int(self.settings.get("deriv_order")),
            boundary=str(self.settings.get("boundary_policy")).lower())
