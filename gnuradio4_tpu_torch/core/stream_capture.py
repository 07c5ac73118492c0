"""Host-side trigger-windowed stream capture — exact behavioral twin of the
reference's ``StreamFilterImpl`` (blocks/basic StreamToDataSet.hpp:25-569) in
both of its instantiations:

- **stream out** (``StreamFilter``): publishes only the samples inside trigger
  windows as a compacted stream, with tags re-indexed to the output grid
  (StreamToDataSet.hpp:176 processBulkStream);
- **DataSet out** (``StreamToDataSet``): publishes one DataSet per completed
  window, carrying the in-window tags in ``timing_events`` and supporting
  *overlapping* concurrent windows with FIFO start/stop pairing
  (StreamToDataSet.hpp:262 processBulkDataSet).

Placement: sample data rides the device step untouched;
windowing is O(tags) host control-plane work on the sink side of the graph —
the same split the rest of the tag machinery uses (core/tags.py). Variable-rate
extraction is impossible under static shapes, so the reference's stream-out
*block* becomes a stream-out *sink* here (the gate-to-zero device block
``blocks.misc.StreamFilter`` covers the in-graph case).

The JAX package's engine, with two host loops over samples made array
operations of the same results: the pre-trigger history appends only the
samples its deque keeps, and a window's time axis grows by one array per
chunk.

The engine is fed scheduler-sized chunks and internally re-chunks at tag
positions so each processing quantum sees tags at offset 0 only — reproducing
the reference scheduler's chunk-break-at-tag delivery that StreamToDataSet is
written against (StreamToDataSet.hpp:411 "Tags at index 0, since
input_chunk_size == 1").
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np

from .dataset import Axis, DataSet, SignalMeta
from .errors import GrError
from .tags import Keys, Tag
from .trigger import BasicTriggerNameCtxMatcher, MatchResult

# the reference's default auto-forward tag dictionary (Tag.hpp:260 kDefaultTags)
DEFAULT_AUTO_FORWARD = frozenset({
    "sample_rate", "frequency", "signal_name", "num_channels",
    "signal_quantity", "signal_unit", "signal_min", "signal_max",
    "n_dropped_samples", "rx_overflow", "trigger_name", "trigger_time",
    "trigger_offset", "trigger_meta_info", "context", "ctx_time", "local_time",
    "reset_default", "store_default", "end_of_stream",
})


@dataclasses.dataclass
class _AccState:
    """≈ StreamToDataSet.hpp:80 AccumulationState."""

    is_active: bool = False
    is_pre_active: bool = False
    is_post_active: bool = False
    is_single: bool = False
    n_post_remain: int = 0
    n_pre_samples: int = 0
    n_samples: int = 0

    def update(self, start: bool, end: bool, single: bool,
               n_pre: int, n_post: int) -> None:
        self.is_single = single
        if not self.is_active and start:
            self.is_pre_active = n_pre > 0
            self.is_active = True
            self.n_samples = 0
            if single:
                self.is_post_active = True
                self.n_post_remain = n_post
        if self.is_active and not self.is_post_active and end:
            self.is_post_active = True
            self.n_post_remain = n_post

    def update_post(self, n_copied: int) -> None:
        self.n_post_remain -= n_copied
        self.n_samples += n_copied
        if self.n_post_remain == 0:
            self.is_active = False
            self.is_post_active = False


@dataclasses.dataclass
class _HistTag:
    age: int              # samples into the past (1 = the newest sample)
    map: dict[str, Any]


@dataclasses.dataclass
class _Window:
    """One concurrent DataSet accumulation (deque entry, hpp:127-129)."""

    acc: _AccState
    fstate: dict
    values: list[np.ndarray] = dataclasses.field(default_factory=list)
    n_values: int = 0
    axis: list[np.ndarray] = dataclasses.field(default_factory=list)
    events: list[Tag] = dataclasses.field(default_factory=list)


class CaptureEngine:
    """Feed chunks + tags in, get compacted samples / DataSets out."""

    def __init__(self, filter: str, *, n_pre: int = 0, n_post: int = 0,
                 n_max: int = 0, stream_out: bool = False,
                 sample_rate: float = 1.0, signal_name: str = "",
                 signal_quantity: str = "", signal_unit: str = "",
                 signal_min: float = 0.0, signal_max: float = 1.0,
                 auto_forward: frozenset[str] = DEFAULT_AUTO_FORWARD):
        if not stream_out and n_max != 0 and n_pre + n_post > n_max:
            raise GrError(f"ill-formed settings: n_pre({n_pre}) + "
                          f"n_post({n_post}) > n_max({n_max})")
        self.matcher = BasicTriggerNameCtxMatcher(filter)
        self.n_pre, self.n_post, self.n_max = int(n_pre), int(n_post), int(n_max)
        self.stream_out = bool(stream_out)
        self.sample_rate = float(sample_rate)
        self.signal_name = signal_name
        self.signal_quantity = signal_quantity
        self.signal_unit = signal_unit
        self.signal_min, self.signal_max = signal_min, signal_max
        self.auto_forward = auto_forward

        self._history: deque[Any] = deque(maxlen=max(self.n_pre, 1))
        self._history_tags: list[_HistTag] = []
        self._merged_af: dict[str, Any] = {}

        # stream-out state
        self._acc = _AccState()
        self._fstate = self.matcher.new_state()
        self._out_chunks: list[np.ndarray] = []
        self.out_count = 0
        self.out_tags: list[Tag] = []      # output-indexed

        # DataSet-out state
        self._windows: deque[_Window] = deque()
        self.datasets: list[DataSet] = []
        self.ds_tags: list[Tag] = []       # indexed by published-DataSet number

    # -- public API -------------------------------------------------------------

    def feed(self, data: np.ndarray, tags: list[Tag] = ()) -> None:
        """Process one chunk; ``tags`` carry chunk-relative indices."""
        data = np.asarray(data)
        n = data.shape[-1]
        in_range = sorted((t for t in tags if 0 <= t.index < n),
                          key=lambda t: t.index)
        # auto-update sample_rate like the reference's settings auto-forward
        for t in in_range:
            if Keys.SAMPLE_RATE in t.map:
                self.sample_rate = float(t.map[Keys.SAMPLE_RATE])
        # re-chunk at tag positions → every quantum has tags at offset 0 only
        bounds = sorted({t.index for t in in_range} | {0, n})
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sub_tags = [t.shifted(-lo) for t in in_range if t.index == lo]
            self._process(data[..., lo:hi], sub_tags)

    def data(self) -> np.ndarray:
        """Stream-out mode: all captured samples so far."""
        if not self._out_chunks:
            return np.zeros(0)
        return np.concatenate(self._out_chunks, axis=-1)

    # -- trigger plumbing ---------------------------------------------------------

    def _detect(self, tag: Tag | None, state: dict
                ) -> tuple[bool, bool, bool]:
        m = self.matcher(tag, state)
        if m is MatchResult.IGNORE:
            return False, False, False
        return (m is MatchResult.MATCHED, m is MatchResult.NOT_MATCHED,
                self.matcher.is_single)

    def _find_first_trigger(self, tags: list[Tag]) -> Tag | None:
        """≈ hpp:407 findFirstTriggerTag (tags are at index 0 by construction)."""
        for t in tags:
            if self.stream_out:
                if any(self._detect(t, dict(self._fstate))):
                    return t
            else:
                if any(self._detect(t, self.matcher.new_state())):
                    return t
                if any(any(self._detect(t, dict(w.fstate)))
                       for w in self._windows):
                    return t
        return tags[0] if tags else None

    # -- history ------------------------------------------------------------------

    def _merge_af_tags(self, tag_maps) -> None:
        for m in tag_maps:
            for k, v in m.items():
                if k in self.auto_forward:
                    # own settings win for writable members (hpp:528-531)
                    if k == Keys.SAMPLE_RATE:
                        v = self.sample_rate
                    self._merged_af[k] = v

    def _update_history(self, data: np.ndarray, max_copy: int,
                        copy_tags: bool, tags: list[Tag]) -> None:
        """≈ hpp:469 updateHistory: tags are inserted with their chunk-relative
        index, then ALL history-tag ages advance by the samples consumed (the
        reference increments after insertion, hpp:491-493 — fresh tags are at
        index 0 by chunk construction, so age = samples consumed)."""
        k = min(max_copy, data.shape[-1])
        if k == 0:
            return
        fresh: list[_HistTag] = []
        if self.stream_out:
            if copy_tags:
                if self.n_pre > 0:
                    fresh = [_HistTag(t.index, t.map) for t in tags]
                else:
                    self._merge_af_tags(t.map for t in tags)
        else:
            if copy_tags and self.n_pre > 0:
                fresh = [_HistTag(t.index, t.map) for t in tags]
            self._merge_af_tags(t.map for t in tags)
        if self.n_pre > 0:
            # the deque keeps its last maxlen samples: append only those
            lo = max(0, k - self._history.maxlen)
            for s in np.moveaxis(data[..., lo:k], -1, 0):
                self._history.append(s)
            self._history_tags += fresh
            for ht in self._history_tags:
                ht.age += k
            expired = [ht for ht in self._history_tags if ht.age > self.n_pre]
            self._history_tags = [ht for ht in self._history_tags
                                  if ht.age <= self.n_pre]
            if self.stream_out and expired:
                self._merge_af_tags(ht.map for ht in expired)

    def _pre_samples(self, k: int) -> np.ndarray:
        """Chronological view of the k most recent history samples."""
        items = list(self._history)[-k:]
        return np.stack(items, axis=-1) if items else np.zeros(0)

    # -- processing ----------------------------------------------------------------

    def _process(self, chunk: np.ndarray, tags: list[Tag]) -> None:
        if chunk.shape[-1] == 0:
            return
        if self.stream_out:
            self._process_stream(chunk, tags)
        else:
            self._process_dataset(chunk, tags)

    def _publish_merged_af_stream(self) -> None:
        if self._merged_af:
            self.out_tags.append(Tag(self.out_count, dict(self._merged_af)))
            self._merged_af.clear()

    def _process_stream(self, chunk: np.ndarray, tags: list[Tag]) -> None:
        """≈ hpp:176 processBulkStream (host-side: no output backpressure)."""
        matched = self._find_first_trigger(tags)
        start, end, single = self._detect(matched, self._fstate)
        self._acc.update(start, end, single, self.n_pre, self.n_post)
        n = chunk.shape[-1]

        if not self._acc.is_active:
            self._update_history(chunk, n, True, tags)
            return

        parts: list[np.ndarray] = []
        n_publish = 0
        pre_copied = 0
        if self._acc.is_pre_active:
            pre_copied = min(self.n_pre, len(self._history))
            if pre_copied:
                parts.append(self._pre_samples(pre_copied))
            n_publish += pre_copied
            self._acc.is_pre_active = False
            self._acc.n_samples += pre_copied

        if not self._acc.is_post_active:
            parts.append(chunk)
            n_publish += n
            self._acc.n_samples += n
        else:
            m = min(self._acc.n_post_remain, n)
            if m:
                parts.append(chunk[..., :m])
            n_publish += m
            self._acc.update_post(m)

        n_cur = n_publish - pre_copied
        tags_published = False
        if n_publish > 0:
            self._publish_merged_af_stream()
            for ht in self._history_tags:
                off = (pre_copied - ht.age
                       if self.n_pre > 0 and ht.age < pre_copied else 0)
                self.out_tags.append(Tag(self.out_count + off, ht.map))
            self._history_tags.clear()
            for t in tags:
                if t.index < n_cur:
                    self.out_tags.append(
                        Tag(self.out_count + pre_copied + t.index, t.map))
            tags_published = True

        if self._acc.is_active:
            self._update_history(chunk, n_cur, not tags_published, tags)
        else:
            self._update_history(chunk, n, not tags_published, tags)
        if parts:
            self._out_chunks += parts
            self.out_count += n_publish

    def _fill_axis(self, w: _Window, start: int, count: int) -> None:
        # (start + j) / rate for j < count, as float64 — one array per call
        w.axis.append((start + np.arange(count, dtype=np.int64))
                      / self.sample_rate)

    def _process_dataset(self, chunk: np.ndarray, tags: list[Tag]) -> None:
        """≈ hpp:262 processBulkDataSet."""
        matched = self._find_first_trigger(tags)

        # a start trigger always opens a new concurrent window (hpp:274-286)
        tmp_state = self.matcher.new_state()
        start, end, single = self._detect(matched, tmp_state)
        if start:
            self._windows.append(_Window(acc=_AccState(), fstate=tmp_state))
            self._windows[-1].acc.update(start, end, single,
                                         self.n_pre, self.n_post)

        # FIFO stop pairing: only the oldest active non-post window sees the tag
        for w in self._windows:
            if not w.acc.is_active:
                continue
            if not w.acc.is_post_active:
                s2, e2, g2 = self._detect(matched, w.fstate)
                if e2:
                    w.acc.update(s2, e2, g2, self.n_pre, self.n_post)
                break

        n = chunk.shape[-1]
        if not self._windows:
            self._update_history(chunk, n, True, tags)
            return

        for w in self._windows:
            if not w.acc.is_active:
                continue
            if w.acc.is_pre_active:
                k = min(self.n_pre, len(self._history))
                if k:
                    w.values.append(self._pre_samples(k))
                    w.n_values += k
                self._fill_axis(w, -k, k)
                w.acc.is_pre_active = False
                w.acc.n_pre_samples = k
                w.acc.n_samples += k
                if k > 0:
                    for ht in self._history_tags:
                        if ht.age <= k and ht.map:
                            w.events.append(Tag(k - ht.age, ht.map))

            n_non_pre = 0
            if not w.acc.is_post_active:
                m = n if self.n_max == 0 else min(self.n_max - w.n_values, n)
                if m > 0:
                    w.values.append(chunk[..., :m])
                    w.n_values += m
                    self._fill_axis(w, w.acc.n_samples - w.acc.n_pre_samples, m)
                    w.acc.n_samples += m
                    n_non_pre += m
            else:
                m = (min(w.acc.n_post_remain, n) if self.n_max == 0 else
                     min(self.n_max - w.n_values, w.acc.n_post_remain, n))
                if m > 0:
                    w.values.append(chunk[..., :m])
                    w.n_values += m
                    self._fill_axis(w, w.acc.n_samples - w.acc.n_pre_samples, m)
                    w.acc.update_post(m)
                    n_non_pre += m
                else:
                    w.acc.is_active = False

            if n_non_pre > 0 and tags:
                for t in tags:
                    if t.index < n_non_pre and t.map:
                        w.events.append(
                            Tag(w.acc.n_samples - n_non_pre + t.index, t.map))

        self._update_history(chunk, n, True, tags)

        published = 0
        while self._windows and not self._windows[0].acc.is_active:
            w = self._windows.popleft()
            vals = (np.concatenate(w.values, axis=-1) if w.values
                    else np.zeros(0, chunk.dtype))
            ds = DataSet(
                values=np.atleast_2d(vals),
                axes=[Axis(name="time", unit="s",
                           values=np.concatenate(w.axis) if w.axis
                           else np.zeros(0, np.float64))],
                signals=[SignalMeta(name=self.signal_name,
                                    unit=self.signal_unit,
                                    quantity=self.signal_quantity,
                                    range_min=self.signal_min,
                                    range_max=self.signal_max)],
                timing_events=[w.events],
                meta={"ctx": self.matcher.filter, "n_pre": self.n_pre,
                      "n_post": self.n_post, "n_max": self.n_max},
            )
            if vals.size:
                ds.updated_range(0)
            self.datasets.append(ds)
            published += 1
        if published and self._merged_af:
            self.ds_tags.append(Tag(len(self.datasets) - published,
                                    dict(self._merged_af)))
            self._merged_af.clear()
