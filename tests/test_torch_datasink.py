"""The port's DataSink, pollers and trigger matchers against the JAX
package's: the cases of ``tests/test_datasink_golden.py`` (streaming callbacks
of three arities, blocking and dropping polling, trigger windows, snapshots,
the multiplexed YEAR/MONTH/DAY matcher matrix, the review regressions) and of
``tests/test_trigger_matcher_golden.py`` run through both packages, on the
CPU, give equal chunks, tags and datasets; and ``examples/channelizer.yaml``
with a ``StreamingPoller`` (``tests/test_examples.py``'s case) runs in the port
and agrees with the JAX package. Exact, except the channelizer's dB values
(f32 PFB sums and FFTs: within 1e-3 dB)."""

import dataclasses
import itertools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRIGGER_INDICES = [1001, 1001, 1002, 1003, 1003, 1005, 1007, 10000, 10000, 20000]


def _ns(pkg):
    ds = __import__(pkg.__name__ + ".core.datasink", fromlist=["x"])
    tr = __import__(pkg.__name__ + ".core.trigger", fromlist=["x"])
    tags = __import__(pkg.__name__ + ".core.tags", fromlist=["x"])
    testing = __import__(pkg.__name__ + ".blocks.testing", fromlist=["x"])
    kw = {"device": "cpu"} if pkg is gt else {}
    return SimpleNamespace(
        pkg=pkg, ds=ds, tr=tr, Tag=tags.Tag, Keys=tags.Keys,
        reg=ds.global_data_sink_registry, Q=ds.DataSinkQuery,
        VectorSource=testing.VectorSource, DataSink=ds.DataSink,
        run=lambda g, n: pkg.Scheduler(g, block_len=n, **kw).run_and_wait())


def _both(case):
    return case(_ns(gr)), case(_ns(gt))


def _graph(ns, n, src_tags, dtype=np.float32, **sink_settings):
    g = ns.pkg.Graph()
    src = ns.VectorSource(np.arange(n, dtype=dtype), tags=src_tags)
    sink = ns.DataSink(name="test_sink", signal_name="TestName", **sink_settings)
    g.connect(src, sink)
    return g, sink


def _src_meta(ns):
    K = ns.Keys
    return {K.SIGNAL_NAME: "TestName", K.SIGNAL_UNIT: "TestUnit",
            K.SIGNAL_QUANTITY: "TestQuantity", K.SIGNAL_MIN: -42.0,
            K.SIGNAL_MAX: 42.0}


def _ymd_tags(ns, first, interval, per=1):
    out = []
    for y, m, d in itertools.product((1, 2, 3), (1, 2), (1, 2, 3)):
        for i in range(per):
            out.append(ns.Tag(first, {"YEAR": y + i, "MONTH": m + i, "DAY": d + i}))
        first += interval
    return out


def _tags(tags):
    return [(int(t.index), dict(t.map)) for t in tags]


def _chunk(c):
    return (int(c.abs_index), np.asarray(c.data).tolist(), _tags(c.tags))


def _dataset(ds):
    return (np.asarray(ds.values).tolist(), [_tags(e) for e in ds.timing_events],
            [dataclasses.asdict(s) for s in ds.signals], dict(ds.meta))


def _is_trigger(ns):
    M = ns.tr.MatchResult
    return lambda t: (M.MATCHED if t.map.get(ns.Keys.TRIGGER_NAME) == "TRIGGER"
                      else M.IGNORE)


def test_streaming_callbacks_three_arities():
    def case(ns):
        n, max_chunk = 30005, 1000
        g, sink = _graph(ns, n, [ns.Tag(0, _src_meta(ns))] + _ymd_tags(ns, 0, 1234))
        seen = {1: [], 2: [], 3: []}
        ns.reg.register_streaming_callback(
            ns.Q.sink("test_sink"), max_chunk, lambda d: seen[1].append(d.tolist()))
        ns.reg.register_streaming_callback(
            ns.Q.signal("TestName"), max_chunk,
            lambda d, t: seen[2].append((len(d), _tags(t))))
        ns.reg.register_streaming_callback(
            ns.Q.sink("test_sink"), max_chunk,
            lambda d, t, s: seen[3].append(s is sink))
        ns.run(g, 4096)
        return seen
    j, t = _both(case)
    assert t == j
    assert sum(map(len, t[1])) == 30005 and all(t[3])


@pytest.mark.parametrize("policy, max_chunks", [("BACKPRESSURE", 256), ("DROP", 2)])
def test_polling(policy, max_chunks):
    def case(ns):
        g, sink = _graph(ns, 30005, [ns.Tag(0, _src_meta(ns))]
                         + _ymd_tags(ns, 0, 1234, 2))
        p = ns.reg.get_streaming_poller(
            ns.Q.signal("TestName"), policy=getattr(ns.ds.OverflowPolicy, policy),
            max_chunks=max_chunks)
        ns.run(g, 1024)
        return ([_chunk(c) for c in p.read_all()], p.dropped_sample_count,
                p.dropped_tag_count, p.finished)
    j, t = _both(case)
    assert t == j
    assert sum(len(c[1]) for c in t[0]) + t[1] == 30005


def test_poller_lookups():
    def case(ns):
        out = [ns.reg.get_streaming_poller(ns.Q.sink("no_such_sink")) is None]
        g = ns.pkg.Graph()
        sink = ns.DataSink(name="typed_sink", dtype="float32")
        g.connect(ns.VectorSource(np.arange(100, dtype=np.float32)), sink)
        out.append(ns.reg.get_streaming_poller(ns.Q.sink("typed_sink"),
                                               dtype="float64") is None)
        out.append(ns.reg.get_streaming_poller(ns.Q.sink("typed_sink"),
                                               dtype="float32") is not None)
        ns.run(g, 100)
        out.append(ns.reg.get_streaming_poller(ns.Q.sink("typed_sink")) is None)
        return out
    j, t = _both(case)
    assert t == j == [True, True, True, True]


def _trigger_tags(ns, extra_meta):
    K = ns.Keys
    tags = [ns.Tag(0, dict(_src_meta(ns), **extra_meta))]
    for t, i in enumerate(TRIGGER_INDICES):
        tags.append(ns.Tag(i, {K.TRIGGER_NAME: "TRIGGER", K.TRIGGER_TIME: t}))
    tags += [ns.Tag(21000, {K.TRIGGER_NAME: "NO_TRIGGER1"}),
             ns.Tag(21000, {K.TRIGGER_NAME: "NO_TRIGGER2"}),
             ns.Tag(22000, {K.TRIGGER_NAME: "NO_TRIGGER3"})]
    return tags


def test_trigger_windows():
    def case(ns):
        K = ns.Keys
        g, _ = _graph(ns, 30000, _trigger_tags(ns, {K.SIGNAL_MIN: -2.0,
                                                    K.SIGNAL_MAX: 2.0}))
        p = ns.reg.get_trigger_poller(ns.Q.sink("test_sink"), _is_trigger(ns),
                                      pre=5, post=7, max_windows=64)
        cb = []
        ns.reg.register_trigger_callback(ns.Q.sink("test_sink"), _is_trigger(ns),
                                         5, 7, cb.append)
        ns.run(g, 2048)
        polled = []
        while (ds := p.read(timeout=0.0)) is not None:
            polled.append(_dataset(ds))
        return polled, [_dataset(d) for d in cb]
    j, t = _both(case)
    assert t == j
    assert len(t[0]) == len(TRIGGER_INDICES) and t[0] == t[1]


def test_snapshots():
    def case(ns):
        K = ns.Keys
        g, _ = _graph(ns, 30000, _trigger_tags(
            ns, {K.SAMPLE_RATE: 10000.0, K.SIGNAL_MIN: 0.0, K.SIGNAL_MAX: 29999.0}))
        p = ns.reg.get_snapshot_poller(ns.Q.sink("test_sink"), _is_trigger(ns),
                                       delay_s=0.5, emit="dataset")
        cb = []
        ns.reg.register_snapshot_callback(ns.Q.sink("test_sink"), _is_trigger(ns),
                                          cb.append, delay_s=0.5)
        ns.run(g, 2048)
        return ([_dataset(p.read(timeout=0.0)) for _ in TRIGGER_INDICES],
                [_dataset(d) for d in cb], p.read(timeout=0.0))
    j, t = _both(case)
    assert t == j
    assert [d[0][0][0] for d in t[0]] == [float(i + 5000) for i in TRIGGER_INDICES]


@dataclasses.dataclass
class YmdMatcher:
    """tests/test_datasink_golden.py's stateful matcher (≈ qa_DataSink.cpp:44),
    over either package's MatchResult."""

    M: object
    year: int | None = None
    month: int | None = None
    day: int | None = None
    last_seen: tuple | None = None
    last_matched: bool = False

    def __call__(self, tag):
        if not all(k in tag.map for k in ("YEAR", "MONTH", "DAY")):
            return self.M.IGNORE
        y, m, d = (int(tag.map[k]) for k in ("YEAR", "MONTH", "DAY"))
        ly, lm, ld = self.last_seen if self.last_seen else (None,) * 3

        def same(x, other):
            return other is not None and x == other

        restart = ((self.year == -1 and not same(y, ly))
                   or (self.month == -1 and not same(m, lm))
                   or (self.day == -1 and not same(d, ld)))
        matches = ((self.year is None or self.year == -1 or same(y, self.year))
                   and (self.month is None or self.month == -1 or same(m, self.month))
                   and (self.day is None or self.day == -1 or same(d, self.day)))
        r = self.M.IGNORE
        if not matches:
            r = self.M.NOT_MATCHED
        elif not self.last_matched or restart:
            r = self.M.MATCHED
        self.last_seen = (y, m, d)
        self.last_matched = matches
        return r


def test_multiplexed_matcher_matrix():
    matchers = [(None, -1, None), (-1, None, None), (1, None, None),
                (1, None, 2), (None, None, 1)]

    def case(ns):
        tags = _ymd_tags(ns, 0, 10000)
        n = len(tags) * 10000 + 100000
        g = ns.pkg.Graph()
        sink = ns.DataSink(name="test_sink", signal_name="test signal")
        g.connect(ns.VectorSource(np.arange(n, dtype=np.int32), tags=tags), sink)
        M = ns.tr.MatchResult
        pollers = [ns.reg.get_multiplexed_poller(
            ns.Q.sink("test_sink"), YmdMatcher(M, *m), max_samples=100000,
            max_windows=64) for m in matchers]
        cbs = [[] for _ in matchers]
        for m, r in zip(matchers, cbs):
            ns.reg.register_multiplexed_callback(
                ns.Q.sink("test_sink"), YmdMatcher(M, *m), 100000,
                lambda ds, r=r: r.append((int(ds.values[0, 0]), int(ds.values[0, -1]),
                                          _tags(ds.timing_events[0]))))
        ns.run(g, 8192)
        polled = []
        for p in pollers:
            got = []
            while (ds := p.read(timeout=0.0)) is not None:
                got.append((int(ds.values[0, 0]), int(ds.values[0, -1]),
                            ds.signals[0].name, ds.meta.get("trigger_stop")))
            polled.append(got)
        return polled, cbs
    j, t = _both(case)
    assert t == j
    assert [x[:2] for x in t[0][3]] == [(10000, 19999), (40000, 49999)]


def test_review_regressions():
    def case(ns):
        K = ns.Keys
        out = []
        sink = ns.DataSink(name="meta_sink")
        p = sink.attach(ns.ds.StreamingPoller())
        sink.consume({"in": np.zeros((4,), np.float32)}, {}, 0, 0)
        sink.consume({"in": np.arange(4, dtype=np.float32)}, {}, 4, 4)
        out.append(_chunk(p.read(timeout=0.1)))
        sink.stop()
        sink = ns.DataSink(name="vp_sink")
        got = []
        ns.reg.register_streaming_callback(ns.Q.sink("vp_sink"), 64,
                                           lambda *a: got.append(len(a)))
        ns.reg.register_streaming_callback(
            ns.Q.sink("vp_sink"), 3, lambda data, *, note=None: got.append(
                data.tolist()))
        sink.consume({"in": np.arange(8, dtype=np.float32)},
                     {"in": [ns.Tag(5, {K.TRIGGER_NAME: "x"})]}, 8, 0)
        sink.stop()
        out.append(got)
        return out
    j, t = _both(case)
    assert t == j


FILTERS = ["alarm/room1", "[alarm/room1, alarm/room3]", "[alarm/room1, ^alarm/room3]",
           "[^alarm/room1, ^alarm/room3]", "[^alarm, alarm]", "[alarm/^room1, alarm/^room3]",
           "[^alarm/room1, alarm/room3]", "[alarm/room1]", "[, alarm/room1]",
           "[alarm/room1, alarm/room1]", "/room2"]
TAG_SEQ = [("alarm", "room1"), ("alarm", "room2"), ("other", "room1"),
           ("alarm", "room3"), ("alarm", "room1"), ("other", "room3"),
           ("alarm", "room3"), ("alarm", "room2"), ("other", "room2"),
           ("alarm", "room1")]


@pytest.mark.parametrize("flt", FILTERS)
def test_trigger_matchers(flt):
    def case(ns):
        K = ns.Keys
        m = ns.tr.BasicTriggerNameCtxMatcher(flt)
        st = m.new_state()
        out = [m(None, st).name, m.is_single]
        out += [m(ns.Tag(0, {K.TRIGGER_NAME: a, K.CONTEXT: b,
                             K.TRIGGER_META_INFO: {}}), st).name for a, b in TAG_SEQ]
        return out
    j, t = _both(case)
    assert t == j


@pytest.mark.parametrize("part", ["alarm/kitchen", "^alarm/kitchen", "alarm/^kitchen",
                                  "^alarm/^kitchen", "alarm", "/kitchen",
                                  "alarm/kitchen/cabinet"])
def test_trigger_parser(part):
    def case(ns):
        try:
            return ns.tr._parse_part(part)
        except Exception as e:      # each package's GrError
            return type(e).__name__
    j, t = _both(case)
    assert t == j


def test_channelizer_example_with_poller():
    """tests/test_examples.py:44-56 in the port, against the JAX package."""
    src = (ROOT / "examples" / "channelizer.yaml").read_text()
    out = []
    for ns in (_ns(gr), _ns(gt)):
        g = ns.pkg.load_grc(src)
        p = ns.reg.get_streaming_poller("channel5_power")
        kw = {"device": "cpu"} if ns.pkg is gt else {}
        ns.pkg.Scheduler(g, block_len=65536, sample_rate=16e6, **kw).run_and_wait(n_steps=3)
        chunks = p.read_all()
        assert chunks
        out.append((np.concatenate([c.data for c in chunks], axis=-1),
                    [(c.abs_index, _tags(c.tags)) for c in chunks]))
    (dj, tj), (dt, tt) = out
    # tone at 5 MHz = channel 5 of 16 @ 16 MHz → strong dB level
    assert np.median(dt[2000:]) > -10.0
    assert tt == tj
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-3)
