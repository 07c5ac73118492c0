"""The port's ``blocks/acquisition.py``, ``core/stream_capture.py``,
``core/sync_engine.py`` and the scheduler's tag-array hook against the JAX
package's, on the CPU: qa_StreamToDataSet's capture matrix
(``tests/test_stream_to_dataset_golden.py``) and the chunking fuzz of
``tests/test_capture_fuzz.py`` through both packages; the six acquisition
types; TriggerGate over a step with tags followed by steps without, under
``max_tags_per_step`` and batching; and the slice as a whole — the
qa_TriggerBlocks chain (``tests/test_trigger_blocks_golden.py``) and the
acquisition chain of ``chip_smoke.py`` phase 25(a) at 10 kHz.

Tolerances: the capture engines, the gates and the host blocks are exact
(equal samples, tags and DataSets). The qa_TriggerBlocks chain is bit for bit
(its ramps are exact, ``tests/test_torch_misc_blocks.py``), so its edge tags
are equal in index and within ``EDGE_OFFSET_ATOL`` = 1e-9 in offset. The
acquisition chain adds a Savitzky-Golay FIR, whose float32 sums differ in
order between the packages (``F32_ATOL`` = 1e-5 · max(1, |y|) per sample):
its edges are equal in index, their offsets within ``CHAIN_OFFSET_ATOL`` =
1e-6 s · (1 kHz / fs), and its DataSets within ``F32_ATOL``."""

from importlib import import_module

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

PKGS = (gt, gr)
F32_ATOL = 1e-5
EDGE_OFFSET_ATOL = 1e-9
P1 = "FAIR.SELECTOR.C=1:S=1:P=1"
P2 = "FAIR.SELECTOR.C=1:S=1:P=2"
EXCLUDING = f"[CMD_BP_START/{P1}, CMD_BP_START/{P2}]"
INCLUDING = f"[CMD_BP_START/{P1}, CMD_BP_START/^{P2}]"
SINGLE = "CMD_DIAG_TRIGGER1"


def _m(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw.setdefault("device", "cpu")
    return pkg.Scheduler(g, **kw)


def _tags(tags):
    return [(t.index, dict(t.map)) for t in tags]


# -- the capture matrix (qa_StreamToDataSet.cpp) -----------------------------------

def _qa_tags(pkg, stream: bool):
    """qa_StreamToDataSet.cpp:187 / :321's stimulus, with the global trigger
    time counter."""
    Tag = _m(pkg, "core.tags").Tag
    clock = iter(range(100))

    def gen(i, name, ctx=""):
        return Tag(i, {"trigger_name": name, "trigger_time": next(clock),
                       "trigger_offset": 0.0, "context": ctx,
                       "trigger_meta_info": {}})
    start = lambda i: gen(i, "CMD_BP_START", P1)
    stop = lambda i: gen(i, "CMD_BP_START", P2)
    single = lambda i: gen(i, SINGLE)
    no = lambda i: gen(i, "NO_TRIGGER")
    head = [Tag(0, {"sample_rate": 1000.0})]
    if stream:
        return head + [no(2), single(4), start(5), single(8), stop(10),
                       single(12), start(15), stop(20), single(22)]
    return head + [no(2), single(4), no(5), start(5), single(8), stop(10),
                   single(12), start(15), start(20), stop(25), single(27),
                   stop(30), single(32)]


def _capture(pkg, btype, stream, block_len, **settings):
    g = pkg.Graph()
    src = pkg.global_registry.create("VectorSource",
                                     data=np.arange(50, dtype=np.float32),
                                     tags=_qa_tags(pkg, stream))
    snk = pkg.global_registry.create(btype, **settings)
    g.connect(src, snk)
    _sched(pkg, g, block_len=block_len).run_and_wait()
    return snk


def _ds_equal(a, b):
    np.testing.assert_array_equal(a.values, b.values)
    assert len(a.axes) == len(b.axes)
    for x, y in zip(a.axes, b.axes):
        np.testing.assert_array_equal(x.values, y.values)
        assert (x.name, x.unit) == (y.name, y.unit)
    assert [_tags(e) for e in a.timing_events] == [_tags(e) for e in b.timing_events]
    np.testing.assert_equal(   # NaN ranges compare equal
        [(s.name, s.unit, s.quantity, s.range_min, s.range_max)
         for s in a.signals],
        [(s.name, s.unit, s.quantity, s.range_min, s.range_max)
         for s in b.signals])
    assert a.meta == b.meta


@pytest.mark.parametrize("block_len", [50, 16])
@pytest.mark.parametrize("pre_post", [(0, 0), (2, 2)])
@pytest.mark.parametrize("filt", [EXCLUDING, INCLUDING, SINGLE])
def test_stream_filter_sink_matrix(filt, pre_post, block_len):
    """StreamFilterSink (stream out): the compacted samples and the
    re-indexed, merged tags equal the JAX package's."""
    kw = dict(filter=filt, n_pre=pre_post[0], n_post=pre_post[1])
    if filt == SINGLE and pre_post == (0, 0):
        kw["n_post"] = 3
    st, sj = (_capture(p, "StreamFilterSink", True, block_len, **kw) for p in PKGS)
    np.testing.assert_array_equal(st.data(), sj.data())
    assert _tags(st.tags) == _tags(sj.tags)
    assert st.data().size > 0


@pytest.mark.parametrize("block_len", [50, 16])
@pytest.mark.parametrize("n_max", [100000, 3])
@pytest.mark.parametrize("pre_post", [(0, 0), (2, 2)])
@pytest.mark.parametrize("filt", [EXCLUDING, INCLUDING, SINGLE])
def test_stream_to_dataset_matrix(filt, pre_post, n_max, block_len):
    """StreamToDataSet (DataSet out, mode auto): overlapping FIFO-paired
    windows, n_max caps, pre/post samples: every DataSet (values, time axis,
    timing events, signal meta) and the merged auto-forward tags equal."""
    pre, post = pre_post
    if filt == SINGLE and post == 0:
        post = 3
    if n_max < pre + post:
        n_max = pre + post + 1
    kw = dict(filter=filt, n_pre=pre, n_post=post, n_max=n_max)
    st, sj = (_capture(p, "StreamToDataSet", False, block_len, **kw) for p in PKGS)
    dt, dj = st.read_all(), sj.read_all()
    assert len(dt) == len(dj) > 0
    for a, b in zip(dt, dj):
        _ds_equal(a, b)
    assert _tags(st.out_tags) == _tags(sj.out_tags)


def test_capture_settings_errors_match():
    for pkg in PKGS:
        with pytest.raises(_m(pkg, "core.errors").GrError, match="ill-formed"):
            pkg.global_registry.create("StreamToDataSet", filter=SINGLE, n_pre=5,
                                       n_post=5, n_max=4)


# -- the engines' chunking fuzz (tests/test_capture_fuzz.py) -------------------------

FUZZ_FILTERS = ["[START/CTX.A, STOP/CTX.B]", "[START/CTX.A, STOP/^CTX.B]",
                "START", "[START/^CTX.A, STOP/CTX.B]"]


def _random_tags(pkg, rng, n, n_tags):
    Tag = _m(pkg, "core.tags").Tag
    idxs = sorted(rng.choice(n, size=n_tags, replace=False).tolist())
    names = rng.choice(["START", "STOP", "OTHER"], size=n_tags)
    ctxs = rng.choice(["CTX.A", "CTX.B", ""], size=n_tags)
    return [Tag(int(i), {"trigger_name": str(a), "trigger_time": int(k),
                         "context": str(c)})
            for k, (i, a, c) in enumerate(zip(idxs, names, ctxs))]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("filt", FUZZ_FILTERS)
@pytest.mark.parametrize("stream_out", [True, False])
def test_capture_engine_fuzz(filt, seed, stream_out):
    """The same random tags over 400 samples fed in chunks of 1, 7 and 64 to
    both packages' CaptureEngine (history, n_max, pre/post): equal outputs."""
    rng = np.random.default_rng(seed + (0 if stream_out else 100))
    n = 400
    data = np.arange(n, dtype=np.float32)
    pre, post = int(rng.integers(0, 5)), int(rng.integers(0, 5))
    n_max = 0 if stream_out else int(rng.choice([0, 16]))
    if n_max and pre + post > n_max:
        n_max = 0
    state = rng.bit_generator.state
    for chunk in (1, 7, 64):
        engines = []
        for pkg in PKGS:
            rng.bit_generator.state = state
            tags = _random_tags(pkg, rng, n, 24)
            eng = _m(pkg, "core.stream_capture").CaptureEngine(
                filt, n_pre=pre, n_post=post, n_max=n_max, stream_out=stream_out)
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                eng.feed(data[lo:hi], [t.shifted(-lo) for t in tags
                                       if lo <= t.index < hi])
            engines.append(eng)
        et, ej = engines
        if stream_out:
            np.testing.assert_array_equal(et.data(), ej.data())
            assert _tags(et.out_tags) == _tags(ej.out_tags)
        else:
            assert len(et.datasets) == len(ej.datasets)
            for a, b in zip(et.datasets, ej.datasets):
                _ds_equal(a, b)
            assert _tags(et.ds_tags) == _tags(ej.ds_tags)


@pytest.mark.parametrize("seed", range(4))
def test_sync_engine_fuzz(seed):
    """tests/test_capture_fuzz.py's SyncEngine case through both packages:
    equal outputs, tags, drops and buffers; samples conserved."""
    engines = []
    for pkg in PKGS:
        Tag = _m(pkg, "core.tags").Tag
        rng = np.random.default_rng(200 + seed)
        n_ports = int(rng.integers(2, 4))
        n = 2000
        eng = _m(pkg, "core.sync_engine").SyncEngine(n_ports, tolerance=3,
                                                     max_history_size=400)
        port_tags = []
        for p in range(n_ports):
            tags, pos = [], 0
            for t in (100, 200, 300, 400):
                if rng.random() < 0.8:
                    pos += int(rng.integers(50, 400))
                    if pos >= n:
                        break
                    tags.append(Tag(pos, {"trigger_name": "T", "trigger_time":
                                          t + int(rng.integers(-1, 2))}))
            port_tags.append(tags)
        chunk = int(rng.choice([50, 171, 500]))
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            for p in range(n_ports):
                eng.feed(p, np.arange(lo, hi, dtype=np.int32),
                         [t.shifted(-lo) for t in port_tags[p]
                          if lo <= t.index < hi], pump=False)
            eng.pump()
        engines.append(eng)
    et, ej = engines
    assert et.n == ej.n and et.out_n == ej.out_n and et._dropped == ej._dropped
    assert et._buf_n == ej._buf_n
    for p in range(et.n):
        np.testing.assert_array_equal(et.data(p), ej.data(p))
        assert _tags(et.out_tags[p]) == _tags(ej.out_tags[p])
        dropped = sum(m.get("n_dropped_samples", 0) for _, m in _tags(et.out_tags[p]))
        assert et.out_n[p] + dropped + et._dropped[p] + et._buf_n[p] == 2000


# -- the six types through the scheduler ------------------------------------------

@pytest.mark.parametrize("block_len", [12, 5])
def test_sync_sink(block_len):
    """qa_SyncBlock's basic case (tests/test_syncblock_golden.py) through the
    scheduler in both packages: equal aligned streams and tags."""
    vals = [[1, 0, 1, 2, 3, 0, 1, 2, 3, 4, 0, 1],
            [1, 2, 0, 1, 2, 3, 4, 0, 1, 2, 3, 0, 1, 2]]
    times = [[(1, 100), (5, 200), (10, 300)], [(2, 101), (7, 199), (11, 302)]]
    out = []
    for pkg in PKGS:
        Tag = _m(pkg, "core.tags").Tag
        g = pkg.Graph()
        snk = pkg.global_registry.create("SyncSink", n_ports=2, tolerance=3)
        for p in range(2):
            src = pkg.global_registry.create(
                "VectorSource", data=np.asarray(vals[p], np.float32),
                tags=[Tag(i, {"trigger_name": "TriggerName", "trigger_time": t})
                      for i, t in times[p]])
            g.connect(src, snk[f"in{p}"])
        _sched(pkg, g, block_len=block_len).run_and_wait()
        out.append([(np.asarray(snk.data(p)), _tags(snk.out_tags(p)))
                    for p in range(2)])
    for (dt, tt), (dj, tj) in zip(*out):
        np.testing.assert_array_equal(dt, dj)
        assert tt == tj
    assert out[0][0][0].size > 0


@pytest.mark.parametrize("mode, settings", [
    ("triggered", dict(filter=SINGLE, n_pre=2, n_post=5)),
    ("multiplexed", dict(filter=f"CMD_BP_START/{P1}",
                         filter_stop=f"CMD_BP_START/{P2}")),
    ("continuous", dict(n_length=7)),
])
@pytest.mark.parametrize("block_len", [50, 16])
def test_stream_to_dataset_legacy_modes(mode, settings, block_len):
    st, sj = (_capture(p, "StreamToDataSet", False, block_len, mode=mode,
                       **settings) for p in PKGS)
    dt, dj = st.read_all(), sj.read_all()
    assert len(dt) == len(dj) > 0
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.values, b.values)
        assert [_tags(e) for e in a.timing_events] == \
            [_tags(e) for e in b.timing_events]


def test_dataset_sink_and_savgol_dataset_filter():
    """DataSetSink (continuous windows) and SavitzkyGolayDataSetFilter (the
    S-G transform on every window): equal DataSets."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    for btype, kw in (("DataSetSink", dict(n_length=1000)),
                      ("SavitzkyGolayDataSetFilter",
                       dict(n_length=1000, window_size=21, poly_order=3)),
                      ("SavitzkyGolayDataSetFilter",
                       dict(n_length=512, window_size=11, poly_order=4,
                            deriv_order=1, boundary_policy="Replicate"))):
        res = []
        for pkg in PKGS:
            g = pkg.Graph()
            src = pkg.global_registry.create("VectorSource", data=x)
            snk = pkg.global_registry.create(btype, **kw)
            g.connect(src, snk)
            _sched(pkg, g, block_len=700).run_and_wait()
            res.append(snk.read_all())
        assert len(res[0]) == len(res[1]) == 4096 // kw["n_length"]
        for a, b in zip(*res):
            np.testing.assert_array_equal(a.values, b.values)


# -- TriggerGate and the tag-array hook ---------------------------------------------

def _gate(pkg, tags, n, block_len, *, dtype=np.float32, sched_kw=None,
          **settings):
    Tag = _m(pkg, "core.tags").Tag
    g = pkg.Graph()
    x = np.arange(1, n + 1).astype(dtype)
    src = pkg.global_registry.create(
        "VectorSource", data=x, tags=[Tag(i, {"trigger_name": nm})
                                      for i, nm in tags])
    gate = pkg.global_registry.create("TriggerGate", **settings)
    snk = pkg.global_registry.create("VectorSink")
    g.connect_chain(src, gate, snk)
    s = _sched(pkg, g, block_len=block_len, pipeline_depth=1,
               **(sched_kw or {}))
    s.run_and_wait()
    return np.asarray(snk.data()), x, s._states[gate.unique_name]


@pytest.mark.parametrize("sched_kw", [{}, {"batch_steps": 4}, {"batch_steps": 2}])
@pytest.mark.parametrize("case", [
    # tests/test_domains_tagarrays_wait.py's windows, a filtered tag
    (dict(filter="T", n_pre=10, n_post=50),
     [(100, "T"), (500, "T"), (1000, "X")], 2048, 256, [(90, 150), (490, 550)]),
    # a window carried across the step boundary
    (dict(filter="T", n_post=100), [(250, "T")], 1024, 256, [(250, 350)]),
    # a step with a tag, then steps without: nothing reopens
    (dict(filter="T", n_post=20), [(30, "T")], 1024, 256, [(30, 50)]),
    # overlapping windows, a pre window cut at the step start, every trigger
    (dict(n_pre=40, n_post=300), [(20, "A"), (100, "B"), (700, "C")], 1024, 256,
     [(0, 400), (660, 1000)]),
])
def test_trigger_gate_windows(case, sched_kw):
    settings, tags, n, block_len, windows = case
    yt, x, st = _gate(gt, tags, n, block_len, sched_kw=sched_kw, **settings)
    yj, _, sj = _gate(gr, tags, n, block_len, sched_kw=sched_kw, **settings)
    np.testing.assert_array_equal(yt, yj)
    assert int(st) == int(np.asarray(sj)) and st.dtype == torch.int32
    expect = np.zeros_like(x)
    for lo, hi in windows:
        expect[lo:hi] = x[lo:hi]
    np.testing.assert_array_equal(yt, expect)


def test_trigger_gate_is_not_on_the_fast_tag_path():
    """A WANTS_TAG_ARRAYS block is walked every step: a step without tags
    clears the tags of the step before (else TriggerGate would reopen the
    window at the same index). A stock block stays on the fast path."""
    g = gt.Graph()
    src = gt.global_registry.create("VectorSource", data=np.ones(64, np.float32))
    mul = gt.global_registry.create("MultiplyConst", value=2.0)
    gate = gt.global_registry.create("TriggerGate")
    g.connect_chain(src, mul, gate, gt.global_registry.create("VectorSink"))
    s = gt.Scheduler(g, block_len=16, device="cpu")
    s.init()
    plan = {uname: fast for _b, uname, _k, fast, *_ in s.compiled.tag_plan()}
    assert plan[gate.unique_name] is False and plan[mul.unique_name] is True


@pytest.mark.parametrize("pkg", PKGS, ids=["port", "jax"])
def test_max_tags_per_step_is_the_capacity(pkg):
    """More tags than ``max_tags_per_step``: the first ``capacity`` gate, as
    in tests/test_domains_tagarrays_wait.py."""
    tags = [(i * 100, "T") for i in range(8)]
    y, _, _ = _gate(pkg, tags, 1024, 1024, filter="T", n_post=10,
                    sched_kw={"max_tags_per_step": 4})
    assert y[:10].all() and y[300:310].all() and not y[400:410].any()
    if pkg is gt:
        s = gt.Scheduler(gt.Graph(), block_len=8, device="cpu")
        assert s.max_tags_per_step == 64


def test_trigger_gate_complex_multichannel():
    """A [2, T] complex stream gates on both channels (the runs are copied
    whole); equal to the JAX package's."""
    out = []
    for pkg in PKGS:
        Tag = _m(pkg, "core.tags").Tag
        g = pkg.Graph()
        x = (np.arange(2 * 600).reshape(2, 600) * (1 + 1j)).astype(np.complex64)
        src = pkg.global_registry.create("VectorSource", data=x,
                                         tags=[Tag(150, {"trigger_name": "T"})])
        gate = pkg.global_registry.create("TriggerGate", n_pre=5, n_post=200)
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(src, gate, snk)
        _sched(pkg, g, block_len=200).run_and_wait()
        out.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(out[0], out[1])
    assert np.count_nonzero(out[0][0]) == 205


# -- the slice as a whole -------------------------------------------------------------

CTX = [f"FAIR.SELECTOR.C=1:S=1:P={i}" for i in range(5)]


def trigger_chain(pkg, fs, block_len, n_samples, *, interpolation="basic_linear",
                  cycles=1, savgol=False, tag_sink=False, gate_name=None):
    """qa_TriggerBlocks' timeline (tests/test_trigger_blocks_golden.py:23):
    ClockSource (CMD_BP_START at k + {0, 0.1, 0.4, 0.5, 0.8} s per cycle k)
    → FunctionGenerator(clk_in) with the five per-context segments → [S-G
    (31, 3) →] SchmittTrigger(0.6 ± 0.1, pass, edge tags) → TagSink, or
    (phase 25(a)) → StreamToDataSet([MY_RISING_EDGE, MY_FALLING_EDGE]) and
    TriggerGate(CMD_BP_START, n_post fs/20) → VectorSink; a TagSink on the
    Schmitt block's output in both forms."""
    misc = _m(pkg, "blocks.misc")
    SettingsCtx = _m(pkg, "core.settings").SettingsCtx
    Keys = _m(pkg, "core.tags").Keys
    reg = pkg.global_registry
    g = pkg.Graph()
    times = [k + dt for k in range(cycles) for dt in (0.0, 0.1, 0.4, 0.5, 0.8)]
    clock = misc.ClockSource(
        sample_rate=fs, n_samples=n_samples, tag_times=times,
        tag_values=[{Keys.TRIGGER_NAME: "CMD_BP_START", Keys.CONTEXT: c}
                    for c in CTX * cycles])
    fg = misc.FunctionGenerator(sample_rate=fs, start_value=0.1)
    for c, s in zip(CTX, (
            {"signal_type": "Const", "start_value": 0.1},
            {"signal_type": "ParabolicRamp", "start_value": 0.1,
             "final_value": 1.1, "duration": 0.3, "round_off_time": 0.02},
            {"signal_type": "Const", "start_value": 1.1},
            {"signal_type": "ParabolicRamp", "start_value": 1.1,
             "final_value": 0.1, "duration": 0.3, "round_off_time": 0.02},
            {"signal_type": "Const", "start_value": 0.1})):
        fg.settings.set(s, ctx=SettingsCtx(context=c))
    schmitt = misc.SchmittTrigger(
        threshold=0.1, offset=0.6, output="pass",
        trigger_name_rising_edge="MY_RISING_EDGE",
        trigger_name_falling_edge="MY_FALLING_EDGE", interpolation=interpolation)
    g.connect(clock, fg, dst_port="clk_in")
    if savgol:
        sg = reg.create("SavitzkyGolayFilter", window=31, poly_order=3)
        g.connect_chain(fg, sg, schmitt)
    else:
        g.connect(fg, schmitt)
    sinks = {"tags": reg.create("TagSink")}
    g.connect(schmitt, sinks["tags"])
    if not tag_sink:
        sinks["s2d"] = reg.create("StreamToDataSet",
                                  filter="[MY_RISING_EDGE, MY_FALLING_EDGE]",
                                  sample_rate_hint=fs)
        sinks["gate"] = reg.create("TriggerGate", filter="CMD_BP_START",
                                   n_post=int(fs / 20))
        sinks["gated"] = reg.create("VectorSink")
        g.connect(schmitt, sinks["s2d"])
        g.connect_chain(schmitt, sinks["gate"], sinks["gated"])
    return g, sinks


def _edges(tags):
    return [(i, m) for i, m in tags
            if m.get("trigger_name") in ("MY_RISING_EDGE", "MY_FALLING_EDGE")]


@pytest.mark.parametrize("interpolation", ["none", "basic_linear", "regression",
                                           "polynomial"])
@pytest.mark.parametrize("block_len", [100, 50])
def test_qa_trigger_blocks_chain(interpolation, block_len):
    """The qa_TriggerBlocks chain through both packages: the waveform bit for
    bit, every tag equal in index and map but the edges' offsets, which agree
    within ``EDGE_OFFSET_ATOL``; the JAX test's edge positions."""
    res = []
    for pkg in PKGS:
        g, sinks = trigger_chain(pkg, 1000.0, block_len, 1000,
                                 interpolation=interpolation, tag_sink=True)
        _sched(pkg, g, block_len=block_len, sample_rate=1000.0).run_and_wait()
        res.append((np.asarray(sinks["tags"].data()), _tags(sinks["tags"].tags)))
    (yt, tt), (yj, tj) = res
    np.testing.assert_array_equal(yt, yj)
    assert len(tt) == len(tj) == 8
    for (it, mt), (ij, mj) in zip(tt, tj):
        assert it == ij and set(mt) == set(mj)
        for k in mt:
            if k == "trigger_offset":
                assert abs(mt[k] - mj[k]) <= EDGE_OFFSET_ATOL
            else:
                assert mt[k] == mj[k], k
    want = {"none": (278, 678)}.get(interpolation, (250, 650))
    edges = _edges(tt)
    assert [m["trigger_name"] for _, m in edges] == ["MY_RISING_EDGE",
                                                     "MY_FALLING_EDGE"]
    assert all(abs(i - w) <= 2 for (i, _), w in zip(edges, want))


ACQ_FS = 10000.0
ACQ_BLOCK_LEN = 1000
ACQ_STEPS = 20
SG_DELAY = 15          # the 31-tap S-G filter's group delay


def edge_positions(tags, fs):
    """(name, index + offset·fs) of each edge tag."""
    return [(m["trigger_name"], i + m["trigger_offset"] * fs)
            for i, m in _edges(tags)]


def edge_position_atol(y_a, y_b, positions, half_band=0.1):
    """How far two float32 runs of the chain may place an edge apart.
    ``basic_linear`` places the band's midpoint crossing by extrapolating
    the two samples around the threshold crossing (``half_band`` away) with
    their difference d, the input's slope per sample: inputs that differ by
    dy move it by up to dy/d + 2·half_band·dy/d². Plus 1e-6 sample. The
    timeline's edges fall on a sample (0.25 s and 0.65 s of each cycle), so
    such a move may also change an edge's index by one, with its offset."""
    dy = float(np.max(np.abs(y_a.astype(np.float64) - y_b)))
    d = min(abs(float(y_a[int(p) + 1]) - float(y_a[int(p)])) for p in positions)
    return dy / d + 2.0 * half_band * dy / d ** 2 + 1e-6


def test_acquisition_chain_both_packages():
    """chip_smoke.py phase 25(a)'s chain at fs 10 kHz, block_len 1000, 20
    steps (two 1 s cycles) in both packages: the Schmitt block's input (the
    S-G output) within ``F32_ATOL``; each edge at 0.25 and 0.65 s of its
    cycle plus the S-G delay (± 2 samples), the packages' edge positions
    within ``edge_position_atol``; two DataSets of 0.4 s (± 3 samples) per
    package whose samples agree within ``F32_ATOL`` where their spans
    overlap; the gate passes exactly fs/20 samples after each of the ten
    CMD_BP_START tags (its nonzero pattern equal, its samples within
    ``F32_ATOL``)."""
    res = {}
    for pkg in PKGS:
        g, sinks = trigger_chain(pkg, ACQ_FS, ACQ_BLOCK_LEN,
                                 ACQ_STEPS * ACQ_BLOCK_LEN, cycles=2, savgol=True)
        _sched(pkg, g, block_len=ACQ_BLOCK_LEN, sample_rate=ACQ_FS).run_and_wait()
        res[pkg] = (np.asarray(sinks["tags"].data()), _tags(sinks["tags"].tags),
                    sinks["s2d"].read_all(), np.asarray(sinks["gated"].data()))
    (xt, tt, dt, yt), (xj, tj, dj, yj) = res[gt], res[gr]
    d = np.abs(xt - xj)
    assert xt.shape == xj.shape and np.all(d <= F32_ATOL * np.maximum(1.0, np.abs(xj)))
    et, ej = edge_positions(tt, ACQ_FS), edge_positions(tj, ACQ_FS)
    assert [n for n, _ in et] == [n for n, _ in ej] == \
        ["MY_RISING_EDGE", "MY_FALLING_EDGE"] * 2
    want = [(k + t) * ACQ_FS + SG_DELAY for k in (0, 1) for t in (0.25, 0.65)]
    assert all(abs(p - w) <= 2 for (_, p), w in zip(et, want)), et
    atol = edge_position_atol(xt, xj, [p for _, p in ej])
    assert all(abs(a - b) <= atol for (_, a), (_, b) in zip(et, ej)), (et, ej, atol)
    rises_t = [i for i, m in _edges(tt) if m["trigger_name"] == "MY_RISING_EDGE"]
    rises_j = [i for i, m in _edges(tj) if m["trigger_name"] == "MY_RISING_EDGE"]
    assert len(dt) == len(dj) == 2
    for a, b, rt, rj in zip(dt, dj, rises_t, rises_j):
        for ds in (a, b):
            assert abs(ds.values.shape[-1] - 0.4 * ACQ_FS) <= 3
        lo = max(rt, rj)
        hi = min(rt + a.values.shape[-1], rj + b.values.shape[-1])
        va, vb = a.values[0, lo - rt:hi - rt], b.values[0, lo - rj:hi - rj]
        assert hi - lo >= 0.4 * ACQ_FS - 3
        assert np.all(np.abs(va - vb) <= F32_ATOL * np.maximum(1.0, np.abs(vb)))
    n_post = int(ACQ_FS / 20)
    mask = np.zeros(ACQ_STEPS * ACQ_BLOCK_LEN, bool)
    for k in (0, 1):
        for t in (0.0, 0.1, 0.4, 0.5, 0.8):
            i = int(round((k + t) * ACQ_FS))
            mask[i:i + n_post] = True
    np.testing.assert_array_equal(yt != 0, mask)
    np.testing.assert_array_equal(yj != 0, mask)
    np.testing.assert_array_equal(yt[mask], xt[mask])
