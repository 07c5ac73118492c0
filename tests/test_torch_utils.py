"""The port's utils/: formatting (tests/test_core_foundations.py's cases,
in both packages), the memory monitor, the micro-benchmark harness
(tests/test_pmt_utils_merge.py's cases) and the block scaffolder (the three
kinds, whose generated tests run green on the CPU, and its refusals, with
the JAX package's messages)."""

import runpy
import time
import types

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.utils import formatting as jfmt
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.utils import formatting as tfmt
from gnuradio4_tpu_torch.utils import benchmark as bm
from gnuradio4_tpu_torch.utils import memory
from gnuradio4_tpu_torch.utils.benchmark import (MarkerMap, PerfCounters,
                                                 benchmark)
from gnuradio4_tpu_torch.utils.scaffold import new_block

FMT = {gr: jfmt, gt: tfmt}


@pytest.mark.parametrize("pkg", [gr, gt], ids=["jax", "torch"])
def test_si_samples_duration(pkg):
    fmt = FMT[pkg]
    assert fmt.si(48000.0, "Hz") == "48 kHz"
    assert fmt.si(6.87367e9, "sps", digits=3) == "6.87 Gsps"
    assert fmt.si(-2.5e-6, "s") == "-2.5 µs"
    assert fmt.si(0.0, "V") == "0 V"
    assert fmt.samples(1 << 16) == "64 ki"
    assert fmt.samples(3 << 20) == "3 Mi"
    assert fmt.samples(100) == "100"
    assert fmt.duration(3.1e-6) == "3.1 µs"


def _rx_graph(pkg):
    g = pkg.Graph(name="rx")
    src = g.emplace("SignalGenerator", n_samples=128)
    src.name = "src"
    fir = g.emplace("FirFilter", taps=(1.0, 0.5), decim=4)
    fir.name = "fir"
    snk = pkg.global_registry.create("NullSink")
    snk.name = "out"
    g.connect_chain(src, fir, snk)
    g.resolve_rates(1 << 16, 48000.0)
    return g, fir


def test_tag_edge_block_graph_match_the_jax_package():
    from gnuradio4_tpu.core.tags import Keys as JKeys, Tag as JTag
    from gnuradio4_tpu_torch.core.tags import Keys, Tag
    t = Tag(1024, {Keys.SAMPLE_RATE: 48000.0, Keys.TRIGGER_NAME: "T0"})
    s = tfmt.tag(t)
    assert s.startswith("@1024") and "48 kHz" in s and "T0" in s
    assert s == jfmt.tag(JTag(1024, {JKeys.SAMPLE_RATE: 48000.0,
                                     JKeys.TRIGGER_NAME: "T0"}))
    (g, fir), (jg, jfir) = _rx_graph(gt), _rx_graph(gr)
    es = tfmt.edge(g.edges[0])
    assert "src.out ─▶ fir.in" in es and "samp/step" in es and "kHz" in es
    assert es == jfmt.edge(jg.edges[0])
    assert "fir <FirFilter>" in tfmt.block(fir) and "ratio 1/4" in tfmt.block(fir)
    assert tfmt.block(fir) == jfmt.block(jfir)
    gs = tfmt.graph_summary(g)
    assert gs.startswith("rx:") and "3 blocks" in gs
    assert gs == jfmt.graph_summary(jg)


def test_value_rendering_arrays_and_tensors():
    assert tfmt.value(3.0) == "3"
    a = np.zeros((2, 1000), np.float32)
    assert "array(float32[2×1000]" in tfmt.value(a)
    assert tfmt.value(torch.from_numpy(a)) == tfmt.value(a) == jfmt.value(a)
    small = np.asarray([1.0, 2.5], np.float32)
    assert tfmt.value(torch.from_numpy(small)) == jfmt.value(small)
    assert tfmt.value({"a": 1.5, "b": "x"}) == "{a=1.5, b='x'}"


def test_memory_monitor_and_rss():
    assert memory.rss_bytes() > 0
    # no card here: the device stats are empty, as the JAX package's are
    # without device stats
    assert memory.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert memory.device_memory_stats() == {}
    mon = memory.MemoryMonitor(interval_s=0.01, maxlen=5).start()
    time.sleep(0.1)
    mon.stop()
    assert 1 <= len(mon.samples) <= 5
    assert mon.peak_rss >= min(s for _, s in mon.samples) > 0
    assert mon._thread is not None and not mon._thread.is_alive()
    assert gt.utils.MemoryMonitor is memory.MemoryMonitor


def test_benchmark_basic_and_autocalibration():
    acc = []
    r = benchmark(lambda: acc.append(1), n=1000, warmup=1, name="append")
    assert r.n_ops == 1000 and len(acc) >= 1000
    assert r.wall_s > 0 and r.ops_per_s > 0
    assert "append" in str(r) and "ops/s" in str(r)
    r = benchmark(lambda: sum(range(100)), min_time=0.05, name="sum")
    assert r.n_ops >= 1 and r.wall_s > 0
    assert r.ops_per_s == pytest.approx(r.n_ops / r.wall_s)


def test_benchmark_autocalibrates_from_its_probe(monkeypatch):
    """``n`` follows from the timed probe: on a clock that advances 2^-10 s
    a call, the probe stops at 16 calls (2^-6 s >= min_time/8) and the run
    takes min_time (2^-4 s), exactly. The wall-clock form of this check
    depends on the machine's load."""
    now = [0.0]

    def call():
        now[0] += 2.0 ** -10

    monkeypatch.setattr(bm, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0], process_time=time.process_time))
    r = benchmark(call, min_time=2.0 ** -4, warmup=0, counters=False)
    assert r.n_ops == 64 and r.wall_s == 2.0 ** -4


def test_counters_graceful_when_unavailable():
    pc = PerfCounters()
    try:
        r = benchmark(lambda: None, n=100)
        if pc.available:
            assert r.counters.get("cycles", 0) > 0
            assert r.ipc is None or r.ipc > 0
        else:
            assert r.counters == {}
            assert r.cycles_per_op is None and r.ipc is None
    finally:
        pc.close()


def test_marker_map():
    mm = MarkerMap()
    mm.mark("a"); time.sleep(0.01); mm.mark("b"); mm.mark("c")
    iv = dict(mm.intervals())
    assert iv["a→b"] >= 0.009 and iv["b→c"] < 0.01
    assert mm.total_s() >= 0.009
    mm.clear()
    assert mm.intervals() == [] and mm.total_s() == 0.0


@pytest.mark.parametrize("kind,name", [
    ("device", "MyGainStage"),
    ("sink", "MyProbeSink"),
    ("source", "MyRampSource"),
])
def test_generated_pair_runs(tmp_path, kind, name):
    mod_path, test_path = new_block(name, kind=kind, out_dir=str(tmp_path))
    text = open(mod_path).read() + open(test_path).read()
    assert "gnuradio4_tpu_torch" in text and "jax" not in text
    ns = runpy.run_path(test_path)
    fns = [v for k, v in ns.items() if k.startswith("test_") and callable(v)]
    assert fns, "generated test file defines no test function"
    for fn in fns:
        fn()


def test_refuses_overwrite_and_bad_names(tmp_path):
    new_block("Once", out_dir=str(tmp_path))
    with pytest.raises(GrError, match="refusing to overwrite"):
        new_block("Once", out_dir=str(tmp_path))
    with pytest.raises(GrError, match="CamelCase"):
        new_block("snake_case", out_dir=str(tmp_path))
    with pytest.raises(GrError, match="unknown kind 'mystery'"):
        new_block("Fine", kind="mystery", out_dir=str(tmp_path))
