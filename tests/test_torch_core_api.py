"""The port's core API against the JAX package's, on the CPU: the graph's
adjacency and its source/sink blocks, the profiler's full API and its device
trace, the top-level names, the ops that share a name with the JAX package's
(``noise.uniform``, ``signal.nco_rotate``, ``fft.chunked_fft``/``phase``/
``freq_axis``, ``blocks/ldpc``'s re-exports), ``StreamSpec``,
``ComputeDomain`` and the thread pools.

Tolerances: names, signatures, shapes, dtypes, counts, events and parsed
domains are compared exactly; ``nco_rotate`` within 2e-6 (the f32 products
of a factored ramp, as ``tests/test_torch_ops.py``'s case), the FFT views
within 1e-4 of the spectrum's scale (cuFFT/pocketfft against XLA's FFT in
f32), ``freq_axis`` exactly (NumPy on both sides)."""

import inspect
import json
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core import compute_domain as jcd, stream as jstream
from gnuradio4_tpu.ops import fft as jfft, ldpc as jldpc, noise as jnoise
from gnuradio4_tpu.ops import signal as jsig
from gnuradio4_tpu_torch.core import compute_domain as tcd, stream as tstream
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import fft as tfft, ldpc as tldpc, noise as tnoise
from gnuradio4_tpu_torch.ops import signal as tsig
from gnuradio4_tpu_torch.utils import thread_pool

torch.set_num_threads(2)

PKGS = (gr, gt)

# names of the JAX package's top level that wait for a later part of the port:
# native/ and the IO blocks (ROADMAP queue 1 item 3), utils/ and the CLI
# (item 4), parallel/ (item 5)
LATER = {"native", "parallel"}


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return pkg.Scheduler(g, **kw)


# -- Graph.adjacency / source_blocks / sink_blocks (tests/test_graph.py:26) --

def _diamond(pkg):
    g = pkg.Graph()
    reg = pkg.global_registry
    src = g.add(reg.create("NullSource", name="src"))
    mul = g.add(reg.create("MultiplyConst", value=2.0, name="mul"))
    add = g.add(reg.create("AddConst", value=1.0, name="add"))
    s1 = g.add(reg.create("NullSink", name="s1"))
    s2 = g.add(reg.create("NullSink", name="s2"))
    g.connect(src, mul)
    g.connect(mul, s1)
    g.connect(src, add)
    g.connect(add, s2)
    return g, src, mul, s1


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_connect_and_topo_order(pkg):
    """tests/test_graph.py:19-26 in each package."""
    g = pkg.Graph()
    reg = pkg.global_registry
    src = g.add(reg.create("NullSource"))
    mul = g.add(reg.create("MultiplyConst", value=2.0))
    snk = g.add(reg.create("NullSink"))
    g.connect(src, mul)
    g.connect(mul, snk)
    assert g.topological_order() == [src, mul, snk]
    assert g.source_blocks() == [src] and g.sink_blocks() == [snk]


def test_adjacency_matches_jax():
    def named(pkg):
        g, *_ = _diamond(pkg)
        adj = {b.name: [(e.dst.name, e.src_port, e.dst_port) for e in es]
               for b, es in g.adjacency().items()}
        return (adj, [b.name for b in g.source_blocks()],
                [b.name for b in g.sink_blocks()])
    want, got = named(gr), named(gt)
    assert got == want
    assert got[1] == ["src"] and got[2] == ["s1", "s2"]


# -- the profiler ------------------------------------------------------------

def _marks(prof):
    with prof.duration("span", k=1):
        prof.instant("mark", step=3)
    prof.counter("queue", depth=4.0, free=2.0)
    prof.begin("region", a="b")
    prof.end("region")
    return [(e["name"], e["ph"], e.get("args", {})) for e in prof.events()]


def test_profiler_api_matches_jax(tmp_path):
    want = _marks(gr.Profiler(process_name="p"))
    got = _marks(gt.Profiler(process_name="p"))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert {ph for _, ph, _ in got} == {"X", "i", "C", "B", "E"}
    prof = gt.Profiler("chip_smoke")
    prof.instant("x")
    prof.write(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["otherData"] == {"process": "chip_smoke"}
    assert gt.Profiler().process_name == "gnuradio4_tpu_torch"
    assert (gt.Profiler.enabled, gt.NullProfiler.enabled) == \
        (gr.Profiler.enabled, gr.NullProfiler.enabled) == (True, False)


def test_null_profiler_is_a_no_op(tmp_path):
    null = gt.NullProfiler()
    assert _marks(null) == []
    null.write(str(tmp_path / "none.json"))
    assert not (tmp_path / "none.json").exists()
    with null.device_trace(str(tmp_path / "d")) as p:
        assert p is None
    with null.jax_trace(str(tmp_path / "d")):
        pass
    assert not (tmp_path / "d").exists()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """``device_trace`` (and its alias ``jax_trace``) wraps torch.profiler
    and writes the region's ops into ``logdir``."""
    prof = gt.Profiler("trace_case")
    assert gt.Profiler.jax_trace is gt.Profiler.device_trace
    with prof.jax_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("trace_case.*.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::cumsum" in names


def test_scheduler_spans_name_the_fed_and_consuming_blocks():
    g = gt.Graph()
    src = gt.global_registry.create("VectorSource", data=np.ones(64, np.float32),
                                    name="feed")
    snk = gt.global_registry.create("VectorSink", name="tap")
    g.connect(src, snk)
    prof = gt.Profiler()
    _sched(gt, g, block_len=32, profiler=prof).run_and_wait()
    spans = {(e["name"], e["args"].get("block")) for e in prof.events()}
    assert ("block.host_feed", "feed") in spans
    assert ("block.consume", "tap") in spans


# -- top-level names ---------------------------------------------------------

def test_top_level_names_missing_only_later_queue_items():
    """Every name of the JAX package's ``__all__`` and public top level is the
    port's too, except the modules of queue 1 items 3–5."""
    missing_all = sorted(set(gr.__all__) - set(gt.__all__))
    public = {n for n in dir(gr) if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(gt, n))
    assert missing_all == []
    assert set(missing) <= LATER, missing
    for name in gt.__all__:
        assert hasattr(gt, name), name


@pytest.mark.parametrize("name, module", [
    ("DataSetPoller", "datasink"), ("MultiplexedPoller", "datasink"),
    ("OverflowPolicy", "datasink"), ("SnapshotPoller", "datasink"),
    ("StreamingPoller", "datasink"), ("TriggerPoller", "datasink"),
    ("BasicTriggerNameCtxMatcher", "trigger"), ("match_trigger", "trigger"),
    ("StreamSpec", "stream"), ("ComputeDomain", "compute_domain"),
    ("DomainKind", "compute_domain"), ("Runtime", "runtime"),
    ("PipeSink", "runtime"), ("merge", "merge")])
def test_top_level_exports(name, module):
    import importlib
    mod = importlib.import_module(f"gnuradio4_tpu_torch.core.{module}")
    assert getattr(gt, name) is getattr(mod, name)
    assert name in gt.__all__


def test_utils_exports():
    from gnuradio4_tpu_torch import utils
    from gnuradio4_tpu_torch.utils.history import HistoryBuffer
    from gnuradio4_tpu_torch.utils.uncertain import UncertainValue
    assert utils.HistoryBuffer is HistoryBuffer
    assert utils.UncertainValue is UncertainValue


# -- ops under the JAX package's names and signatures ----------------------

@pytest.mark.parametrize("jfn, tfn", [
    (jnoise.uniform, tnoise.uniform), (jsig.nco_rotate, tsig.nco_rotate),
    (jfft.chunked_fft, tfft.chunked_fft), (jfft.phase, tfft.phase),
    (jfft.freq_axis, tfft.freq_axis)],
    ids=["uniform", "nco_rotate", "chunked_fft", "phase", "freq_axis"])
def test_op_signature_matches_jax(jfn, tfn):
    def shape(fn):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(fn).parameters.values()]
    assert shape(tfn) == shape(jfn)


def test_uniform_returns_the_draw_and_the_next_key():
    x, key = tnoise.uniform(tnoise.key(3), (5,), low=2.0, high=3.0)
    assert x.shape == (5,) and x.dtype == torch.float32
    assert bool(((x >= 2.0) & (x < 3.0)).all())
    assert key.shape == (2,)


@pytest.mark.parametrize("m, n", [(4096, None), (4096, 4096), (1000, 1000),
                                  (1, 3000)])
def test_nco_rotate_with_n_matches_jax(rng, m, n):
    x = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    dphi = 0x12345678
    want = np.asarray(jsig.nco_rotate(jnp.asarray(x), np.uint32(0xFFFF0000),
                                      np.uint32(dphi), n))
    got = tsig.nco_rotate(torch.from_numpy(x), 0xFFFF0000, dphi, n).numpy()
    assert got.shape == want.shape == (m if n is None else max(m, n),)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, np.abs(x).max()))


@pytest.mark.parametrize("windowed", [False, True])
def test_chunked_fft_and_phase_match_jax(rng, windowed):
    x = (rng.standard_normal((2, 3 * 256)) + 1j * rng.standard_normal((2, 3 * 256))
         ).astype(np.complex64)
    w = np.hanning(256).astype(np.float32) if windowed else None
    want = np.asarray(jfft.chunked_fft(jnp.asarray(x), 256,
                                       window=None if w is None else jnp.asarray(w)))
    got = tfft.chunked_fft(torch.from_numpy(x), 256,
                           window=None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, 3, 256) and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    for unwrap in (False, True):
        pw = np.asarray(jfft.phase(jnp.asarray(want), unwrap=unwrap))
        pt = tfft.phase(torch.from_numpy(want.copy()), unwrap=unwrap).numpy()
        np.testing.assert_allclose(pt, pw, rtol=0, atol=1e-4 * max(1.0, np.abs(pw).max()))


@pytest.mark.parametrize("kw", [{}, {"shifted": True}, {"one_sided": True}])
def test_freq_axis_matches_jax(kw):
    np.testing.assert_array_equal(tfft.freq_axis(64, 48000.0, **kw),
                                  jfft.freq_axis(64, 48000.0, **kw))


def test_ldpc_blocks_module_reexports_encode_and_decode(rng):
    from gnuradio4_tpu.blocks import ldpc as jb
    from gnuradio4_tpu_torch.blocks import ldpc as tb
    assert tb.encode is tldpc.encode and tb.min_sum_decode is tldpc.min_sum_decode
    assert callable(jb.encode) and callable(jb.min_sum_decode)
    H, G = tldpc.make_ldpc(64, 32, seed=3)
    Hj, Gj = jldpc.make_ldpc(64, 32, seed=3)
    np.testing.assert_array_equal(G, Gj)
    u = rng.integers(0, 2, (4, G.shape[0]))
    np.testing.assert_array_equal(tb.encode(G, u), jb.encode(Gj, u))


# -- StreamSpec ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "complex64", "int16", "uint8",
                                   "int32", "uint32", "bool"])
@pytest.mark.parametrize("channels", [0, 3])
def test_stream_spec_matches_jax(dtype, channels):
    from fractions import Fraction
    js = jstream.StreamSpec(dtype=dtype, channels=channels, sample_rate=48e3,
                            signal_unit="V")
    ts = tstream.StreamSpec(dtype=dtype, channels=channels, sample_rate=48e3,
                            signal_unit="V")
    assert ts.dtype == np.dtype(js.dtype)
    assert ts.shape(1024) == js.shape(1024)
    assert ts.with_rate(Fraction(1, 4)).sample_rate == js.with_rate(Fraction(1, 4)).sample_rate
    assert ts.compatible(tstream.StreamSpec(dtype=dtype, channels=channels))
    assert not ts.compatible(tstream.StreamSpec(dtype=dtype, channels=channels + 1))
    z = ts.zeros(1024, device="cpu")
    assert tuple(z.shape) == js.zeros(1024).shape
    assert z.dtype == tstream.torch_dtype(dtype) and z.device.type == "cpu"
    assert not bool(z.any())
    assert tstream.dtype_name(dtype) == jstream.dtype_name(jstream.canonical_dtype(dtype))
    assert tstream.block_shape(channels, 77) == jstream.block_shape(channels, 77)


def test_stream_spec_refuses_bfloat16():
    with pytest.raises(GrError, match="bfloat16"):
        tstream.StreamSpec(dtype="bfloat16")
    with pytest.raises(GrError, match="bfloat16"):
        tstream.canonical_dtype("bfloat16")


# -- ComputeDomain (tests/test_core_foundations.py TestComputeDomain) --------

@pytest.mark.parametrize("spec", ["tpu:xla:0", "host", "tpu", "fpga:vivado:2",
                                  "host::1", "TPU:xla:3"])
def test_compute_domain_parse_matches_jax(spec):
    j, t = jcd.ComputeDomain.parse(spec), tcd.ComputeDomain.parse(spec)
    assert (t.kind.value, t.backend, t.device_index, t.access.value, t.tag) == \
        (j.kind.value, j.backend, j.device_index, j.access.value, j.tag)
    assert str(t) == str(j)


def test_compute_domain_gpu_is_cuda():
    d = tcd.ComputeDomain.parse("gpu")
    assert d.kind is tcd.DomainKind.GPU and d.backend == "cuda"
    assert str(d) == "gpu:cuda:0"
    assert str(tcd.ComputeDomain.parse("gpu:cuda:1")) == "gpu:cuda:1"
    assert tcd.DEFAULT_DEVICE == tcd.ComputeDomain() == d
    assert [k.value for k in tcd.DomainKind] == [k.value for k in jcd.DomainKind]
    assert [a.value for a in tcd.Access] == [a.value for a in jcd.Access]
    assert (tcd.HOST.kind.value, tcd.HOST.backend, tcd.HOST.access.value) == \
        (jcd.HOST.kind.value, jcd.HOST.backend, jcd.HOST.access.value)


def test_compute_domain_unknown_kind_raises():
    with pytest.raises(GrError, match="quantum"):
        tcd.ComputeDomain.parse("quantum:q:0")


# -- compute domains consumed (tests/test_domains_tagarrays_wait.py) ---------

@pytest.mark.parametrize("domain", ["host", "gpu:cuda:0"])
def test_host_domain_forces_host_delivery(domain):
    """The probe on a ``host`` (or ``gpu``) edge receives the same samples in
    both packages (the JAX package runs the gpu case as its own tpu)."""
    def run(pkg):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", frequency=10.0, n_samples=512)
        mul = g.emplace("MultiplyConst", value=2.0)
        probe = pkg.global_registry.create("VectorSink")
        out = pkg.global_registry.create("VectorSink")
        g.connect(src, mul)
        jdom = "tpu" if (pkg is gr and domain.startswith("gpu")) else domain
        g.connect(mul, probe, domain=jdom)
        g.connect(mul, out)
        _sched(pkg, g, block_len=256, sample_rate=100.0).run_and_wait()
        assert probe.data().shape == (512,)
        np.testing.assert_array_equal(probe.data(), out.data())
        return probe.data()
    np.testing.assert_allclose(run(gt), run(gr), rtol=0, atol=1e-5)


def test_host_domain_requires_consume_hook():
    g = gt.Graph()
    src = g.emplace("ConstantSource", n_samples=64)
    mul = g.emplace("MultiplyConst", value=2.0)
    snk = gt.global_registry.create("NullSink")
    g.connect(src, mul, domain="host")  # MultiplyConst has no consume()
    g.connect(mul, snk)
    with pytest.raises(GrError, match="consume"):
        _sched(gt, g, block_len=64).run_and_wait()


@pytest.mark.parametrize("kind", ["tpu", "fpga"])
def test_unsupported_domain_rejected(kind):
    g = gt.Graph()
    a = g.emplace("ConstantSource", n_samples=16)
    b = gt.global_registry.create("VectorSink")
    g.connect(a, b, domain=kind)
    with pytest.raises(GrError, match=kind):
        _sched(gt, g, block_len=16).run_and_wait()


def test_domains_survive_yaml_in_both_packages():
    """``save_grc`` writes each edge's domain as the JAX package does, and
    ``load_grc`` of either package reads the other's."""
    def build(pkg, dom):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", n_samples=64, name="src")
        mul = g.emplace("MultiplyConst", value=2.0, name="mul")
        snk = g.emplace("VectorSink", name="snk")
        tap = g.emplace("VectorSink", name="tap")
        g.connect(src, mul)
        g.connect(mul, snk)
        g.connect(mul, tap, domain=dom)
        return g
    t_text = gt.save_grc(build(gt, "host"))
    j_text = gr.save_grc(build(gr, "host"))
    for text in (t_text, j_text):
        for pkg in PKGS:
            doms = {(e.src.name, e.dst.name): e.domain
                    for e in pkg.load_grc(text).edges}
            assert str(doms[("mul", "tap")]) == "host::0"
            assert doms[("mul", "snk")] is None
        assert {str(e.domain) for e in gt.load_grc(text).edges
                if e.domain} == {str(tcd.HOST)}
    g2 = gt.load_grc(gt.save_grc(build(gt, "gpu:cuda:0")))
    assert [str(e.domain) for e in g2.edges if e.domain] == ["gpu:cuda:0"]


# -- thread pools (TestThreadPoolWired) -------------------------------------

def test_runtime_threads_registered():
    g = gt.Graph()
    src = g.emplace("ConstantSource", value=1.0, n_samples=1 << 16)
    snk = gt.global_registry.create("VectorSink")
    g.connect(src, snk)
    sched = _sched(gt, g, block_len=1 << 12, watchdog_timeout=30.0,
                   name="wired")
    sched.start()
    deadline = time.monotonic() + 5.0
    names = []
    while time.monotonic() < deadline:
        names = thread_pool.active_threads()
        if any("runner" in n for n in names):
            break
        time.sleep(0.005)
    sched.wait_done(30.0)
    assert "wired-runner" in names, names


def test_named_pools_submit_and_shut_down():
    assert thread_pool.io() is thread_pool.pool(thread_pool.DEFAULT_IO)
    assert thread_pool.cpu() is thread_pool.pool(thread_pool.DEFAULT_CPU)
    fut = thread_pool.submit("case_pool", lambda a, b: a * b, 6, b=7)
    assert fut.result(timeout=5) == 42
    assert any(n.startswith("gr4tpu-case_pool") for n in thread_pool.active_threads())
    thread_pool.shutdown_all(wait=True)
    assert not any(n.startswith("gr4tpu-case_pool")
                   for n in thread_pool.active_threads())
    assert thread_pool.submit("case_pool", abs, -3).result(timeout=5) == 3
    thread_pool.shutdown_all(wait=True)


def test_spawn_registers_until_the_thread_ends():
    import threading
    go = threading.Event()
    t = thread_pool.spawn(go.wait, name="case-spawned")
    assert t.daemon and "case-spawned" in thread_pool.active_threads()
    go.set()
    t.join(5)
    assert "case-spawned" not in thread_pool.active_threads()


# -- no JAX behind the new modules ------------------------------------------

def test_new_modules_load_no_jax():
    code = ("import sys, gnuradio4_tpu_torch.core.compute_domain, "
            "gnuradio4_tpu_torch.core.merge, gnuradio4_tpu_torch.core.runtime, "
            "gnuradio4_tpu_torch.core.subgraph, gnuradio4_tpu_torch.core.host_call, "
            "gnuradio4_tpu_torch.core.stream, gnuradio4_tpu_torch.core.feeder, "
            "gnuradio4_tpu_torch.core.profiler, gnuradio4_tpu_torch.utils.thread_pool, "
            "gnuradio4_tpu_torch.blocks.python_block, "
            "gnuradio4_tpu_torch.blocks.timing; "
            "assert 'jax' not in sys.modules and 'gnuradio4_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
