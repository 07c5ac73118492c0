"""The port's multi-graph Runtime, PipeSink and ScheduledSubgraph against the
JAX package's, on the CPU: every case of ``tests/test_runtime.py`` and
``tests/test_scheduled_subgraph.py``, the ring-bridge case of
``tests/test_step_batching.py:174`` and the ScheduledSubgraph registry case of
``tests/test_core_foundations.py``, each through both packages.

Every threaded case closes its sources and bounds its waits
(``run_all(timeout=)``, ``wait_done(timeout)``), so a fault fails the case
instead of parking a worker.

Tolerances: the piped and bridged streams are bitwise equal to the same
blocks run in one graph of the same package (the pipes only copy); the port
against the JAX package within 1e-5 where a SignalGenerator's sine is in the
stream (f32 ``sin`` of one phase grid in two libraries), bitwise where the
data is a ramp; counts, tags, registry names and settings exact."""

import time
import types

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

SINE_ATOL = 1e-5
WAIT = 60.0   # bound on every threaded wait


def _kw(pkg, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return kw


@pytest.fixture(autouse=True, scope="module")
def _port_registry_as_found():
    """The cases import core/subgraph.py, which registers ScheduledSubgraph
    in the port's global registry; a later file on the same worker compares
    that registry with a fresh process's (tests/test_torch_cli.py), so the
    module leaves it as it found it."""
    before = dict(gt.global_registry._factories)
    yield
    gt.global_registry._factories.clear()
    gt.global_registry._factories.update(before)


def _subgraph_mod(pkg):
    # imported in the cases, as the JAX package's own tests do: the module
    # registers ScheduledSubgraph
    if pkg is gt:
        from gnuradio4_tpu_torch.core import subgraph
    else:
        from gnuradio4_tpu.core import subgraph
    return subgraph


# -- Runtime + PipeSink (tests/test_runtime.py) -----------------------------

def _piped(pkg):
    rt = pkg.Runtime()
    acq = pkg.Graph()
    a_src = acq.emplace("SignalGenerator", frequency=1000.0, n_samples=65536)
    a_pipe = acq.emplace("PipeSink")
    acq.connect(a_src, a_pipe)
    dsp = pkg.Graph()
    d_src = dsp.emplace("StreamSource", dtype="float32")
    d_mul = dsp.emplace("MultiplyConst", value=3.0)
    d_snk = dsp.emplace("VectorSink")
    dsp.connect_chain(d_src, d_mul, d_snk)
    rt.add(acq, **_kw(pkg, block_len=8192, sample_rate=48000.0))
    rt.add(dsp, **_kw(pkg, block_len=2048, sample_rate=48000.0))  # another cadence
    rt.pipe(a_pipe, d_src)
    rt.run_all(timeout=WAIT)
    return np.asarray(d_snk.data()), rt


def test_cross_graph_pipe_exact():
    got, rt = _piped(gt)
    assert all(s.device == torch.device("cpu") for s in rt.schedulers)
    ref_g = gt.Graph()
    r_src = ref_g.emplace("SignalGenerator", frequency=1000.0, n_samples=65536)
    r_snk = ref_g.emplace("VectorSink")
    ref_g.connect(r_src, r_snk)
    gt.Scheduler(ref_g, block_len=8192, sample_rate=48000.0,
                 device="cpu").run_and_wait()
    ref = (3.0 * np.asarray(r_snk.data())[:65536]).astype(np.float32)
    np.testing.assert_array_equal(got[:65536], ref)
    want, _ = _piped(gr)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=3.0 * SINE_ATOL)


@pytest.mark.parametrize("pkg", [gr, gt], ids=["jax", "port"])
def test_unconnected_pipe_error_surfaces_to_waiter(pkg):
    g = pkg.Graph()
    src = g.emplace("SignalGenerator", n_samples=4096)
    ps = g.emplace("PipeSink")
    g.connect(src, ps)
    rt = pkg.Runtime()
    rt.add(g, **_kw(pkg, block_len=2048, sample_rate=1e6))
    with pytest.raises(Exception, match="not connected"):
        rt.run_all(timeout=WAIT)


def test_unconnected_pipe_error_is_a_grerror():
    g = gt.Graph()
    g.connect(g.emplace("SignalGenerator", n_samples=64), g.emplace("PipeSink"))
    rt = gt.Runtime()
    rt.add(g, block_len=64, device="cpu")
    with pytest.raises(GrError, match="not connected"):
        rt.run_all(timeout=WAIT)


def test_stop_all_mid_run():
    rt = gt.Runtime()
    ga = gt.Graph()
    sa = ga.emplace("SignalGenerator")          # infinite
    pa = ga.emplace("PipeSink")
    ga.connect(sa, pa)
    gb = gt.Graph()
    sb = gb.emplace("StreamSource")
    kb = gb.emplace("NullSink")
    gb.connect(sb, kb)
    rt.add(ga, block_len=4096, sample_rate=1e6, device="cpu")
    rt.add(gb, block_len=4096, sample_rate=1e6, device="cpu")
    rt.pipe(pa, sb)
    rt.start_all()
    time.sleep(0.3)
    rt.stop_all()
    rt.wait_all(WAIT)
    assert all(s.state is gt.State.STOPPED for s in rt.schedulers)
    assert all(s.steps > 0 for s in rt.schedulers)
    sb.close()


@pytest.mark.parametrize("pkg", [gr, gt], ids=["jax", "port"])
def test_pipe_rejects_non_source(pkg):
    rt = pkg.Runtime()
    g = pkg.Graph()
    ps = g.emplace("PipeSink")
    snk = g.emplace("NullSink")
    with pytest.raises(pkg.GrError, match="StreamSource"):
        rt.pipe(ps, snk)


def test_runtime_add_runs_on_the_card_unless_asked():
    g = gt.Graph()
    g.connect(g.emplace("ConstantSource", n_samples=8), g.emplace("NullSink"))
    rt = gt.Runtime()
    assert rt.add(g, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert rt.add(g).device.type == "cuda"
    else:
        with pytest.raises(GrError):
            rt.add(g)


def test_pipe_forwards_tags_free_eos_on_stop():
    """A graph torn down without an EOS tag still closes its pipe, so the
    consumer drains instead of starving."""
    src_g = gt.Graph()
    sg = src_g.emplace("ConstantSource", value=2.0, n_samples=3000)
    ps = src_g.emplace("PipeSink", forward_eos=False)
    src_g.connect(sg, ps)
    dst = gt.global_registry.create("StreamSource", timeout=0.5)
    ps.connect_to(dst)
    gt.Scheduler(src_g, block_len=1000, device="cpu").run_and_wait()
    assert not dst._ensure_ring().eos          # forward_eos=False: left open
    np.testing.assert_array_equal(
        dst._ensure_ring().read(dst._reader), np.full(3000, 2.0, np.float32))
    ps2 = gt.global_registry.create("PipeSink")
    ps2.connect_to(dst)
    ps2.stop()
    assert dst._ensure_ring().eos


# -- ScheduledSubgraph (tests/test_scheduled_subgraph.py) -------------------

def _inner_chain(pkg):
    reg = pkg.global_registry
    inner = pkg.Graph(name="inner")
    m = inner.add(reg.create("MultiplyConst", value=3.0, name="m"))
    a = inner.add(reg.create("AddConst", value=1.0, name="a"))
    inner.connect(m, a)
    inner.export_in("in", m, "in")
    inner.export_out("out", a, "out")
    return inner


def _bridged(pkg, data, block, **sub_kw):
    sub_mod = _subgraph_mod(pkg)
    g = pkg.Graph()
    src = pkg.global_registry.create("VectorSource", data=data)
    sub = sub_mod.ScheduledSubgraph(_inner_chain(pkg), name="sub", **sub_kw)
    snk = pkg.global_registry.create("VectorSink")
    g.connect(src, sub)
    g.connect(sub, snk)
    sched = pkg.Scheduler(g, **_kw(pkg, block_len=block))
    sched.run_and_wait()
    return np.asarray(snk.data()), sub, sched


def test_scheduled_subgraph_processes_stream():
    """Counted latency: no fabricated samples — the consumer's FIRST valid
    sample equals the producer's first sample (warm-up steps carry
    n_valid=0 and are skipped by the sink)."""
    n = 8192
    data = np.arange(n, dtype=np.float32)
    out, sub, sched = _bridged(gt, data, 512)
    ref = data * 3.0 + 1.0
    assert out.shape[0] == n              # lossless: EOS drains the bridge
    assert out[0] == ref[0]               # first sample IS the producer's first
    np.testing.assert_array_equal(out, ref)
    assert sub._inner_sched.device == torch.device("cpu")   # the outer's device
    assert sched.steps >= n // 512
    want, _, _ = _bridged(gr, data, 512)
    np.testing.assert_array_equal(out, want)


def test_scheduled_subgraph_equals_the_flat_run(rng):
    """A filtering inner graph (FirFilter) bridged equals the same blocks run
    flat, sample for sample, with its own inner block length."""
    x = rng.standard_normal(6000).astype(np.float32)
    taps = rng.standard_normal(31).astype(np.float32)
    sub_mod = _subgraph_mod(gt)

    def inner():
        ig = gt.Graph(name="inner")
        fir = ig.add(gt.global_registry.create("FirFilter", taps=taps, name="fir"))
        mul = ig.add(gt.global_registry.create("MultiplyConst", value=0.5))
        ig.connect(fir, mul)
        ig.export_in("in", fir, "in")
        ig.export_out("out", mul, "out")
        return ig
    g = gt.Graph()
    sub = sub_mod.ScheduledSubgraph(inner(), block_len_inner=500)
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(gt.global_registry.create("VectorSource", data=x), sub, snk)
    gt.Scheduler(g, block_len=1000, device="cpu").run_and_wait()
    flat = gt.Graph()
    fsnk = gt.global_registry.create("VectorSink")
    flat.connect_chain(gt.global_registry.create("VectorSource", data=x),
                       gt.global_registry.create("FirFilter", taps=taps),
                       gt.global_registry.create("MultiplyConst", value=0.5), fsnk)
    gt.Scheduler(flat, block_len=500, device="cpu").run_and_wait()
    np.testing.assert_array_equal(snk.data(), fsnk.data())


def test_scheduled_subgraph_steps_longer_than_a_million_items():
    """A step of 2^21 items crosses the bridge: each ring holds two steps of
    its side (the JAX package's 2^20-item rings starve on such a step)."""
    n = 1 << 21
    data = np.arange(2 * n, dtype=np.float32)
    out, sub, _ = _bridged(gt, data, n, starve_timeout=20.0)
    np.testing.assert_array_equal(out, data * 3.0 + 1.0)
    assert all(r.capacity >= 2 * n for r in (*sub._in_rings.values(),
                                              *sub._out_rings.values()))


@pytest.mark.parametrize("pkg", [gr, gt], ids=["jax", "port"])
def test_subgraph_requires_exports(pkg):
    with pytest.raises(pkg.GrError):
        _subgraph_mod(pkg).ScheduledSubgraph(pkg.Graph())


@pytest.mark.parametrize("pkg", [gr, gt], ids=["jax", "port"])
def test_bridge_drains_unequal_tails_at_eos(pkg):
    """EOS wind-down with UNEQUAL leftovers across output rings (one port
    holds trailing frames, the other is already drained): the bridge must
    serve the longest tail (shorter ports zero-pad inside the valid window)
    and then report EOS — not starve until timeout and lose the data."""
    sub_mod = _subgraph_mod(pkg)
    if pkg is gt:
        from gnuradio4_tpu_torch.core.feeder import HostRing
        from gnuradio4_tpu_torch.core.lifecycle import State
    else:
        from gnuradio4_tpu.native.ring import HostRing
        from gnuradio4_tpu.core.lifecycle import State
    sub = sub_mod.ScheduledSubgraph(_inner_chain(pkg), name="sub")
    ra, rb = HostRing(64, np.float32), HostRing(64, np.float32)
    sub._out_rings = {"a": ra, "b": rb}
    sub._out_readers = {"a": ra.add_reader(), "b": rb.add_reader()}
    sub._inner_sched = types.SimpleNamespace(state=State.RUNNING, error=None)
    ra.write(np.arange(4, dtype=np.float32))
    ra.set_eos()
    rb.set_eos()            # drained + EOS while `a` still holds 4 samples

    got = sub.host_feed(8, 0)
    assert got is not None, "bridge starved instead of serving the tail"
    out, nv = got
    assert nv == 4
    np.testing.assert_array_equal(out["a"][:4], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(out["b"], np.zeros(8, np.float32))
    assert sub.host_feed(8, 4) is None   # fully drained → clean EOS


def test_bridge_starve_timeout_raises():
    sub_mod = _subgraph_mod(gt)
    from gnuradio4_tpu_torch.core.feeder import HostRing
    from gnuradio4_tpu_torch.core.lifecycle import State
    sub = sub_mod.ScheduledSubgraph(_inner_chain(gt), starve_timeout=0.05)
    r = HostRing(64, np.float32)
    sub._out_rings = {"out": r}
    sub._out_readers = {"out": r.add_reader()}
    sub._inner_sched = types.SimpleNamespace(state=State.RUNNING, error=None)
    out, nv = sub.host_feed(8, 0)          # warm-up: nothing yet, not EOS
    assert nv == 0 and not out["out"].any()
    time.sleep(0.1)
    with pytest.raises(GrError, match="produced nothing"):
        sub.host_feed(8, 0)


def test_ring_bridge_rejects_batching():
    """A ScheduledSubgraph bridge (FEED + consume) feeds from the previous
    step's delivery — batching must be rejected loudly
    (tests/test_step_batching.py:174)."""
    sub_mod = _subgraph_mod(gt)
    inner = gt.Graph()
    a = inner.emplace("MultiplyConst", value=2.0)
    inner.export_in("in", a, "in")
    inner.export_out("out", a, "out")
    g = gt.Graph()
    src = g.emplace("VectorSource")
    src.data = np.ones(4096, np.float32)
    bridge = g.add(sub_mod.ScheduledSubgraph(inner))
    snk = g.emplace("VectorSink")
    g.connect_chain(src, bridge, snk)
    with pytest.raises(GrError, match="batch_steps"):
        gt.Scheduler(g, block_len=1024, batch_steps=4, device="cpu").run_and_wait()


def test_scheduled_subgraph_from_the_registry_matches_jax():
    """The registry case of tests/test_core_foundations.py: ScheduledSubgraph
    builds from the registry with an inner graph, under the JAX package's
    settings."""
    made = {}
    for pkg in (gr, gt):
        _subgraph_mod(pkg)
        g = pkg.Graph()
        c = g.emplace("Copy")
        g.export_in("in", c, "in")
        g.export_out("out", c, "out")
        made[pkg] = pkg.global_registry.create("ScheduledSubgraph", inner=g)
    sj, st = made[gr].settings.spec, made[gt].settings.spec
    assert sorted(st) == sorted(sj)
    for key in sj:
        for attr in ("kind", "choices", "unit", "description"):
            assert getattr(st[key], attr) == getattr(sj[key], attr), (key, attr)
        assert repr(st[key].default) == repr(sj[key].default)
    assert [p.name for p in made[gt].in_ports] == ["in"]
    assert [p.name for p in made[gt].out_ports] == ["out"]
    assert made[gt].name


def test_pipe_sink_settings_match_jax():
    pj = gr.global_registry.create("PipeSink")
    pt = gt.global_registry.create("PipeSink")
    assert sorted(pt.settings.spec) == sorted(pj.settings.spec)
    assert pt.settings.get("forward_eos") is True
