"""The port's full Scheduler against the JAX package's, on the CPU: each case
builds the same graph in both packages, runs it under both schedulers with the
same settings and compares every sink (data and tags) — lifecycle,
start/wait_done, stop from another thread, pause/resume, EOS, partial final
blocks, pipeline depth, step_once, dynamic settings without recompile, the
scheduler variants, and what the port refuses (bad feedback loops, what is
not a mesh)."""

import threading
import time

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw.setdefault("device", "cpu")
    return pkg.Scheduler(g, **kw)


def _tags(snk):
    return [(int(t.index), dict(t.map)) for t in snk.tags]


def _counting_chain(pkg, n, value=3.0, sink="VectorSink"):
    g = pkg.Graph()
    src = g.emplace("CountingSource", n_samples=n)
    mul = g.emplace("MultiplyConst", value=value, name="gain")
    snk = g.emplace(sink)
    g.connect_chain(src, mul, snk)
    return g, mul, snk


def _both(build, run=lambda s: s.run_and_wait(), **kw):
    """Build with ``build(pkg)`` → (graph, sinks...) in both packages, run, and
    return [(scheduler, sinks) for jax, port]."""
    out = []
    for pkg in (gr, gt):
        g, *sinks = build(pkg)
        s = _sched(pkg, g, **kw)
        run(s)
        out.append((s, sinks))
    return out


def _assert_sinks_equal(res, exact=True):
    (sj, kj), (st, kt) = res
    for a, b in zip(kj, kt):
        da, db = np.asarray(a.data()), np.asarray(b.data())
        assert da.shape == db.shape
        if exact:
            np.testing.assert_array_equal(db, da)
        else:
            np.testing.assert_allclose(db, da, rtol=1e-6, atol=1e-6)
        assert _tags(a) == _tags(b)
    assert sj.state.value == st.state.value


@pytest.mark.parametrize("n,bl", [(1000, 256), (777, 256), (100, 256),
                                  (1024, 128)])
def test_vector_roundtrip_and_partial_final_block(rng, n, bl):
    data = rng.standard_normal(n).astype(np.float32)

    def build(pkg):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["VectorSource"](data))
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        return g, snk

    res = _both(build, block_len=bl)
    _assert_sinks_equal(res)
    np.testing.assert_array_equal(res[1][1][0].data(), data)
    assert res[1][0].state is gt.State.STOPPED


@pytest.mark.parametrize("pipeline_depth", [1, 2, 3])
def test_counting_source_eos_and_values(pipeline_depth):
    res = _both(lambda pkg: _counting_chain(pkg, 1000)[::2], block_len=256,
                pipeline_depth=pipeline_depth)
    _assert_sinks_equal(res)
    np.testing.assert_array_equal(res[1][1][0].data(),
                                  3.0 * np.arange(1000, dtype=np.float32))


def test_fan_out_to_two_branches():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=512)
        a = g.emplace("MultiplyConst", value=2.0)
        b = g.emplace("DivideConst", value=3.0)
        s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
        g.connect(src, a)
        g.connect(src, b)
        g.connect(a, s1)
        g.connect(b, s2)
        return g, s1, s2

    _assert_sinks_equal(_both(build, block_len=128))


def test_eos_tag_and_state_after_run():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("TagSource", n_samples=700)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        return g, snk

    res = _both(build, block_len=256)
    _assert_sinks_equal(res)
    eos = [i for i, m in _tags(res[1][1][0]) if m.get("end_of_stream")]
    assert eos == [700]


def test_pipeline_depth_bounds_inflight_steps():
    """Depth d: after d pumps nothing is delivered yet in either package."""
    for pkg in (gr, gt):
        g, _, snk = _counting_chain(pkg, 1 << 13)
        s = _sched(pkg, g, block_len=512, pipeline_depth=2)
        s.init()
        s._pump_once()
        s._pump_once()
        assert len(s._inflight) == 2 and snk.data().shape[-1] == 0
        s._pump_once()
        assert len(s._inflight) == 2 and snk.data().shape[-1] == 512
        s._drain()
        assert snk.data().shape[-1] == 1536


def test_step_once_delivers_each_step_and_ends():
    """step_once: the caller owns the cadence; each call returns with its
    step delivered, and the stream ends with the same sinks as a JAX run."""
    g, _, snk = _counting_chain(gt, 1000)
    s = _sched(gt, g, block_len=256)
    counts = []
    while s.step_once():
        counts.append(snk.data().shape[-1])
    # the partial last block produced samples; the call after it ends the run
    assert counts == [256, 512, 768, 1000]
    assert s.state is gt.State.STOPPED and snk.data().shape[-1] == 1000
    gj, _, snk_j = _counting_chain(gr, 1000)
    gr.Scheduler(gj, block_len=256).run_and_wait()
    np.testing.assert_array_equal(snk.data(), snk_j.data())
    with pytest.raises(GrError, match="STOPPED"):
        s.step_once()


def test_start_wait_done_runs_to_eos():
    res = _both(lambda pkg: _counting_chain(pkg, 5000)[::2],
                run=lambda s: (s.start(), s.wait_done(timeout=60)),
                block_len=512)
    _assert_sinks_equal(res)
    assert res[1][0].state is gt.State.STOPPED


@pytest.mark.parametrize("via", ["call", "message"])
def test_request_stop_from_another_thread(via):
    """An unbounded source, stopped from a second thread: both packages stop
    cleanly with samples delivered."""
    for pkg in (gr, gt):
        g = pkg.Graph()
        snk = g.emplace("NullSink")
        g.connect(g.emplace("ConstantSource"), snk)
        s = _sched(pkg, g, block_len=256)
        s.start()
        deadline = time.monotonic() + 20
        while snk.count == 0 and time.monotonic() < deadline:
            time.sleep(0.005)

        def stop():
            if via == "call":
                s.request_stop()
            else:
                s.bus.send_command(pkg.Command.Set, "", pkg.Property.LIFECYCLE_STATE,
                                   {"state": "REQUESTED_STOP"})

        t = threading.Thread(target=stop)
        t.start()
        t.join(timeout=10)
        s.wait_done(timeout=30)
        assert not t.is_alive()
        assert s.state.value == "STOPPED" and snk.count > 0


def test_pause_resume():
    g = gt.Graph()
    snk = g.emplace("NullSink")
    g.connect(g.emplace("ConstantSource"), snk)
    s = _sched(gt, g, block_len=256)
    s.start()
    deadline = time.monotonic() + 20
    while snk.count == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    s.request_pause()
    s.fsm.wait_for(gt.State.PAUSED, timeout=10)
    n1 = snk.count
    time.sleep(0.05)
    n2 = snk.count
    assert n2 - n1 <= 2 * 256 * s.pipeline_depth   # at most the in-flight drain
    s.resume()
    deadline = time.monotonic() + 20
    while snk.count <= n2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert snk.count > n2
    s.request_stop()
    s.wait_done(timeout=30)
    assert s.state is gt.State.STOPPED


def test_lifecycle_hooks_fire_in_order():
    calls = []

    def build(pkg):
        class Hooked(pkg.global_registry._factories["Copy"]):
            def start(self):
                calls.append((pkg.__name__, "start"))

            def stop(self):
                calls.append((pkg.__name__, "stop"))

        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=1024)
        h = g.add(Hooked())
        snk = g.emplace("VectorSink")
        g.connect_chain(src, h, snk)
        return g, snk

    _assert_sinks_equal(_both(build, block_len=256))
    assert [c for p, c in calls if p == "gnuradio4_tpu"] == \
        [c for p, c in calls if p == "gnuradio4_tpu_torch"] == ["start", "stop"]


def test_dynamic_setting_change_no_recompile():
    def run(s):
        s.init()
        s.run_and_wait(n_steps=2)
        s._compiled_before = s.compiled
        next(b for b in s.graph.blocks if b.name == "gain").settings.set(
            {"value": 10.0})
        while s._pump_once():
            pass
        s._drain()

    res = _both(lambda pkg: _counting_chain(pkg, 2048, value=1.0)[::2], run=run,
                block_len=512, pipeline_depth=1)
    _assert_sinks_equal(res)
    s, (snk,) = res[1]
    assert s.compiled is s._compiled_before
    np.testing.assert_array_equal(snk.data()[1024:],
                                  10.0 * np.arange(1024, 2048, dtype=np.float32))


def test_static_setting_change_recompiles_and_carries_state():
    """A static change (Delay's length) recompiles at the step boundary; the
    other blocks' states carry over in both packages alike."""
    def run(s):
        s.init()
        s._pump_once()
        next(b for b in s.graph.blocks if b.name == "d").settings.set({"delay": 5})
        while s._pump_once():
            pass
        s._drain()

    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=2048)
        d = g.emplace("Delay", delay=3, name="d")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, d, snk)
        return g, snk

    res = _both(build, run=run, block_len=512, pipeline_depth=1)
    _assert_sinks_equal(res)


@pytest.mark.parametrize("kind", ["Simple", "BreadthFirst", "DepthFirst"])
def test_scheduler_variants_registered(kind):
    from gnuradio4_tpu.core.registry import global_scheduler_registry as jreg
    out = []
    for pkg, reg in ((gr, jreg), (gt, gt.global_scheduler_registry)):
        g, _, snk = _counting_chain(pkg, 1000)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = reg.create(kind, g, block_len=256, **kw)
        s.run_and_wait()
        out.append(snk.data())
    np.testing.assert_array_equal(out[1], out[0])
    assert sorted(gt.global_scheduler_registry.known_schedulers()) == \
        ["BreadthFirst", "DepthFirst", "Simple"]


def test_reset_after_error_reruns():
    class Boom(gt.Block):
        IN = (gt.Port("in"),)
        OUT = (gt.Port("out"),)
        fail = True

        def apply(self, state, ins, ctx):
            if Boom.fail:
                raise RuntimeError("kaboom")
            return state, {"out": ins["in"]}

    g = gt.Graph()
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(g.emplace("CountingSource", n_samples=512), g.add(Boom()), snk)
    s = _sched(gt, g, block_len=256)
    with pytest.raises(GrError, match="kaboom"):
        s.run_and_wait()
    assert s.state is gt.State.ERROR and s.error is not None
    Boom.fail = False
    s.reset()
    assert s.state is gt.State.IDLE
    s.run_and_wait()
    np.testing.assert_array_equal(snk.data(), np.arange(512, dtype=np.float32))


def test_wait_done_raises_runner_failure():
    class Boom(gt.Block):
        IN = (gt.Port("in"),)
        OUT = (gt.Port("out"),)

        def apply(self, state, ins, ctx):
            raise RuntimeError("kaboom")

    g = gt.Graph()
    g.connect_chain(g.emplace("CountingSource"), g.add(Boom()), g.emplace("NullSink"))
    s = _sched(gt, g, block_len=256)
    s.start()
    with pytest.raises(GrError, match="kaboom"):
        s.wait_done(timeout=30)


def test_feedback_edges_and_meshes_raise():
    """A feedback back-edge compiles into one loop group, as in the JAX
    package (tests/test_torch_feedback.py runs the loops); a mesh that is
    not a ``parallel.mesh.Mesh`` and bad batch sizes are refused."""
    h = gt.Graph()
    a = h.emplace("Copy", name="a")
    b = h.emplace("Copy", name="b")
    h.connect(a, b)
    h.connect(b, a, feedback=True, delay=4)
    h.connect(b, h.emplace("NullSink"))
    c = gt.compile_graph(h, block_len=64, device="cpu")
    assert [[m.name for m in grp["order"]] for grp in c.loop_groups] \
        == [["a", "b"]]
    assert c.loop_groups[0]["delay"] == 4
    with pytest.raises(GrError, match="mesh"):
        gt.Scheduler(h, mesh=object())
    with pytest.raises(GrError, match="batch_steps"):
        gt.Scheduler(h, batch_steps=0, device="cpu")
