"""Async delivery, batched super-steps, the watchdog and zombie pruning of the
port's Scheduler against the JAX package's, on the CPU. Each case builds the
same graph in both packages and runs it under both schedulers with the same
settings; sinks (data and tags), zombie lists and bus messages are compared.

Watchdog timeouts are stated in steps: a step's time is measured first, and
the timeout and the stall are multiples of it."""

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


def _cls(pkg, name):
    return pkg.global_registry._factories[name]


def _counting_chain(pkg, n=1 << 16):
    g = pkg.Graph()
    src = g.emplace("CountingSource", n_samples=n)
    mul = g.emplace("MultiplyConst", value=3.0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, mul, snk)
    return g, snk


def _stateful_chain(pkg, x, taps=(0.5, 0.25, 0.125), tags=()):
    """VectorSource → FirFilter (history) → QuadratureDemod (carried sample)."""
    g = pkg.Graph()
    src = g.add(_cls(pkg, "VectorSource")(x, tags=[pkg.Tag(i, dict(m))
                                                   for i, m in tags]))
    fir = g.emplace("FirFilter", taps=taps)
    dem = g.emplace("QuadratureDemod", gain=1.0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, fir, dem, snk)
    return g, snk


# -- async delivery ------------------------------------------------------------

def test_async_bit_identical_to_sync_and_to_jax():
    out = []
    for pkg, kw in ((gr, {}), (gt, {}), (gt, {"async_delivery": True})):
        g, snk = _counting_chain(pkg)
        _sched(pkg, g, block_len=4096, **kw).run_and_wait()
        out.append(snk.data())
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[2], out[1])
    assert out[2].shape == (1 << 16,)


@pytest.mark.parametrize("batch_steps", [1, 4])
def test_async_fifo_with_slow_sink_gets_each_steps_data(batch_steps):
    """A sink that sleeps in consume: deliveries arrive in step order, each
    with its own step's data, and the queue stays bounded at the depth."""
    seen = []

    class SlowSink(gt.SinkBlock):
        IN = (gt.Port("in", dtype="float32"),)

        def consume(self, arrays, tags, n_valid, abs_index):
            time.sleep(0.003)
            seen.append((int(abs_index), np.array(arrays["in"][:n_valid])))

    g = gt.Graph()
    g.connect_chain(g.emplace("CountingSource", n_samples=1 << 15),
                    g.add(SlowSink()))
    s = _sched(gt, g, block_len=1024, async_delivery=True, pipeline_depth=2,
               batch_steps=batch_steps)
    s.init()
    s._pump_once()
    assert s._dq is None or s._dq.maxsize == 2
    s.run_and_wait()
    got = [i for i, a in seen if a.size]
    assert got == sorted(got) == [k * 1024 for k in range(32)]
    for i, a in seen:
        np.testing.assert_array_equal(a, np.arange(i, i + a.size, dtype=np.float32))


def test_async_consume_error_surfaces_on_pump():
    class BadSink(gt.SinkBlock):
        IN = (gt.Port("in", dtype="float32"),)

        def consume(self, arrays, tags, n_valid, abs_index):
            if abs_index >= 2048:
                raise ValueError("boom at 2048")

    g = gt.Graph()
    g.connect_chain(g.emplace("CountingSource", n_samples=1 << 14), g.add(BadSink()))
    s = _sched(gt, g, block_len=1024, async_delivery=True)
    with pytest.raises(ValueError, match="boom at 2048"):
        s.run_and_wait()
    assert s.state is gt.State.ERROR and s._dworker is None


def test_async_consume_error_prunes_in_prune_mode():
    out = []
    for pkg in (gr, gt):
        class BadSink(pkg.SinkBlock):
            IN = (pkg.Port("in", dtype="float32"),)

            def consume(self, arrays, tags, n_valid, abs_index):
                raise ValueError("always fails")

        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=1 << 14)
        bad = g.add(BadSink(name="bad"))
        good = g.emplace("VectorSink")
        g.connect(src, bad)
        g.connect(src, good)
        s = _sched(pkg, g, block_len=1024, async_delivery=True,
                   on_block_error="prune")
        s.run_and_wait()
        out.append((s.zombies, good.data()))
    assert out[0][0] == out[1][0] == ["bad"]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][1].shape == (1 << 14,)


def test_tags_ride_async_delivery():
    marks = [(i, {"k": i}) for i in (0, 1000, 2047, 2048, 7000)]
    out = []
    for pkg, kw in ((gr, {}), (gt, {}), (gt, {"async_delivery": True})):
        g = pkg.Graph()
        src = g.add(_cls(pkg, "TagSource")(
            tags=[pkg.Tag(i, dict(m)) for i, m in marks], n_samples=8192))
        snk = g.emplace("TagSink")
        g.connect(src, snk)
        _sched(pkg, g, block_len=2048, **kw).run_and_wait()
        out.append(_tags(snk))
    assert out[0] == out[1] == out[2] and len(out[2]) >= len(marks)


def test_feed_that_consumes_forces_sync_delivery():
    class Bridge(gt.Block):
        IN = (gt.Port("in"),)
        OUT = (gt.Port("out"),)
        FEED = True

        def host_feed(self, n, abs_index):
            return {"out": np.zeros(n, np.float32)}

        def consume(self, arrays, tags, n_valid, abs_index):
            pass

        def apply(self, state, ins, ctx):
            return state, {"out": ins["out"]}

    g = gt.Graph()
    g.connect_chain(g.emplace("CountingSource", n_samples=1024), g.add(Bridge()),
                    g.emplace("NullSink"))
    s = _sched(gt, g, block_len=256, async_delivery=True)
    s.init()
    assert not s._async_delivery_active()


# -- batched super-steps ---------------------------------------------------------

@pytest.mark.parametrize("bs", [2, 4, 8])
def test_batched_stateful_chain_matches_unbatched(rng, bs):
    """FIR history and the demod's carried sample thread through the sub-steps
    exactly as through separate steps (bitwise in the port; within f32
    rounding of the JAX package, whose CPU FIR lowers through a conv)."""
    n = 1 << 15
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    g, snk = _stateful_chain(gr, x)
    gr.Scheduler(g, block_len=4096, sample_rate=1e6).run_and_wait()
    ref_j = snk.data()
    out = []
    for b in (1, bs):
        g, snk = _stateful_chain(gt, x)
        _sched(gt, g, block_len=4096, sample_rate=1e6, batch_steps=b,
               async_delivery=b > 1).run_and_wait()
        out.append(snk.data())
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_allclose(out[1], ref_j, atol=1e-5)


@pytest.mark.parametrize("n", [3 * 4096 + 1234, 5 * 4096, 4096 - 7])
def test_eos_mid_batch_partial_final(rng, n):
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    out = []
    for pkg, bs in ((gr, 4), (gt, 1), (gt, 4)):
        g, snk = _stateful_chain(pkg, x)
        _sched(pkg, g, block_len=4096, sample_rate=1e6,
               batch_steps=bs).run_and_wait()
        out.append((snk.data(), _tags(snk)))
    assert out[2][0].shape == out[1][0].shape == (n,)
    np.testing.assert_array_equal(out[2][0], out[1][0])
    np.testing.assert_allclose(out[2][0], out[0][0], atol=1e-5)
    assert out[0][1] == out[1][1] == out[2][1]


@pytest.mark.parametrize("tags,n,bs,expect", [
    ([(700, 3.0)], 4096, 4, [(0, 2.0), (700, 3.0)]),
    ([(100, 4.0)], 8192, 4, [(0, 2.0), (100, 4.0)]),
    ([(300, 5.0), (1500, 7.0)], 4096, 8, [(0, 2.0), (300, 5.0), (1500, 7.0)]),
])
def test_value_switch_mid_batch_exact_sample(tags, n, bs, expect):
    """A SAMPLE_ACCURATE tag landing in an inner sub-step hits its exact
    sample; later sub-steps (this batch and the next) run on the new scalar."""
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.add(_cls(pkg, "TagSource")(
            value=1.0, n_samples=n, tags=[pkg.Tag(i, {"value": v}) for i, v in tags]))
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mul, snk)
        _sched(pkg, g, block_len=512, pipeline_depth=1, batch_steps=bs).run_and_wait()
        out.append((snk.data(), float(mul.settings.get("value"))))
    want = np.empty(n, np.float32)
    for i, v in expect:
        want[i:] = v
    np.testing.assert_array_equal(out[0][0], want)
    np.testing.assert_array_equal(out[1][0], want)
    assert out[0][1] == out[1][1] == expect[-1][1]


def test_tags_delivered_at_absolute_indices_under_batching():
    marks = [(10, {"a": 1}), (3000, {"b": 2}), (7777, {"c": 3})]
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.add(_cls(pkg, "TagSource")(
            value=1.0, n_samples=8192, tags=[pkg.Tag(i, dict(m)) for i, m in marks]))
        snk = g.emplace("TagSink")
        g.connect(src, snk)
        _sched(pkg, g, block_len=1024, pipeline_depth=1, batch_steps=4).run_and_wait()
        out.append(_tags(snk))
    assert out[0] == out[1]
    assert [t for t in out[1] if set(t[1]) & {"a", "b", "c"}] == marks


def _decim_switch(pkg, tag_at, n):
    g = pkg.Graph()
    src = g.add(_cls(pkg, "VectorSource")(
        np.arange(n, dtype=np.float32), tags=[pkg.Tag(tag_at, {"context": "fast"})]))
    dec = g.emplace("FirFilter", taps=(1.0,), decim=2)
    dec.settings.set({"decim": 4}, ctx=pkg.SettingsCtx(context="fast"))
    snk = g.emplace("VectorSink")
    g.connect_chain(src, dec, snk)
    return g, snk


@pytest.mark.parametrize("tagged_batch", [0, 1])
def test_mid_batch_static_change_lands_at_the_super_step_boundary(tagged_batch):
    """A context tag switching the FIR's decimation in sub-step 1 of a batch:
    the rest of that batch runs as compiled (÷2), the new rates from the next
    super-step (÷4) — the semantics the JAX package's scheduler documents.
    (The JAX package itself re-traces its batch program when the batch's
    params overlay changes, reading the new value, and switches inside the
    tagged batch: a reference fault, ROADMAP queue 3.)"""
    n = 16 * 1024
    g, snk = _decim_switch(gt, (4 * tagged_batch + 1) * 1024, n)
    _sched(gt, g, block_len=1024, batch_steps=4).run_and_wait()
    y = snk.data()
    cut = 4 * 1024 * (tagged_batch + 1)
    np.testing.assert_array_equal(
        y, np.concatenate([np.arange(0, cut, 2), np.arange(cut, n, 4)]
                          ).astype(np.float32))


def test_head_block_terminates_inside_batch():
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=5000)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        _sched(pkg, g, block_len=512, pipeline_depth=1, batch_steps=4).run_and_wait()
        out.append(snk.data())
    assert out[0].shape[-1] == out[1].shape[-1] == 5000
    np.testing.assert_array_equal(out[1], out[0])


def test_graph_done_mid_batch_stops_host_feeds():
    """After HeadBlock ends the graph in sub-step k, the rest of the batch is
    inert: a live host source is not read past the stop."""
    calls = {gr: [], gt: []}
    out = []
    for pkg in (gr, gt):
        class CountingFeed(pkg.Block):
            OUT = (pkg.Port("out", dtype="float32"),)
            FEED = True

            def host_feed(self, n, abs_index, pkg=pkg):
                calls[pkg].append(abs_index)
                return {"out": np.full(n, 1.0, np.float32)}

            def apply(self, state, ins, ctx):
                return state, {"out": ins["out"]}

        g = pkg.Graph()
        src = g.add(CountingFeed())
        head = g.emplace("HeadBlock", n_samples=600)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        _sched(pkg, g, block_len=256, pipeline_depth=1, batch_steps=8).run_and_wait()
        out.append(snk.data())
    assert out[0].shape[-1] == out[1].shape[-1] == 600
    assert calls[gr] == calls[gt] and len(calls[gt]) <= 4


def test_step_counter_and_inflight_count_super_steps():
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", value=1.0)
        head = g.emplace("HeadBlock", n_samples=1 << 15)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, head, snk)
        s = _sched(pkg, g, block_len=512, pipeline_depth=2, batch_steps=4)
        s.init()
        s._pump_once()
        assert s._step == 4
        t1 = s._last_progress
        s._pump_once()
        assert s._step == 8 and s._last_progress >= t1
        assert len(s._inflight) == 2 and all(len(r.batch) == 4 for r in s._inflight)
        assert snk.data().shape[-1] == 0
        s._drain()
        assert snk.data().shape[-1] == 4096


# -- device-resident VectorSource ------------------------------------------------

@pytest.mark.parametrize("n,bl,bs", [(1024, 256, 1), (1000, 256, 1), (100, 256, 1),
                                     (777, 128, 1), (1024, 128, 4)])
def test_device_resident_source_bit_exact_vs_host_feed(rng, n, bl, bs):
    data = rng.standard_normal(n).astype(np.float32)
    tags = [(3, {"a": 1}), (n // 2, {"b": 2}), (n - 1, {"c": 3})]
    out = []
    for pkg, dev in ((gr, True), (gt, False), (gt, True)):
        g = pkg.Graph()
        src = g.add(_cls(pkg, "VectorSource")(
            data, tags=[pkg.Tag(i, dict(m)) for i, m in tags], device_resident=dev))
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        _sched(pkg, g, block_len=bl, pipeline_depth=1, batch_steps=bs).run_and_wait()
        out.append((snk.data(), _tags(snk)))
    for d, t in out[1:]:
        assert d.shape == (n,) and t == out[0][1]
        np.testing.assert_array_equal(d, out[0][0])


def test_device_resident_complex_channels_and_repeat(rng):
    data = (rng.standard_normal((3, 500))
            + 1j * rng.standard_normal((3, 500))).astype(np.complex64)
    out = []
    for dev in (False, True):
        g = gt.Graph()
        src = g.add(_cls(gt, "VectorSource")(data, device_resident=dev))
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        _sched(gt, g, block_len=128, pipeline_depth=1).run_and_wait()
        out.append(snk.data())
    assert out[1].shape == (3, 500)
    np.testing.assert_array_equal(out[1], out[0])
    g = gt.Graph()
    src = g.add(_cls(gt, "VectorSource")(np.arange(10, dtype=np.float32),
                                         device_resident=True, repeat=True))
    snk = g.emplace("VectorSink")
    g.connect(src, snk)
    _sched(gt, g, block_len=64, pipeline_depth=1).run_and_wait(n_steps=3)
    np.testing.assert_array_equal(snk.data(), np.tile(np.arange(10.0), 20)[:192])


# -- watchdog (timeouts stated in steps) ------------------------------------------

def _step_seconds() -> float:
    g = gt.Graph()
    g.connect(g.emplace("ConstantSource"), g.emplace("NullSink"))
    s = _sched(gt, g, block_len=256)
    s.init()
    s._pump_once()
    t0 = time.perf_counter()
    for _ in range(20):
        s._pump_once()
    return (time.perf_counter() - t0) / 20


def _stalling_graph(pkg, stall_s, at_step=3):
    class StallSource(_cls(pkg, "ConstantSource")):
        def host_done(self, abs_out, n):
            if abs_out == at_step * n:
                time.sleep(stall_s)
            return super().host_done(abs_out, n)

    g = pkg.Graph()
    snk = g.emplace("NullSink")
    g.connect(g.add(StallSource(n_samples=256 * 8)), snk)
    return g, snk


@pytest.mark.parametrize("action", ["notify", "stop"])
def test_watchdog_flags_a_stalled_pump(action):
    """Timeout = 50 steps (≥ 0.2 s); the source stalls 8 timeouts at step 3."""
    timeout = max(50 * _step_seconds(), 0.2)
    out = []
    for pkg in (gr, gt):
        g, snk = _stalling_graph(pkg, 8 * timeout)
        s = _sched(pkg, g, block_len=256, watchdog_timeout=timeout,
                   watchdog_action=action)
        seen = []
        s.bus.subscribe("Watchdog", lambda m: seen.append(m.data))
        s.run_and_wait()
        out.append((len(seen), s.state.value, snk.count))
    assert out[0][:2] == out[1][:2] == (1, "STOPPED")
    if action == "notify":
        assert out[0][2] == out[1][2] == 256 * 8
    else:
        assert out[1][2] < 256 * 8


def test_watchdog_error_fails_waiters_fast():
    timeout = max(50 * _step_seconds(), 0.2)
    g, _ = _stalling_graph(gt, 20 * timeout)
    s = _sched(gt, g, block_len=256, watchdog_timeout=timeout,
               watchdog_action="error")
    s.start()
    with pytest.raises(GrError, match="watchdog"):
        s.wait_done(timeout=10 * timeout)
    assert s.state is gt.State.ERROR
    s._runner.join(timeout=40 * timeout)


def test_watchdog_quiet_on_healthy_batches():
    g = gt.Graph()
    head = g.emplace("HeadBlock", n_samples=1 << 16)
    snk = g.emplace("VectorSink")
    g.connect_chain(g.emplace("ConstantSource", value=1.0), head, snk)
    s = _sched(gt, g, block_len=512, pipeline_depth=1, batch_steps=8,
               watchdog_timeout=max(200 * _step_seconds(), 5.0))
    flagged = []
    s.bus.subscribe("Watchdog", lambda m: flagged.append(m))
    s.run_and_wait()
    assert not flagged and snk.data().shape[-1] == 1 << 16


# -- zombie pruning -----------------------------------------------------------------

def _types(names):
    """Block names with the per-package instance number dropped."""
    return sorted(n.split("#")[0] for n in names)


def _exploding(pkg):
    class ExplodingBlock(pkg.Block):
        IN = (pkg.Port("in"),)
        OUT = (pkg.Port("out"),)

        def apply(self, state, ins, ctx):
            raise RuntimeError("kaboom (apply)")

    return ExplodingBlock


def _two_branch(pkg, n=4096, delay=0):
    """src → Delay → {boom → bad_mul → NullSink ; good ×2 → VectorSink}."""
    g = pkg.Graph()
    src = g.emplace("CountingSource", n_samples=n)
    d = g.emplace("Delay", delay=delay, name="d")
    bad = g.add(_exploding(pkg)(name="boom"))
    bad_mul = g.emplace("MultiplyConst", value=1.0, name="bad_mul")
    good = g.emplace("MultiplyConst", value=2.0)
    snk = g.emplace("VectorSink")
    g.connect(src, d)
    g.connect(d, bad)
    g.connect(bad, bad_mul)
    g.connect(bad_mul, g.emplace("NullSink"))
    g.connect(d, good)
    g.connect(good, snk)
    return g, snk


@pytest.mark.parametrize("batch_steps", [1, 4])
def test_apply_failure_prunes_branch_keeps_streaming(batch_steps):
    """The failing branch goes; the step is run again on the pruned graph
    from the states as they were before it — the Delay upstream of the
    failure, which already ran in the failed attempt, does not advance
    twice."""
    out = []
    for pkg in (gr, gt):
        g, snk = _two_branch(pkg, delay=5)
        s = _sched(pkg, g, block_len=1024, pipeline_depth=1,
                   on_block_error="prune", batch_steps=batch_steps)
        errs = []
        s.bus.subscribe("BlockError", lambda m: errs.append(m.data))
        s.run_and_wait()
        names = {b.name for b in s.compiled.order}
        out.append((s.state.value, _types(s.zombies), snk.data(),
                    [(e["block"], _types(e["removed"])) for e in errs],
                    "boom" in names or "bad_mul" in names))
    assert out[0][:2] == out[1][:2] == ("STOPPED", ["NullSink", "bad_mul", "boom"])
    assert out[1][3] == out[0][3] == [("boom", ["NullSink", "bad_mul", "boom"])]
    assert not out[1][4]
    want = 2.0 * np.concatenate([np.zeros(5), np.arange(4096 - 5)])
    np.testing.assert_array_equal(out[1][2], want)
    np.testing.assert_array_equal(out[1][2], out[0][2])


def test_consume_failure_prunes_sink_only():
    out = []
    for pkg in (gr, gt):
        class ExplodingSink(pkg.SinkBlock):
            IN = (pkg.Port("in"),)

            def __init__(self, name=None, **s):
                super().__init__(name=name, **s)
                self.calls = 0

            def consume(self, arrays, tags, n_valid, abs_index):
                self.calls += 1
                if self.calls >= 2:
                    raise RuntimeError("kaboom (consume)")

        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=4096)
        good = g.emplace("MultiplyConst", value=3.0)
        snk = g.emplace("VectorSink")
        g.connect(src, g.add(ExplodingSink(name="flaky_sink")))
        g.connect(src, good)
        g.connect(good, snk)
        s = _sched(pkg, g, block_len=512, pipeline_depth=1, on_block_error="prune")
        s.run_and_wait()
        out.append((s.zombies, snk.data()))
    assert out[0][0] == out[1][0] == ["flaky_sink"]
    np.testing.assert_array_equal(out[1][1], 3.0 * np.arange(4096))


def test_default_shutdown_raises():
    g, _ = _two_branch(gt)
    s = _sched(gt, g, block_len=1024, pipeline_depth=1)
    with pytest.raises(GrError, match="kaboom"):
        s.run_and_wait()
    assert s.state is gt.State.ERROR


def test_feed_failure_in_batch_prunes_after_the_batch():
    out = []
    for pkg in (gr, gt):
        class FlakyFeed(pkg.Block):
            OUT = (pkg.Port("out", dtype="float32"),)
            FEED = True

            def host_feed(self, n, abs_index):
                if abs_index >= 2 * n:
                    raise IOError("device unplugged")
                return {"out": np.arange(abs_index, abs_index + n, dtype=np.float32)}

            def apply(self, state, ins, ctx):
                return state, {"out": ins["out"]}

        g = pkg.Graph()
        feed = g.add(FlakyFeed(name="flaky"))
        s1 = g.emplace("VectorSink")
        g.connect(feed, s1)
        s2 = g.emplace("VectorSink")
        g.connect(g.emplace("CountingSource", n_samples=8 * 256), s2)
        s = _sched(pkg, g, block_len=256, pipeline_depth=1, batch_steps=4,
                   on_block_error="prune")
        s.run_and_wait()
        out.append((s.zombies, s2.data()))
    assert _types(out[0][0]) == _types(out[1][0]) == ["VectorSink", "flaky"]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][1], np.arange(8 * 256, dtype=np.float32))
