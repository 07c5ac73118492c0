"""The port's tag plane against the JAX package's, on the CPU: the propagation
policies and tag records as functions, and through running graphs in both
packages — the tag walk, index rescaling across rate changes, EOS tags,
settings auto-update from tags, context activation, forward-on-apply, and
sample-accurate settings ramps (every sink's data and tags compared)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core import tags as jtags
from gnuradio4_tpu_torch.core import tags as ttags

torch.set_num_threads(2)


def _tags(snk):
    return [(int(t.index), dict(t.map)) for t in snk.tags]


def _run_both(build, **kw):
    """``build(pkg)`` → (graph, sink, extra); run in both packages with the
    same scheduler settings; assert equal sink data and tags; return both."""
    out = []
    for pkg in (gr, gt):
        g, snk, *extra = build(pkg)
        skw = dict(kw, device="cpu") if pkg is gt else dict(kw)
        pkg.Scheduler(g, **skw).run_and_wait()
        out.append((snk, *extra))
    (a, *_), (b, *_) = out
    da, db = np.asarray(a.data()), np.asarray(b.data())
    assert da.shape == db.shape
    np.testing.assert_array_equal(db, da)
    assert _tags(a) == _tags(b)
    return out


def _vector_source(pkg, data, tags=(), **kw):
    return pkg.global_registry._factories["VectorSource"](
        data, tags=[pkg.Tag(t.index, dict(t.map)) for t in tags], **kw)


# -- records and policies as functions ----------------------------------------

@pytest.mark.parametrize("policy", ["TPP_DONT", "TPP_ALL_TO_ALL",
                                    "TPP_ONE_TO_ONE", "TPP_CUSTOM"])
@pytest.mark.parametrize("ratio", [Fraction(1), Fraction(1, 4), Fraction(3, 2)])
def test_propagate_matches_jax(policy, ratio):
    ins = {"a": [(5, {"x": 1}), (5, {"x": 1}), (9, {"sample_rate": 1e3})],
           "b": [(5, {"y": 2}), (40, {"x": 1})]}
    got = []
    for mod in (jtags, ttags):
        res = mod.propagate({p: [mod.Tag(i, dict(m)) for i, m in ts]
                             for p, ts in ins.items()},
                            policy=getattr(mod.TagPropagation, policy),
                            out_ports=["o1", "o2"], in_ports=["a", "b"],
                            ratio=ratio)
        got.append({p: [(t.index, t.map) for t in ts] for p, ts in res.items()})
    assert got[0] == got[1]


def test_tag_helpers_match_jax():
    raw = [(7, {"a": 1}), (3, {"b": 2}), (7, {"a": 1}), (7, {"c": 3}),
           (3, {"b": 5})]
    for fn in ("coalesce", "dedup"):
        a = getattr(jtags, fn)([jtags.Tag(i, dict(m)) for i, m in raw])
        b = getattr(ttags, fn)([ttags.Tag(i, dict(m)) for i, m in raw])
        assert [(t.index, t.map) for t in a] == [(t.index, t.map) for t in b]
    assert jtags.merge_maps([jtags.Tag(i, m) for i, m in raw]) == \
        ttags.merge_maps([ttags.Tag(i, m) for i, m in raw])
    t = ttags.Tag(1000, {ttags.Keys.SAMPLE_RATE: 48e3, "k": 1})
    r = t.rescaled(Fraction(1, 8))
    assert r.index == 125 and r.map[ttags.Keys.SAMPLE_RATE] == 6e3
    assert t.shifted(-10).index == 990 and t.map[ttags.Keys.SAMPLE_RATE] == 48e3
    ja = jtags.TagArrays.from_tags([jtags.Tag(i, dict(m)) for i, m in raw], 4)
    ta = ttags.TagArrays.from_tags([ttags.Tag(i, dict(m)) for i, m in raw], 4)
    np.testing.assert_array_equal(ta.indices, ja.indices)
    np.testing.assert_array_equal(ta.valid, ja.valid)
    np.testing.assert_array_equal(ta.values_for("b"), ja.values_for("b"))
    assert {k: v for k, v in vars(ttags.Keys).items() if k.isupper()} == \
        {k: v for k, v in vars(jtags.Keys).items() if k.isupper()}


# -- the tag walk through running graphs ----------------------------------------

@pytest.mark.parametrize("batch_steps", [1, 2])
def test_tags_flow_to_sink_with_absolute_indices(batch_steps):
    def build(pkg):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["TagSource"](
            tags=[pkg.Tag(10, {"a": 1}), pkg.Tag(300, {"b": 2})], n_samples=512))
        mon = g.emplace("TagMonitor")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mon, snk)
        return g, snk, mon

    (_, mj), (snk, mt) = _run_both(build, block_len=128, batch_steps=batch_steps)
    assert [(t.index, t.map) for t in mt.observed] == \
        [(t.index, t.map) for t in mj.observed]
    assert [t.index for t in mt.observed][:2] == [10, 300]
    assert any(m.get("end_of_stream") for _, m in _tags(snk))


@pytest.mark.parametrize("decim", [2, 4])
def test_tag_indices_rescale_through_decimation(decim):
    """A decimating FirFilter maps tag indices onto its output grid."""
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.arange(2048, dtype=np.float32),
                                   [pkg.Tag(400, {"mark": 1}),
                                    pkg.Tag(1000, {"mark": 2})]))
        fir = g.emplace("FirFilter", taps=(0.5, 0.5), decim=decim)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fir, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=512)
    marks = {m["mark"]: i for i, m in _tags(snk) if "mark" in m}
    assert marks == {1: 400 // decim, 2: 1000 // decim}


def test_tags_rescale_through_channelizer_with_sample_rate():
    """Through the PFB's ÷M the index and a carried sample_rate both scale
    (Tag.rescaled), the same in both packages."""
    def build(pkg):
        g = pkg.Graph()
        x = np.exp(2j * np.pi * 0.01 * np.arange(4096)).astype(np.complex64)
        src = g.add(_vector_source(pkg, x, [
            pkg.Tag(512, {"sample_rate": 1e6, "k": 1}), pkg.Tag(2048, {"k": 2})]))
        ch = g.emplace("PFBChannelizer", n_channels=8, taps_per_phase=4)
        snk = g.emplace("TagSink")
        g.connect_chain(src, ch, snk)
        return g, snk

    out = []
    for pkg in (gr, gt):
        g, snk = build(pkg)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=1024, **kw).run_and_wait()
        out.append(_tags(snk))
    assert out[0] == out[1]
    assert (64, {"sample_rate": 125000.0, "k": 1}) in out[1]
    assert (256, {"k": 2}) in out[1]


def test_eos_tag_index_marks_stream_end():
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("TagSource", n_samples=700)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=256)
    assert [i for i, m in _tags(snk) if m.get("end_of_stream")] == [700]


def test_tags_traverse_deep_fast_path_cascade():
    """Tag-passive blocks are skipped by the walk's fast path when no tag is in
    flight; tags that do enter walk the whole 40-block cascade."""
    def build(pkg):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["TagSource"](
            n_samples=4096, tags=[pkg.Tag(100, {"hello": 1}),
                                  pkg.Tag(2000, {"hello": 2})]))
        prev = src
        for _ in range(20):
            m = g.emplace("MultiplyConst", value=2.0)
            d = g.emplace("DivideConst", value=2.0)
            g.connect(prev, m)
            g.connect(m, d)
            prev = d
        snk = g.emplace("TagSink")
        g.connect(prev, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=1024, sample_rate=1e6)
    got = {i: m for i, m in _tags(snk) if "hello" in m}
    assert got[100]["hello"] == 1 and got[2000]["hello"] == 2
    assert [i for i, m in _tags(snk) if m.get("end_of_stream")] == [4096]


def test_tpp_dont_blocks_propagation():
    def build(pkg):
        class Opaque(pkg.global_registry._factories["MultiplyConst"]):
            TAG_POLICY = pkg.TagPropagation.TPP_DONT

        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.zeros(512, np.float32),
                                   [pkg.Tag(10, {"x": 1})]))
        blk = g.add(Opaque(value=1.0))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, blk, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=512)
    assert not any("x" in m for _, m in _tags(snk))


def test_delay_shifts_tags():
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.arange(1024, dtype=np.float32),
                                   [pkg.Tag(10, {"x": 1}), pkg.Tag(700, {"x": 2})]))
        d = g.emplace("Delay", delay=37)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, d, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=256)
    assert [(i, m) for i, m in _tags(snk) if "x" in m] == \
        [(47, {"x": 1}), (737, {"x": 2})]
    np.testing.assert_array_equal(snk.data()[37:], np.arange(1024 - 37))


# -- settings from tags -----------------------------------------------------------

def test_sample_rate_tag_passes_untouched():
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.zeros(1024, np.float32),
                                   [pkg.Tag(0, {"sample_rate": 96000.0})]))
        mul = g.emplace("MultiplyConst", value=1.0)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mul, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=512)
    assert any(m.get("sample_rate") == 96000.0 for _, m in _tags(snk))


def test_forward_on_apply_emits_tag_downstream():
    """Changing an auto-forward setting (sample_rate) publishes a tag."""
    out = []
    for pkg in (gr, gt):
        class RateBlock(pkg.Block):
            IN = (pkg.Port("in"),)
            OUT = (pkg.Port("out"),)
            sample_rate = pkg.Setting(default=1000.0)

            def apply(self, state, ins, ctx):
                return state, {"out": ins["in"]}

        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.zeros(4096, np.float32)))
        rb = g.add(RateBlock(name="rate"))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, rb, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = pkg.Scheduler(g, block_len=512, pipeline_depth=1, **kw)
        s.init()
        s._pump_once()
        rb.settings.set({"sample_rate": 2000.0})
        while s._pump_once():
            pass
        s._drain()
        out.append(_tags(snk))
    assert out[0] == out[1]
    assert any(m.get("sample_rate") == 2000.0 for _, m in out[1])


def test_context_switch_via_tag():
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.ones(2048, np.float32),
                                   [pkg.Tag(1024, {"context": "boost"})]))
        mul = g.emplace("MultiplyConst", value=1.0, name="g")
        mul.settings.set({"value": 5.0}, ctx=pkg.SettingsCtx(context="boost"))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mul, snk)
        return g, snk, mul

    _, (snk, mul) = _run_both(build, block_len=512)
    assert snk.data()[0] == 1.0 and snk.data()[-1] == 5.0
    assert mul.settings.active_context.context == "boost"


def test_ctx_time_tag_activates_timed_preset():
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.ones(2048, np.float32),
                                   [pkg.Tag(512, {"ctx_time": 10.0}),
                                    pkg.Tag(1024, {"ctx_time": 20.0})]))
        mul = g.emplace("MultiplyConst", value=1.0)
        mul.settings.set({"value": 5.0}, ctx=pkg.SettingsCtx(time=10.0, context="t10"))
        mul.settings.set({"value": 9.0}, ctx=pkg.SettingsCtx(time=20.0, context="t20"))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mul, snk)
        return g, snk

    (snk, *_), _ = _run_both(build, block_len=512, pipeline_depth=1)
    y = snk.data()
    assert y[0] == 1.0 and 5.0 in y and y[-1] == 9.0


def test_settings_change_recorder_message_and_tag_paths():
    """Both control paths — a Set message and a tag auto-update — are applied
    and recorded at the same steps in both packages."""
    recs = []

    def build(pkg):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["TagSource"](
            value=1.0, n_samples=16384, tags=[pkg.Tag(8192, {"scaling_factor": 3.0})]))
        rec = g.emplace("SettingsChangeRecorder", scaling_factor=2.0, name="rec")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, rec, snk)
        recs.append(rec)
        return g, snk

    out = []
    for pkg in (gr, gt):
        g, snk = build(pkg)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = pkg.Scheduler(g, block_len=4096, sample_rate=1e6, **kw)
        s.bus.send_command(pkg.Command.Set, "rec", pkg.Property.SETTING,
                           {"scaling_factor": 5.0})
        s.run_and_wait()
        out.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(out[1], out[0])
    assert recs[0].recorded == recs[1].recorded
    changes = [c for _, c in recs[1].recorded]
    assert {"scaling_factor": 5.0} in changes and {"scaling_factor": 3.0} in changes


# -- sample-accurate ramps ----------------------------------------------------------

@pytest.mark.parametrize("tags,bl,expect", [
    ([(700, 3.0)], 512, [(0, 2.0), (700, 3.0)]),
    ([(100, 5.0), (200, 7.0)], 1024, [(0, 2.0), (100, 5.0), (200, 7.0)]),
    ([(300, 5.0), (300, 9.0)], 1024, [(0, 2.0), (300, 9.0)]),
    ([(100, 4.0)], 512, [(0, 2.0), (100, 4.0)]),
])
def test_multiply_const_switches_at_exact_sample(tags, bl, expect):
    def build(pkg):
        g = pkg.Graph()
        src = g.add(pkg.global_registry._factories["TagSource"](
            value=1.0, n_samples=2048,
            tags=[pkg.Tag(i, {"value": v}) for i, v in tags]))
        mul = g.emplace("MultiplyConst", value=2.0)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, mul, snk)
        return g, snk, mul

    _, (snk, mul) = _run_both(build, block_len=bl, pipeline_depth=1)
    want = np.empty(2048, np.float32)
    for i, v in expect:
        want[i:] = v
    np.testing.assert_array_equal(snk.data(), want)
    assert float(mul.settings.get("value")) == expect[-1][1]


def test_demod_gain_ramp():
    """A QuadratureDemod gain tag applies at its exact sample (the port's
    demod declared no SAMPLE_ACCURATE gain before the full tag walk)."""
    x = np.exp(2j * np.pi * 0.1 * np.arange(2048)).astype(np.complex64)

    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, x, [pkg.Tag(500, {"gain": 2.0})]))
        dem = g.emplace("QuadratureDemod", gain=1.0)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, dem, snk)
        return g, snk

    out = []
    for pkg in (gr, gt):
        g, snk = build(pkg)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=2048, pipeline_depth=1, **kw).run_and_wait()
        out.append(snk.data())
    np.testing.assert_allclose(out[1], out[0], atol=1e-6)
    w = 2 * np.pi * 0.1
    np.testing.assert_allclose(out[1][1:500], w, rtol=1e-4)
    np.testing.assert_allclose(out[1][500:], 2 * w, rtol=1e-4)


def test_tag_staged_rate_change_defers_to_next_step():
    """A tag-staged STATIC change that re-solves the rates (a context switching
    the FIR's decimation) runs the old program for the tagged step and the new
    one from the next step, the same in both packages."""
    def build(pkg):
        g = pkg.Graph()
        src = g.add(_vector_source(pkg, np.arange(4096, dtype=np.float32),
                                   [pkg.Tag(1024, {"context": "fast"})]))
        dec = g.emplace("FirFilter", taps=(1.0,), decim=2)
        dec.settings.set({"decim": 4}, ctx=pkg.SettingsCtx(context="fast"))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, dec, snk)
        return g, snk, dec

    _, (snk, dec) = _run_both(build, block_len=1024)
    y = snk.data()
    assert y.shape[-1] == 512 + 512 + 2 * 256
    assert np.all(np.diff(y) > 0) and int(dec.settings.get("decim")) == 4
