"""The last blocks of ``blocks/testing.py`` in the port — SlowSource,
SimCompute, PerformanceMonitor, ArraySource and ArraySink — against the JAX
package, on the CPU: the same registry names and settings, and the same
streams through both schedulers. Exact, except SimCompute: k float32
multiply-adds per sample, which XLA contracts into FMAs on the CPU and torch
rounds twice, so the two drift by up to one rounding per operation: rtol
k·2^-23.
"""

import time

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu_torch.core.errors import GrError as TGrError

torch.set_num_threads(2)

BLOCKS = ["SlowSource", "SimCompute", "PerformanceMonitor", "ArraySource",
          "ArraySink"]


def _run(pkg, g, **kw):
    if pkg is gt:
        kw.setdefault("device", "cpu")
    s = pkg.Scheduler(g, **kw)
    s.run_and_wait()
    return s


@pytest.mark.parametrize("name", BLOCKS)
def test_registry_names_and_settings_match(name):
    tc, jc = gt.global_registry.get(name), gr.global_registry.get(name)
    assert sorted(tc._settings_spec) == sorted(jc._settings_spec)
    for key, s in jc._settings_spec.items():
        t = tc._settings_spec[key]
        assert (t.default, t.kind, t.limits) == (s.default, s.kind, s.limits)


@pytest.mark.parametrize("n_samples,delay_s", [(3000, 0.01), (1024, 0.0)])
def test_slow_source(n_samples, delay_s):
    outs, took = [], []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("SlowSource", value=2.5, n_samples=n_samples,
                        delay_s=delay_s)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        t0 = time.monotonic()
        s = _run(pkg, g, block_len=512)
        took.append((time.monotonic() - t0, s._step))
        outs.append(snk.data())
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].shape == (n_samples,)
    wall, steps = took[1]
    assert steps == took[0][1]
    # host_done sleeps once per step that produced samples
    assert wall >= -(-n_samples // 512) * delay_s


@pytest.mark.parametrize("ops", [1, 64, 256])
@pytest.mark.parametrize("cx", [False, True])
def test_sim_compute(ops, cx):
    rng = np.random.default_rng(ops)
    x = rng.standard_normal(2048)
    if cx:
        x = x + 1j * rng.standard_normal(2048)
    x = x.astype(np.complex64 if cx else np.float32)
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        g.connect_chain(g.emplace("VectorSource", data=x),
                        g.emplace("SimCompute", ops_per_sample=ops),
                        snk := g.emplace("VectorSink"))
        _run(pkg, g, block_len=1024)
        outs.append(snk.data())
    assert outs[1].dtype == outs[0].dtype
    np.testing.assert_allclose(outs[1], outs[0], rtol=ops * 2.0 ** -23,
                               atol=1e-7)


def test_performance_monitor():
    x = np.ones(4096, np.float32)
    g = gt.Graph()
    mon = g.emplace("PerformanceMonitor")
    g.connect_chain(g.emplace("VectorSource", data=x), g.emplace("Copy"),
                    mon)
    _run(gt, g, block_len=1024)
    assert mon.n == 4096
    assert mon.samples_per_second > 0.0
    fresh = gt.global_registry.create("PerformanceMonitor")
    assert fresh.samples_per_second == 0.0
    assert fresh.WANTS_HOST_DATA is False and fresh.CONSUME_IGNORES_DATA


@pytest.mark.parametrize("batch_steps", [1, 2])
def test_performance_monitor_counts_like_the_jax_package(batch_steps):
    counts = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        mon = g.emplace("PerformanceMonitor")
        g.connect(g.emplace("ConstantSource", n_samples=5000), mon)
        _run(pkg, g, block_len=1024, batch_steps=batch_steps)
        counts.append(mon.n)
    assert counts[1] == counts[0] == 5000


_rng = np.random.default_rng(71)
ARRAY_SETS = {
    "two_real": [_rng.standard_normal(1500).astype(np.float32),
                 np.arange(1500, dtype=np.float32)],
    "mixed": [(_rng.standard_normal(1000) + 1j * _rng.standard_normal(1000)
               ).astype(np.complex64),
              _rng.standard_normal((3, 1000)).astype(np.float32),
              np.arange(1000, dtype=np.int32)],
}


@pytest.mark.parametrize("which", sorted(ARRAY_SETS))
@pytest.mark.parametrize("repeat", [False, True])
def test_array_source_to_array_sink(which, repeat):
    arrays = ARRAY_SETS[which]
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = pkg.global_registry.create("ArraySource", arrays=arrays,
                                         repeat=repeat)
        snk = pkg.global_registry.create("ArraySink", n_inputs=len(arrays))
        for i in range(len(arrays)):
            g.connect(src, snk, src_port=f"out{i}", dst_port=f"in{i}")
        kw = {"block_len": 256}
        if repeat:
            s = pkg.Scheduler(g, **kw, **({"device": "cpu"} if pkg is gt
                                          else {}))
            s.run_and_wait(9)
        else:
            _run(pkg, g, **kw)
        outs.append([snk.data(i) for i in range(len(arrays))])
    for a, b, src_arr in zip(*outs, arrays):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype
        n = b.shape[-1]
        idx = np.arange(n) % src_arr.shape[-1]
        np.testing.assert_array_equal(b, src_arr[..., idx])


def test_array_sink_empty_and_ports():
    snk = gt.global_registry.create("ArraySink", n_inputs=3)
    assert [p.name for p in snk.in_ports] == ["in0", "in1", "in2"]
    assert snk.data(2).shape == (0,)


@pytest.mark.parametrize("arrays", [[], [np.zeros(4), np.zeros(5)]])
def test_array_source_rejections_agree(arrays):
    with pytest.raises(JGrError) as ej:
        gr.global_registry.create("ArraySource", arrays=arrays)
    with pytest.raises(TGrError) as et:
        gt.global_registry.create("ArraySource", arrays=arrays)
    assert et.value.args[0] == ej.value.args[0]
