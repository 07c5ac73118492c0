"""Parity of the port's nested graphs and WBFM receiver (suite config 3)
against the JAX package, on the CPU: the flattened graph's blocks and edges,
the receiver built through the registry in both packages with every sink
compared, and a stream started in JAX and continued in the port."""

from importlib import import_module

import numpy as np
import jax
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import ConnectionError_
from gnuradio4_tpu_torch.interop import params_from_numpy, states_from_numpy

torch.set_num_threads(2)

QUAD_RATE = 250e3
# audio: f32 FIR sums, atan2 and the one-pole scan in different orders
AUDIO_ATOL = 1e-5
# FFT magnitudes of a 1024-point frame: relative to the peak
SPEC_RTOL = 1e-5
STEPS = 3
WBFM_ORDER = ["wbfm.channel", "wbfm.demod", "wbfm.audio", "wbfm.deemph"]


def _receiver(pkg, spectrum=False):
    """bench_suite.py:134-148 config 3: ComplexToneSource(10 kHz) →
    WbfmReceiver → audio sink. ``spectrum``: also the source → FFT(1024) →
    spectrum sink, as in __graft_entry__.py (its 1024 alignment rounds the
    block length to a multiple of 5120)."""
    g = pkg.Graph()
    src = pkg.global_registry.create("ComplexToneSource", frequency=10e3)
    rx = pkg.global_registry.create("WbfmReceiver", quad_rate=QUAD_RATE,
                                    audio_decim=5)
    audio = pkg.global_registry.create("VectorSink", name="audio")
    g.add(rx)
    g.connect(src, rx["in"])
    g.connect(rx["out"], audio)
    spec = None
    if spectrum:
        fft = pkg.global_registry.create("FFT", fft_size=1024, window="Hann",
                                         output="magnitude")
        spec = pkg.global_registry.create("VectorSink", name="spectrum")
        g.connect_chain(src, fft, spec)
    return g, audio, spec


def _edges_by_name(graph):
    return [(e.src.name, e.src_port, e.dst.name, e.dst_port) for e in graph.edges]


def test_flatten_matches_jax():
    """Flattened blocks, edges and topological order, by block name (the
    ``#n`` counters of unique names are per process and per package)."""
    gj, _, _ = _receiver(gr, spectrum=True)
    gt_, _, _ = _receiver(gt, spectrum=True)
    fj, ft = gj.flatten(), gt_.flatten()
    names = lambda blocks: [b.name if "#" not in b.name else type(b).__name__
                            for b in blocks]
    assert names(ft.blocks) == names(fj.blocks)
    strip = lambda es: [tuple(n if "#" not in n else n.split("#")[0] for n in e)
                        for e in es]
    assert strip(_edges_by_name(ft)) == strip(_edges_by_name(fj))
    assert names(ft.topological_order()) == names(fj.topological_order())
    assert [n for n in names(ft.topological_order()) if n.startswith("wbfm.")] \
        == WBFM_ORDER
    assert len({b.unique_name for b in ft.blocks}) == len(ft.blocks)
    # a graph without subgraphs flattens to itself
    assert ft.flatten() is ft


def test_exported_ports_and_unconnected_subgraph_input():
    rx = gt.global_registry.create("WbfmReceiver", quad_rate=QUAD_RATE,
                                   audio_decim=5, name="rx")
    assert [p.name for p in rx.in_ports] == ["in"]
    assert [p.name for p in rx.out_ports] == ["out"]
    assert rx["in"].is_output is False and rx["out"].is_output is True
    assert [b.name for b in rx.blocks] == ["rx.channel", "rx.demod", "rx.audio",
                                           "rx.deemph"]
    g = gt.Graph()
    g.add(rx)
    g.connect(rx["out"], g.emplace("NullSink"))
    with pytest.raises(ConnectionError_, match="rx.channel.in"):
        gt.compile_graph(g, block_len=5 * 1024, sample_rate=QUAD_RATE, device="cpu")


@pytest.mark.parametrize("block_len", [5 * 8192, 5 * 8191])
def test_wbfm_receiver_matches_jax(block_len):
    """block_len 5·8192 puts 8192 audio samples on the de-emphasis (the
    blocked one-pole path), 5·8191 puts 8191 (the O(log T) scan)."""
    gj, aj, _ = _receiver(gr)
    gr.Scheduler(gj, block_len=block_len, sample_rate=QUAD_RATE).run_and_wait(STEPS)
    gp, at, _ = _receiver(gt)
    sched = gt.Scheduler(gp, block_len=block_len, sample_rate=QUAD_RATE,
                         device="cpu")
    sched.run_and_wait(STEPS)
    assert [b.name for b in sched.compiled.order
            if b.name.startswith("wbfm.")] == WBFM_ORDER
    a, b = aj.data(), at.data()
    assert a.shape == b.shape == (block_len // 5 * STEPS,)
    np.testing.assert_allclose(b, a, atol=AUDIO_ATOL)
    # the tone's demod constant after the filters' transient: 10 kHz / 75 kHz
    np.testing.assert_allclose(b[block_len // 5:], 10e3 / 75e3, atol=AUDIO_ATOL)


def test_wbfm_receiver_continues_from_jax_states():
    """One step in JAX, states handed across with interop.states_from_numpy
    (FIR histories, NCO phases, the demod's last sample, the de-emphasis
    carry), then two steps in both packages with every sink input equal."""
    bl = 5 * 8192
    gj, _, _ = _receiver(gr, spectrum=True)
    gp, _, _ = _receiver(gt, spectrum=True)
    cj = gr.compile_graph(gj, block_len=bl, sample_rate=QUAD_RATE)
    ct = gt.compile_graph(gp, block_len=bl, sample_rate=QUAD_RATE, device="cpu")
    assert [b.name for b in cj.order if "#" not in b.name] == \
        [b.name for b in ct.order if "#" not in b.name]
    assert [type(b).__name__ for b in cj.order] == \
        [type(b).__name__ for b in ct.order]
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    st_j = cj.init_states()
    st_j, _ = cj.step(st_j, cj.gather_params(), {})
    st_t = states_from_numpy(jax.tree_util.tree_map(np.asarray, st_j), "cpu",
                             names)
    deemph = next(b.unique_name for b in ct.order if b.name == "wbfm.deemph")
    assert st_t[deemph].dtype == torch.float32 and st_t[deemph].shape == ()
    params_t = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, cj.gather_params()), names)
    for _ in range(2):
        st_j, out_j = cj.step(st_j, cj.gather_params(), {})
        st_t, out_t = ct.step(st_t, params_t)
        for uj, ut in names.items():
            if uj in out_j:
                a = np.asarray(out_j[uj]["in"])
                b = out_t[ut]["in"].numpy()
                np.testing.assert_allclose(
                    b, a, atol=max(AUDIO_ATOL, SPEC_RTOL * np.max(np.abs(a))))


@pytest.mark.parametrize("engine", ["scan", "parallel", "pallas"])
@pytest.mark.parametrize("ch", [0, 4])
def test_iir_filter_states_cross_from_jax(rng, engine, ch):
    """IirFilter's state in each engine's layout ([C, order] f32, [C, S]
    complex64, [C, S, 2] f32) carried across with states_from_numpy: one step
    in JAX, the next in both packages, equal outputs."""
    res = gt.ops.filter_design.design_iir("butterworth", "lowpass", 4,
                                          sample_rate=48e3, f_low=15e3)
    n = 256
    outs = []
    for pkg in (gr, gt):
        sig = import_module(pkg.__name__ + ".blocks.basic").SignalGenerator(
            signal="Sin", frequency=1e3, channels=ch)
        iir = import_module(pkg.__name__ + ".blocks.filter").IirFilter(
            b=res.b, a=res.a, engine=engine)
        g = pkg.Graph()
        g.connect_chain(sig, iir, pkg.global_registry.create("NullSink"))
        kw = {} if pkg is gr else {"device": "cpu"}
        outs.append((pkg.compile_graph(g, block_len=n, sample_rate=48e3, **kw),
                     sig, iir))
    (cj, sj, ij), (ct, sgt, it) = outs
    names = {sj.unique_name: sgt.unique_name, ij.unique_name: it.unique_name}
    st_j = cj.init_states()
    st_j, _ = cj.step(st_j, cj.gather_params(), {})
    carried = states_from_numpy(
        {k: jax.tree_util.tree_map(np.asarray, st_j[k]) for k in names}, "cpu",
        names)
    assert tuple(carried[it.unique_name].shape) == tuple(np.shape(st_j[ij.unique_name]))
    st_t = {**ct.init_states(), **carried}
    params_t = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, cj.gather_params()), names)
    st_j, out_j = cj.step(st_j, cj.gather_params(), {})
    st_t, out_t = ct.step(st_t, {**ct.gather_params(), **params_t})
    sink_j = next(iter(out_j.values()))["in"]
    sink_t = next(iter(out_t.values()))["in"]
    np.testing.assert_allclose(sink_t.numpy(), np.asarray(sink_j), atol=1e-5)
