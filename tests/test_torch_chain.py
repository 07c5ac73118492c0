"""Parity of the PyTorch port's blocks, compiler and scheduler against the JAX
package, on the CPU: the headline chain of bench.py built in both packages from
the same settings, every sink compared; state handed from JAX to the port
mid-stream; and the port's import kept free of JAX."""

import os
import subprocess
import sys
from importlib import import_module
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.block import BlockCtx as JBlockCtx
from gnuradio4_tpu_torch.core.block import BlockCtx as TBlockCtx
from gnuradio4_tpu_torch.core.errors import GrError, LifecycleError
from gnuradio4_tpu_torch.interop import params_from_numpy, states_from_numpy
from gnuradio4_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

FS = 20e6
# FFT magnitudes of a 4096-point frame reach ~1e3: compare relative to the peak
SPEC_RTOL = 1e-5
# demod/audio: f32 atan2 of f32 FIR outputs
AUDIO_ATOL = 1e-4


def _chain(pkg, sink="VectorSink"):
    """bench.py's headline chain in ``pkg`` (gnuradio4_tpu or the port)."""
    basic = import_module(pkg.__name__ + ".blocks.basic")
    filt = import_module(pkg.__name__ + ".blocks.filter")
    four = import_module(pkg.__name__ + ".blocks.fourier")
    sdr = import_module(pkg.__name__ + ".blocks.sdr")
    fd = import_module(pkg.__name__ + ".ops.filter_design")
    g = pkg.Graph()
    src = basic.ComplexToneSource(frequency=1e6)
    taps = fd.design_fir("lowpass", 127, sample_rate=FS, f_low=2e6)
    fir = filt.FreqXlatingFir(taps=taps.astype(np.float32), center_freq=3e6,
                              sample_rate_in=FS, decim=1)
    fft = four.FFT(fft_size=4096, window="Hann", output="magnitude",
                   calibrate=False)
    dem = sdr.QuadratureDemod(gain=1.0)
    audio = filt.FirFilter(taps=fd.design_fir("lowpass", 63, sample_rate=FS,
                                              f_low=1e6).astype(np.float32),
                           decim=8)
    s1 = g.emplace(sink, name="spec")
    s2 = g.emplace(sink, name="audio")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    return g, fir, s1, s2


def _assert_sinks_close(a, b):
    (sa, aa), (sb, ab) = a, b
    assert sa.shape == sb.shape and aa.shape == ab.shape
    np.testing.assert_allclose(sb, sa, atol=SPEC_RTOL * np.max(np.abs(sa)))
    np.testing.assert_allclose(ab, aa, atol=AUDIO_ATOL)


@pytest.mark.parametrize("absorb", [True, False])
def test_chain_matches_jax(monkeypatch, absorb):
    if not absorb:
        monkeypatch.setenv("GR4TPU_NO_ROTATION_ABSORB", "1")
    bl, steps = 1 << 14, 3
    g, fir_j, s1, s2 = _chain(gr)
    gr.Scheduler(g, block_len=bl, sample_rate=FS).run_and_wait(steps)
    h, fir_t, t1, t2 = _chain(gt)
    gt.Scheduler(h, block_len=bl, sample_rate=FS, device="cpu").run_and_wait(steps)
    assert fir_j._rotation_absorbed == fir_t._rotation_absorbed == absorb
    assert t1.data().shape == (bl * steps,) and t2.data().shape == (bl * steps // 8,)
    _assert_sinks_close((s1.data(), s2.data()), (t1.data(), t2.data()))


def test_chain_continues_from_jax_states():
    """One step in JAX, states handed across with interop.states_from_numpy,
    two more in the port — equal to three steps in JAX."""
    bl = 1 << 14
    g, _, _, _ = _chain(gr)
    h, _, _, _ = _chain(gt)
    cj = gr.compile_graph(g, block_len=bl, sample_rate=FS)
    ct = gt.compile_graph(h, block_len=bl, sample_rate=FS, device="cpu")
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    assert [type(b).__name__ for b in cj.order] == \
        [type(b).__name__ for b in ct.order]
    st_j = cj.init_states()
    st_j, _ = cj.step(st_j, cj.gather_params(), {})
    st_t = states_from_numpy(jax.tree_util.tree_map(np.asarray, st_j), "cpu",
                             names)
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


def test_states_from_numpy_types():
    tree = {"a": {"hist": np.zeros(3, np.complex64), "phase": np.uint32(7)},
            "b": None, "c": np.ones((), np.complex64)}
    got = states_from_numpy(tree, "cpu", {"a": "A"})
    assert got["A"]["phase"].dtype == torch.int64 and int(got["A"]["phase"]) == 7
    assert got["A"]["hist"].dtype == torch.complex64
    assert got["b"] is None and got["c"].dtype == torch.complex64
    p = params_from_numpy({"a": {"_dphi": np.uint32(3), "gain": np.float64(2)}})
    assert p["a"]["_dphi"].dtype == np.uint32


def test_rate_algebra_matches_jax():
    g, _, _, _ = _chain(gr)
    h, _, _, _ = _chain(gt)
    ij, oj = g.resolve_rates(1 << 14, FS)
    it, ot = h.resolve_rates(1 << 14, FS)
    order_j, order_t = g.topological_order(), h.topological_order()
    assert [ij[b.unique_name] for b in order_j] == [it[b.unique_name] for b in order_t]
    assert [oj[b.unique_name] for b in order_j] == [ot[b.unique_name] for b in order_t]


def test_registry_names_and_settings_match_jax():
    for name in ("SignalGenerator", "ComplexToneSource", "FirFilter",
                 "FreqXlatingFir", "FFT", "QuadratureDemod", "NullSink",
                 "VectorSink", "CountingSink"):
        bj = gr.global_registry.create(name)
        bt = gt.global_registry.create(name)
        assert sorted(bj.settings.keys()) == sorted(bt.settings.keys()), name
        assert bj.settings.as_dict() == bt.settings.as_dict(), name


@pytest.mark.parametrize("settings", [
    dict(signal="Sin", frequency=1234.5, amplitude=0.5, offset=0.25),
    dict(signal="Cos", frequency=-700.0, dtype="complex64", phase=1.0),
    dict(signal="Sin", frequency=900.0, dtype="complex64"),
    dict(signal="Square", frequency=333.0, amplitude=200.0, dtype="int8"),
    dict(signal="Triangle", frequency=50.0, channels=2),
])
def test_signal_generator_matches_jax(settings):
    """SignalGenerator through each package's scheduler, with EOS after
    n_samples (a partial last step)."""
    out = []
    for pkg, kw in ((gr, {}), (gt, {"device": "cpu"})):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", n_samples=10000, **settings)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        pkg.Scheduler(g, block_len=4096, sample_rate=48000.0, **kw).run_and_wait()
        out.append(np.asarray(snk.data()))
    assert out[0].shape == out[1].shape and out[1].shape[-1] == 10000
    np.testing.assert_allclose(out[1], out[0], atol=1e-5)


@pytest.mark.parametrize("output", ["complex", "magnitude", "magnitude_db",
                                    "power"])
@pytest.mark.parametrize("stride", [0, 1024])
def test_fft_block_matches_jax(rng, output, stride):
    from gnuradio4_tpu.blocks.fourier import FFT as JFFT
    from gnuradio4_tpu_torch.blocks.fourier import FFT as TFFT
    n, t = 4096, 3 * 4096
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    kw = dict(fft_size=n, window="Hann", output=output, stride=stride)
    bj, bt = JFFT(**kw), TFFT(**kw)
    ctx = dict(in_len={"in": t}, out_len={"out": t * n // (stride or n)},
               sample_rate=FS, params={}, channels={"in": 0, "out": 0},
               dtypes={"in": np.dtype(np.complex64)})
    sj, oj = bj.apply(bj.init_state(JBlockCtx(**ctx)), {"in": jnp.asarray(x)},
                      JBlockCtx(**ctx))
    st, ot = bt.apply(bt.init_state(TBlockCtx(**ctx)), {"in": torch.from_numpy(x)},
                      TBlockCtx(**ctx))
    a, b = np.asarray(oj["out"]), ot["out"].numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, atol=SPEC_RTOL * np.max(np.abs(a)))
    if stride:
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _run_block(pkg, blk, chunks, ctx_kw, params=None):
    """Apply one block over ``chunks`` in ``pkg`` with a hand-made ctx."""
    ctx = (JBlockCtx if pkg is gr else TBlockCtx)(**ctx_kw, params=params or {})
    st = blk.init_state(ctx)
    outs = []
    for x in chunks:
        xin = jnp.asarray(x) if pkg is gr else torch.from_numpy(x)
        st, o = blk.apply(st, {"in": xin}, ctx)
        outs.append(np.asarray(o["out"]) if pkg is gr else o["out"].numpy())
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("kind", ["FreqXlatingFir", "FFT", "QuadratureDemod"])
def test_absorption_blocks_match_jax(rng, absorb, kind):
    """The three blocks the rotation-absorption pass touches, with the flags the
    compiler sets (absorbed: FreqXlatingFir skips its NCO, FFT folds the
    residual into a complex window, QuadratureDemod folds a phasor inside arg),
    and without, over three chunks of complex noise."""
    fs, fc, n = 1e6, 123e3, 4096
    chunks = _cx_chunks(rng, 3, n)
    ctx_kw = dict(in_len={"in": n}, out_len={"out": n}, sample_rate=fs,
                  channels={"in": 0, "out": 0},
                  dtypes={"in": np.dtype(np.complex64)})
    outs = []
    for pkg in (gr, gt):
        fd = import_module(pkg.__name__ + ".ops.filter_design")
        taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=100e3)
        xl = pkg.global_registry.create(
            "FreqXlatingFir", taps=taps.astype(np.float32), center_freq=fc,
            sample_rate_in=fs)
        desc = xl.rotation_descriptor(fs)
        params = {}
        if kind == "FreqXlatingFir":
            blk = xl
            blk._rotation_absorbed = absorb
        elif kind == "FFT":
            blk = pkg.global_registry.create("FFT", fft_size=1024,
                                             window="Hann", output="magnitude")
        else:
            blk = pkg.global_registry.create("QuadratureDemod", gain=2.5)
            params = {"gain": np.asarray(2.5)}
        if kind != "FreqXlatingFir":
            blk._absorbed_rotation = {"in": desc} if absorb else {}
        outs.append(_run_block(pkg, blk, chunks, ctx_kw, params))
    a, b = outs
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, atol=max(AUDIO_ATOL,
                                              SPEC_RTOL * np.max(np.abs(a))))


def _cx_chunks(rng, k, n):
    x = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    return list(x.astype(np.complex64))


def test_unported_options_raise():
    """FirFilter's uncertain mode raises on a stream that is not the 2-plane
    (value, sigma) pair, as in the JAX package (the mode itself is ported:
    tests/test_torch_uncertain.py). Its bf16 rung and the FFT's bf16 matmul
    engine are ported now (tests/test_torch_precision.py): they run, and
    agree with the JAX package."""
    g = gt.Graph()
    g.connect_chain(g.emplace("ComplexToneSource", frequency=1e3),
                    g.emplace("FirFilter", taps=(0.5, 0.5), uncertain=True),
                    g.emplace("NullSink"))
    with pytest.raises(GrError, match="uncertain"):
        gt.Scheduler(g, block_len=1024, sample_rate=1e4,
                     device="cpu").run_and_wait(1)
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("ComplexToneSource", frequency=1e3)
        fir = g.emplace("FirFilter", taps=(0.5, 0.5), precision="bf16")
        fft = g.emplace("FFT", fft_size=1024, engine="matmul_bf16")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fir, fft, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=1024, sample_rate=1e4,
                      **kw).run_and_wait(1)
        outs.append(snk.data())
    assert outs[1].shape == outs[0].shape == (1024,)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5,
                               atol=1e-5 * np.abs(outs[0]).max())


def test_batch_steps_stack_sink_inputs():
    """compile_graph(batch_steps=S): S sub-steps per call, sink inputs stacked
    [S, ...] and equal to S single steps."""
    outs = []
    for s in (1, 3):
        h, _, _, _ = _chain(gt, sink="NullSink")
        c = gt.compile_graph(h, block_len=1 << 13, sample_rate=FS,
                             batch_steps=s, device="cpu")
        st = c.init_states()
        got = []
        for _ in range(3 // s):
            st, sink_ins = c.step(st, c.gather_params())
            spec = next(v["in"] for k, v in sink_ins.items()
                        if k.startswith("NullSink") and v["in"].dtype == torch.float32
                        and v["in"].shape[-1] == (1 << 13))
            got.append(spec.reshape(-1, 1 << 13))
        outs.append(torch.cat(got).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_scheduler_lifecycle_and_null_sink_counts():
    h, _, s1, s2 = _chain(gt, sink="NullSink")
    sched = gt.Scheduler(h, block_len=1 << 13, sample_rate=FS, device="cpu")
    assert sched.state is gt.State.IDLE
    assert sched.step_once() and sched.step_once()
    assert sched.state is gt.State.RUNNING and sched.steps == 2
    assert s1.count == 2 << 13 and s2.count == (2 << 13) // 8
    with pytest.raises(LifecycleError):
        sched.fsm.transition_to(gt.State.IDLE)
    sched.run_and_wait(3)
    assert sched.state is gt.State.STOPPED and sched.steps == 3
    with pytest.raises(GrError, match="STOPPED"):
        sched.step_once()


def test_import_does_not_load_jax():
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import gnuradio4_tpu_torch, sys; "
         "assert 'jax' not in sys.modules and 'gnuradio4_tpu' not in sys.modules; "
         "assert 'triton' not in sys.modules"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    pkg = Path(gt.__file__).resolve().parent
    for f in pkg.rglob("*.py"):
        text = f.read_text()
        for bad in ("import jax", "from jax", "import gnuradio4_tpu\n",
                    "from gnuradio4_tpu ", "from gnuradio4_tpu.", "import triton"):
            assert bad not in text, (f, bad)


def test_cpu_kernel_wrappers_count_no_launch(rng):
    ck.reset_launch_counts()
    h, _, _, _ = _chain(gt, sink="NullSink")
    gt.Scheduler(h, block_len=1 << 13, sample_rate=FS, device="cpu").run_and_wait(2)
    assert ck.launch_counts() == dict.fromkeys(
        ("fir_banded", "nco_mix", "iir_sos", "fir_demod", "one_pole",
         "fir_banded.phase_groups"), 0)
