"""Checkpoints across the two packages, on the CPU: the headline chain and a
noise graph (NoiseSource and SignalGenerator's GaussianNoise, both threefry)
and a modem graph (a ChannelModel into an OFDM demodulator and
pilot equalizer, whose states hold a threefry key, a uint32 phase and a bool)
and a carrier graph (every stateful block of the carrier-recovery slice)
run 2 steps, are saved, and resume for 2 more — JAX → port, port → JAX and
port → port — against steps 3–4 of an uninterrupted run; and a checkpoint
whose state tree differs from the block's is refused, naming the key.

Tolerances: port → port bitwise; across packages the chain's spectra within
1e-5 of the peak and its audio within 1e-4 (``tests/test_torch_chain.py``'s),
the uniform noise bit for bit, the Gaussian noise within 1e-5 of max(1, |x|)
(torch's erfinv against XLA's), the carrier graph's sinks within
``CARRIER_ATOL`` (each block's parity tolerance) with the squelch's gate
exact, and the restored threefry keys equal."""

import json
from importlib import import_module

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

FS = 20e6
BLOCK_LEN = 1 << 13
SPEC_RTOL = 1e-5
AUDIO_ATOL = 1e-4
NORMAL_RTOL = 1e-5


def _chain(pkg):
    fd = import_module(pkg.__name__ + ".ops.filter_design")
    g = pkg.Graph(name="chain")
    reg = pkg.global_registry
    src = reg.create("ComplexToneSource", frequency=1e6, name="src")
    taps = fd.design_fir("lowpass", 127, sample_rate=FS, f_low=2e6)
    fir = reg.create("FreqXlatingFir", taps=taps.astype(np.float32),
                     center_freq=3e6, sample_rate_in=FS, decim=1, name="fir")
    fft = reg.create("FFT", fft_size=4096, window="Hann", output="magnitude",
                     calibrate=False, name="fft")
    dem = reg.create("QuadratureDemod", gain=1.0, name="demod")
    audio = reg.create("FirFilter", taps=fd.design_fir(
        "lowpass", 63, sample_rate=FS, f_low=1e6).astype(np.float32),
        decim=8, name="audio_fir")
    g.connect_chain(src, fir, fft, reg.create("VectorSink", name="spec"))
    g.connect(fir, dem)
    g.connect_chain(dem, audio, reg.create("VectorSink", name="audio"))
    return g


def _noise(pkg):
    g = pkg.Graph(name="noise")
    reg = pkg.global_registry
    g.connect(reg.create("NoiseSource", noise="uniform", seed=7, name="nz"),
              reg.create("VectorSink", name="uniform"))
    g.connect(reg.create("SignalGenerator", signal="GaussianNoise", seed=5,
                         amplitude=2.0, name="sg"),
              reg.create("VectorSink", name="gauss"))
    return g


def _modem(pkg):
    """Complex noise → ChannelModel (multipath, CFO, AWGN: a threefry key, a
    uint32 phase, a history) → OfdmDemodulator → OfdmChannelEqualizer (MMSE,
    EMA-smoothed: a carried estimate and a bool ``warm``)."""
    g = pkg.Graph(name="modem")
    reg = pkg.global_registry
    g.connect_chain(
        reg.create("NoiseSource", noise="complex_gaussian", seed=3, name="nz"),
        reg.create("ChannelModel", taps=(1.0, 0.4, -0.2), noise_voltage=0.05,
                   frequency_offset=0.001, seed=5, name="chan"),
        reg.create("OfdmDemodulator", fft_size=64, cp_len=0, n_occupied=48,
                   name="ofdm"),
        reg.create("OfdmChannelEqualizer", fft_size=64, n_occupied=48,
                   mode="mmse", noise_var=0.1, smoothing=0.5, name="eq"),
        reg.create("VectorSink", name="equalized"))
    return g


def _carrier(pkg):
    """A complex tone (30 kHz at 20 MHz) plus uniform threefry noise (bit for
    bit in both packages) into every stateful block of the carrier-recovery
    slice, each to its own sink: CostasLoop and PllCarrierTracking (phase,
    freq), FllBandEdge, IqImbalanceCorrector (gain, phase), FarrowResampler
    (history, float32 μ0), SnrEstimator with its EMA (m2, m4 and a bool
    ``warm``) and PowerSquelch (the envelope, its threshold inside the
    envelope's swing so the gate opens and closes)."""
    g = pkg.Graph(name="carrier")
    reg = pkg.global_registry
    iq = reg.create("RealImagToComplex", name="iq")
    g.connect(reg.create("NoiseSource", noise="uniform", std=0.3, seed=1, name="nr"),
              iq["real"])
    g.connect(reg.create("NoiseSource", noise="uniform", std=0.3, seed=2, name="ni"),
              iq["imag"])
    add = reg.create("Add", n_inputs=2, name="add")
    g.connect(reg.create("ComplexToneSource", frequency=30e3, name="tone"), add["in0"])
    g.connect(iq["out"], add["in1"])
    for btype, kw in (("CostasLoop", {"order": 2, "loop_bw": 0.05}),
                      ("PllCarrierTracking", {"loop_bw": 0.02}),
                      ("FllBandEdge", {"loop_bw": 0.05}),
                      ("IqImbalanceCorrector", {"alpha": 0.3}),
                      ("FarrowResampler", {"rate": 0.75}),
                      ("SnrEstimator", {"chunk": 256, "alpha": 0.5}),
                      ("PowerSquelch", {"threshold_db": 0.25, "alpha": 0.01})):
        g.connect_chain(add, reg.create(btype, name=btype, **kw),
                        reg.create("VectorSink", name=f"{btype}_out"))
    return g


GRAPHS = {"chain": _chain, "noise": _noise, "modem": _modem, "carrier": _carrier}
CARRIER_BLOCK_LEN = 1024
# the carrier slice's sinks across packages: the tolerances of
# tests/test_torch_dsp_extras.py and tests/test_torch_squelch.py, but for the
# FLL, which here sees no band edges (a tone in white noise): its error is
# noise, its frequency a random walk, and the walk integrates the packages'
# float32 rounding into the phase (5.1e-4 measured after 4096 samples)
CARRIER_ATOL = {"CostasLoop_out": 1e-5, "PllCarrierTracking_out": 1e-5,
                "FllBandEdge_out": 2e-3, "IqImbalanceCorrector_out": 1e-6,
                "FarrowResampler_out": 1e-6, "SnrEstimator_out": 1e-3,
                "PowerSquelch_out": 1e-6}


def _sched(pkg, g):
    kw = {"device": "cpu"} if pkg is gt else {}
    block_len = CARRIER_BLOCK_LEN if g.name == "carrier" else BLOCK_LEN
    return pkg.Scheduler(g, block_len=block_len, sample_rate=FS, **kw)


def _sinks(sched):
    return {b.name: b.data() for b in sched.graph.flatten().blocks
            if type(b).__name__ == "VectorSink"}


def _uninterrupted(pkg, name):
    s = _sched(pkg, GRAPHS[name](pkg))
    s.run_and_wait(4)
    return {k: v[..., v.shape[-1] // 2:] for k, v in _sinks(s).items()}


def _save_after_two(pkg, name, path):
    s = _sched(pkg, GRAPHS[name](pkg))
    s.run_and_wait(2)
    pkg.save_checkpoint(s, path)


def _resume(pkg, path):
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.load_checkpoint(path, **kw)
    for _ in range(2):      # run_and_wait counts from the restored step 2
        s.step_once()
    s._drain()
    return _sinks(s)


def _agree(got, want, exact=False):
    assert sorted(got) == sorted(want)
    for k in want:
        g_, w = got[k], want[k]
        assert g_.shape == w.shape and g_.dtype == w.dtype, k
        if exact or k == "uniform":
            np.testing.assert_array_equal(g_, w, err_msg=k)
        elif k == "spec":
            assert np.max(np.abs(g_ - w)) <= SPEC_RTOL * np.max(np.abs(w))
        elif k == "audio":
            assert np.max(np.abs(g_ - w)) <= AUDIO_ATOL
        elif k in CARRIER_ATOL:
            if k == "PowerSquelch_out":
                np.testing.assert_array_equal(g_ == 0, w == 0)
            d = np.abs(g_.astype(np.complex128) - w)
            assert np.all(d <= CARRIER_ATOL[k] * np.maximum(1.0, np.abs(w))), \
                (k, float(d.max()))
        else:
            assert np.max(np.abs(g_ - w) / np.maximum(2.0, np.abs(w))) <= NORMAL_RTOL


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("writer, reader", [(gr, gt), (gt, gr), (gt, gt)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_checkpoint_resumes(tmp_path, name, writer, reader):
    _save_after_two(writer, name, tmp_path)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["step"] == 2 and meta["block_len"] == (
        CARRIER_BLOCK_LEN if name == "carrier" else BLOCK_LEN)
    got = _resume(reader, tmp_path)
    want = _uninterrupted(writer if reader is gt and writer is gt else gr, name)
    _agree(got, want, exact=writer is reader)
    if name == "modem":
        blob = np.load(tmp_path / "states.npz")
        assert blob["chan['phase']"].dtype == np.uint32
        assert blob["eq['warm']"].dtype == np.bool_ and blob["eq['warm']"]
    if name == "carrier":
        blob = np.load(tmp_path / "states.npz")
        assert blob["SnrEstimator['warm']"].dtype == np.bool_
        assert blob["SnrEstimator['warm']"]
        assert blob["FarrowResampler['mu0']"].dtype == np.float32
        if reader is gt:
            fresh = gt.load_checkpoint(tmp_path, device="cpu")
            uname = {b.name: b.unique_name for b in fresh.compiled.order}
            warm = fresh._states[uname["SnrEstimator"]]["warm"]
            assert warm.dtype == torch.bool and bool(warm)
    if name == "noise" and reader is gt:
        # the restored threefry keys are the saved uint32 words
        blob = np.load(tmp_path / "states.npz")
        fresh = gt.load_checkpoint(tmp_path, device="cpu")
        uname = {b.name: b.unique_name for b in fresh.compiled.order}
        for blk in ("nz", "sg"):
            key = fresh._states[uname[blk]]
            assert key.dtype == torch.int64 and blob[blk].dtype == np.uint32
            np.testing.assert_array_equal(key.numpy(), blob[blk].astype(np.int64))


def test_checkpoint_layout_matches_jax(tmp_path):
    _save_after_two(gr, "chain", tmp_path / "jax")
    _save_after_two(gt, "chain", tmp_path / "port")
    bj, bt = np.load(tmp_path / "jax" / "states.npz"), np.load(tmp_path / "port" / "states.npz")
    assert sorted(bj.files) == sorted(bt.files)
    assert "fir['phase']" in bt.files and "src" in bt.files
    for k in bj.files:
        assert bt[k].dtype == bj[k].dtype and bt[k].shape == bj[k].shape, k
    assert bt["src"].dtype == np.uint32
    mj = json.loads((tmp_path / "jax" / "meta.json").read_text())
    mt = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert mt == mj


@pytest.mark.parametrize("tamper, match", [
    ("drop", r"block 'demod': checkpoint missing state leaf 'demod'"),
    ("extra", r"block 'fir' has state leaf \"fir\['extra'\]\""),
    ("shape", r"block 'audio_fir': state shape mismatch for 'audio_fir'"),
    ("dtype", r"state dtype mismatch for 'demod'"),
])
def test_differing_state_tree_is_refused(tmp_path, tamper, match):
    _save_after_two(gt, "chain", tmp_path)
    with np.load(tmp_path / "states.npz") as npz:
        blob = {k: npz[k] for k in npz.files}
    if tamper == "drop":
        del blob["demod"]
    elif tamper == "extra":
        blob["fir['extra']"] = np.zeros(3, np.float32)
    elif tamper == "shape":
        blob["audio_fir"] = blob["audio_fir"][:-1]
    else:
        blob["demod"] = blob["demod"].astype(np.complex128)
    np.savez(tmp_path / "states.npz", **blob)
    with pytest.raises(GrError, match=match):
        gt.load_checkpoint(tmp_path, device="cpu")


def test_checkpoint_without_card_needs_cpu(tmp_path):
    _save_after_two(gt, "noise", tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(GrError, match="device=\"cpu\""):
        gt.load_checkpoint(tmp_path)
