"""Checkpoints across the two packages, on the CPU: the headline chain and a
noise graph (NoiseSource and SignalGenerator's GaussianNoise, both threefry)
and a modem graph (a ChannelModel into an OFDM demodulator and
pilot equalizer, whose states hold a threefry key, a uint32 phase and a bool)
and a carrier graph (every stateful block of the carrier-recovery slice)
and an acquisition graph (every stateful block of the acquisition slice)
and a FEC graph (ConvEncoder → soft ViterbiDecoder, Scrambler → Descrambler)
and a CVSD graph (CvsdEncoder → CvsdDecoder, whose states are tuples)
run 2 steps, are saved, and resume for 2 more — JAX → port, port → JAX and
port → port — against steps 3–4 of an uninterrupted run; and a checkpoint
whose state tree differs from the block's is refused, naming the key.

Tolerances: port → port bitwise; across packages the chain's spectra within
1e-5 of the peak and its audio within 1e-4 (``tests/test_torch_chain.py``'s),
the uniform noise bit for bit, the Gaussian noise within 1e-5 of max(1, |x|)
(torch's erfinv against XLA's), the carrier graph's sinks within
``CARRIER_ATOL`` (each block's parity tolerance) with the squelch's gate
exact, the FEC graph's bits and the CVSD graph's bits and audio bit for
bit, and the restored threefry keys equal. The CVSD states also cross by
``interop`` both ways."""

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


def _acquisition(pkg):
    """Every stateful block of the acquisition slice, each into a sink: a
    ClockSource's "T" tags into FunctionGenerator's clock input (uniform
    threefry noise: a key), a FunctionGenerator tone (a uint32 segment
    counter) → SavitzkyGolayFilter (a history) → SchmittTrigger (a bool);
    the noise into TriggerGate (an int32 carry) and StreamFilter (a bool);
    noise and tone into SyncBlock (two histories); and the noise as an
    uncertain stream through FirFilter and IirFilter in uncertain mode (the
    two-plane history, and the {"v", "s2"} loop states).

    ClockSource's tag timeline is a constructor argument that graph.yaml does
    not carry (in either package), so every tag falls before the save: the
    gate's window and the open StreamFilter carry across it. SchmittTrigger
    takes its band as offset ± threshold: a band given as low/high does not
    survive save_grc/load_grc in either package (ROADMAP queue 3)."""
    g = pkg.Graph(name="acquisition")
    reg = pkg.global_registry
    misc = import_module(pkg.__name__ + ".blocks.misc")
    clock = misc.ClockSource(sample_rate=FS, name="clock", tag_times=[
        i / FS for i in (100, 5000, 9000, 12000, 15000)],
        tag_values=[{"trigger_name": "T"}] * 5)
    nz = reg.create("FunctionGenerator", signal_type="UniformNoise",
                    start_value=2.0, seed=9, name="fg_noise")
    tone = reg.create("FunctionGenerator", signal_type="Sin", final_value=1.0,
                      frequency=3e4, name="fg_tone")
    g.connect(clock, nz, dst_port="clk_in")
    g.connect_chain(tone, reg.create("SavitzkyGolayFilter", window=31,
                                     poly_order=3, name="sg"),
                    reg.create("SchmittTrigger", offset=0.0, threshold=0.3,
                               name="st"),
                    reg.create("VectorSink", name="schmitt"))
    g.connect_chain(nz, reg.create("TriggerGate", filter="T", n_post=7000,
                                   name="gate"),
                    reg.create("VectorSink", name="gated"))
    g.connect_chain(nz, reg.create("StreamFilter", filter="T", name="sf"),
                    reg.create("VectorSink", name="filtered"))
    sync = reg.create("SyncBlock", n_inputs=2, max_skew=16, name="sync")
    g.connect(nz, sync["in0"])
    g.connect(tone, sync["in1"])
    for i in range(2):
        g.connect(sync[f"out{i}"], reg.create("VectorSink", name=f"sync{i}"))
    tu = reg.create("ToUncertain", sigma_const=0.1, name="tu")
    fu = reg.create("FromUncertain", name="fu")
    g.connect(nz, tu, dst_port="in")
    g.connect_chain(tu, reg.create("FirFilter", taps=(0.5, 0.3, 0.2),
                                   uncertain=True, name="ufir"),
                    reg.create("IirFilter", b=(0.2,), a=(1.0, -0.8),
                               uncertain=True, name="uiir"), fu)
    g.connect(fu["value"], reg.create("VectorSink", name="u_value"))
    g.connect(fu["sigma"], reg.create("VectorSink", name="u_sigma"))
    return g


def _fec(pkg):
    """Uniform threefry noise (bit for bit in both packages) thresholded to
    int32 bits → ConvEncoder → the coded bits as floats plus uniform noise →
    ViterbiDecoder(soft=True) (float32 metrics and an int32 decision tail);
    the bits → Scrambler → Descrambler (int32 registers)."""
    g = pkg.Graph(name="fec")
    reg = pkg.global_registry
    bits = reg.create("Convert", to="int32", name="bits")
    g.connect_chain(reg.create("NoiseSource", noise="uniform", seed=11, name="nb"),
                    reg.create("Threshold", level=0.0, name="thr"), bits)
    enc = reg.create("ConvEncoder", name="enc")
    add = reg.create("Add", n_inputs=2, name="noisy")
    g.connect(bits, enc)
    g.connect(enc, reg.create("VectorSink", name="coded"))
    cf = reg.create("Convert", to="float32", name="cf")
    g.connect(enc, cf)
    g.connect(cf, add["in0"])
    g.connect(reg.create("NoiseSource", noise="uniform", std=0.3, seed=12,
                         name="nc"), add["in1"])
    g.connect_chain(add, reg.create("ViterbiDecoder", soft=True, name="vit"),
                    reg.create("VectorSink", name="decoded"))
    scr = reg.create("Scrambler", name="scr")
    g.connect(bits, scr)
    g.connect(scr, reg.create("VectorSink", name="scrambled"))
    g.connect_chain(scr, reg.create("Descrambler", seed=0x15, name="dscr"),
                    reg.create("VectorSink", name="descrambled"))
    return g


def _cvsd(pkg):
    """Uniform threefry noise (bit for bit in both packages) → CvsdEncoder →
    CvsdDecoder, the bits and the audio sunk: the state is the tuple (est
    float32, delta float32, run int32) of each."""
    g = pkg.Graph(name="cvsd")
    reg = pkg.global_registry
    enc = reg.create("CvsdEncoder", name="cvsd_enc")
    g.connect_chain(reg.create("NoiseSource", noise="uniform", std=0.4, seed=13,
                               name="nv"), enc,
                    reg.create("CvsdDecoder", name="cvsd_dec"),
                    reg.create("VectorSink", name="cvsd_audio"))
    g.connect(enc, reg.create("VectorSink", name="cvsd_bits"))
    return g


GRAPHS = {"chain": _chain, "noise": _noise, "modem": _modem, "carrier": _carrier,
          "acquisition": _acquisition, "fec": _fec, "cvsd": _cvsd}
# the FEC graph's sinks: bits, equal across packages
FEC_EXACT = ("coded", "decoded", "scrambled", "descrambled")
# the CVSD graph's sinks: bits and audio, equal across packages (the port
# rounds est·accum_decay ± delta once, as XLA's fused multiply-add does)
CVSD_EXACT = ("cvsd_bits", "cvsd_audio")
# the CVSD loops run one step per sample: a short block keeps the case short
CVSD_BLOCK_LEN = 256
# the acquisition slice's sinks that copy or gate the bit-exact uniform noise,
# and the Schmitt gate: equal across packages
ACQ_EXACT = ("gated", "filtered", "sync0", "schmitt")
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

# the tone through SyncBlock: the two sines differ by up to one ulp of their
# float32 phase, 2π·30 kHz·t ≈ 309 rad at the run's end (tests/
# test_torch_misc_blocks.py's tone_atol)
CARRIER_ATOL["sync1"] = 1e-5 + float(np.spacing(np.float32(
    2 * np.pi * 3e4 * 4 * BLOCK_LEN / FS)))


def _block_len(name):
    if name == "cvsd":
        return CVSD_BLOCK_LEN
    return CARRIER_BLOCK_LEN if name in ("carrier", "fec") else BLOCK_LEN


def _sched(pkg, g):
    kw = {"device": "cpu"} if pkg is gt else {}
    return pkg.Scheduler(g, block_len=_block_len(g.name), sample_rate=FS, **kw)


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
        if exact or k == "uniform" or k in ACQ_EXACT or k in FEC_EXACT \
                or k in CVSD_EXACT:
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
    assert meta["step"] == 2 and meta["block_len"] == _block_len(name)
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
    if name == "acquisition":
        blob = np.load(tmp_path / "states.npz")
        assert blob["gate"].dtype == np.int32 and blob["sf"].dtype == np.bool_
        assert int(blob["gate"]) == 15000 + 7000 - 2 * BLOCK_LEN and blob["sf"]
        assert blob["st"].dtype == np.bool_ and blob["fg_tone"].dtype == np.uint32
        assert int(blob["fg_tone"]) == 2 * BLOCK_LEN
        assert blob["fg_noise"].dtype == np.uint32 and blob["fg_noise"].shape == (2,)
        assert blob["ufir"].shape == (2, 2) and blob["sg"].shape == (30,)
        assert blob["sync['h0']"].shape == (16,)
        assert blob["uiir['v']"].dtype == blob["uiir['s2']"].dtype == np.float32
        if reader is gt:
            fresh = gt.load_checkpoint(tmp_path, device="cpu")
            uname = {b.name: b.unique_name for b in fresh.compiled.order}
            gate = fresh._states[uname["gate"]]
            assert gate.dtype == torch.int32 and int(gate) == int(blob["gate"])
            assert fresh._states[uname["fg_tone"]].dtype == torch.int64
    if name == "cvsd":
        blob = np.load(tmp_path / "states.npz")
        for blk in ("cvsd_enc", "cvsd_dec"):
            assert blob[f"{blk}[0]"].dtype == blob[f"{blk}[1]"].dtype == np.float32
            assert blob[f"{blk}[2]"].dtype == np.int32
            assert blob[f"{blk}[0]"].shape == blob[f"{blk}[2]"].shape == ()
        if reader is gt:
            fresh = gt.load_checkpoint(tmp_path, device="cpu")
            uname = {b.name: b.unique_name for b in fresh.compiled.order}
            est, delta, run = fresh._states[uname["cvsd_enc"]]
            assert (est.dtype, delta.dtype, run.dtype) == \
                (torch.float32, torch.float32, torch.int32)
            assert int(run) == int(blob["cvsd_enc[2]"])
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


def _acquisition_devices(pkg):
    """The device blocks of ``_acquisition`` without the host-fed clock: a
    FunctionGenerator tone → SavitzkyGolayFilter → SchmittTrigger, the noise
    → TriggerGate and StreamFilter, both into SyncBlock, and the noise as an
    uncertain stream through FirFilter and IirFilter in uncertain mode."""
    g = pkg.Graph(name="acq_devices")
    reg = pkg.global_registry
    nz = reg.create("FunctionGenerator", signal_type="UniformNoise",
                    start_value=2.0, seed=9, name="fg_noise")
    tone = reg.create("FunctionGenerator", signal_type="Sin", final_value=1.0,
                      frequency=3e4, name="fg_tone")
    g.connect_chain(tone, reg.create("SavitzkyGolayFilter", window=31,
                                     poly_order=3, name="sg"),
                    reg.create("SchmittTrigger", offset=0.0, threshold=0.3,
                               name="st"),
                    reg.create("VectorSink", name="schmitt"))
    for btype in ("TriggerGate", "StreamFilter"):
        g.connect_chain(nz, reg.create(btype, name=btype),
                        reg.create("VectorSink", name=f"{btype}_out"))
    sync = reg.create("SyncBlock", n_inputs=2, max_skew=16, name="sync")
    g.connect(nz, sync["in0"])
    g.connect(tone, sync["in1"])
    g.connect(sync["out1"], reg.create("VectorSink", name="sync1"))
    tu = reg.create("ToUncertain", sigma_const=0.1, name="tu")
    g.connect(nz, tu, dst_port="in")
    g.connect_chain(tu, reg.create("FirFilter", taps=(0.5, 0.3, 0.2),
                                   uncertain=True, name="ufir"),
                    reg.create("IirFilter", b=(0.2,), a=(1.0, -0.8),
                               uncertain=True, name="uiir"),
                    reg.create("VectorSink", name="uncertain"))
    return g


def test_acquisition_states_continue_from_jax_by_interop():
    """Two compiled steps in JAX, the states handed across with
    ``interop.states_from_numpy`` (the counter and the threefry key, the
    histories, the Schmitt bool, the gate's int32 carry, the StreamFilter
    bool, the uncertain loop states), then two steps in both packages: the
    same state tree and leaf dtypes as the port's own, and every sink input
    within the tolerances of ``_agree`` (the tone's sines within
    ``CARRIER_ATOL['sync1']``)."""
    import jax
    from gnuradio4_tpu_torch.interop import states_from_numpy
    bl = 4096
    cj = gr.compile_graph(_acquisition_devices(gr), block_len=bl, sample_rate=FS)
    ct = gt.compile_graph(_acquisition_devices(gt), block_len=bl, sample_rate=FS,
                          device="cpu")
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    st_j = cj.init_states()
    for _ in range(2):
        st_j, _ = cj.step(st_j, cj.gather_params(), {})
    def host(a):        # a PRNG key leaf as its key data, as the docstring asks
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a = jax.random.key_data(a)
        return np.asarray(a)
    st_t = states_from_numpy(jax.tree_util.tree_map(host, st_j), "cpu", names)
    own = ct.init_states()
    assert sorted(st_t) == sorted(own)
    for k, v in own.items():
        if isinstance(v, dict):
            assert {kk: vv.dtype for kk, vv in st_t[k].items()} == \
                {kk: vv.dtype for kk, vv in v.items()}, k
        elif torch.is_tensor(v):
            assert st_t[k].dtype == v.dtype and st_t[k].shape == v.shape, k
    by_name = {b.unique_name: b.name for b in ct.order}
    uname = {v: k for k, v in by_name.items()}
    assert int(st_t[uname["fg_tone"]]) == 2 * bl
    for _ in range(2):
        st_j, out_j = cj.step(st_j, cj.gather_params(), {})
        st_t, out_t = ct.step(st_t, ct.gather_params())
    for uj, ut in names.items():
        if uj not in out_j:
            continue
        got = out_t[ut]["in"].numpy()
        want = np.asarray(out_j[uj]["in"])
        name = by_name[ut]
        if name == "sync1":
            d = np.abs(got - want)
            assert np.all(d <= CARRIER_ATOL["sync1"] * np.maximum(1, np.abs(want)))
        elif name in ("schmitt", "TriggerGate_out", "StreamFilter_out"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=NORMAL_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_checkpoint_round_trip_jax_port_jax(tmp_path, name):
    """JAX → port → JAX: a JAX checkpoint after 2 steps, loaded by the port
    and saved again unrun, holds the same leaves bit for bit (dtypes too:
    the port's int64 words go back to uint32), and the JAX package resumes
    from it to the same steps 3–4 as an uninterrupted run."""
    _save_after_two(gr, name, tmp_path / "jax")
    sched = gt.load_checkpoint(tmp_path / "jax", device="cpu")
    gt.save_checkpoint(sched, tmp_path / "port")
    with np.load(tmp_path / "jax" / "states.npz") as a, \
            np.load(tmp_path / "port" / "states.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = _resume(gr, tmp_path / "port")
    _agree(got, _uninterrupted(gr, name), exact=True)


def test_fec_states_continue_from_jax_by_interop():
    """Two compiled steps of ``_fec`` in JAX, the states handed across with
    ``interop.states_from_numpy``: the decoder's float32 ``metrics`` and
    int32 ``tail_dec``, the encoder's and scramblers' int32 registers and the
    noise keys arrive with the port's own dtypes and shapes and equal
    values; then two steps in both packages give the same bits."""
    import jax
    from gnuradio4_tpu_torch.interop import states_from_numpy
    bl = 1024
    cj = gr.compile_graph(_fec(gr), block_len=bl, sample_rate=FS)
    ct = gt.compile_graph(_fec(gt), block_len=bl, sample_rate=FS, device="cpu")
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    st_j = cj.init_states()
    for _ in range(2):
        st_j, _ = cj.step(st_j, cj.gather_params(), {})

    def host(a):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a = jax.random.key_data(a)
        return np.asarray(a)
    np_j = jax.tree_util.tree_map(host, st_j)
    st_t = states_from_numpy(np_j, "cpu", names)
    own = ct.init_states()
    uname = {b.name: b.unique_name for b in ct.order}
    jname = {b.name: b.unique_name for b in cj.order}
    vit = st_t[uname["vit"]]
    assert sorted(vit) == sorted(own[uname["vit"]]) == ["metrics", "tail_dec"]
    for leaf, dt, shape in (("metrics", torch.float32, (64,)),
                            ("tail_dec", torch.int32, (64, 64))):
        assert vit[leaf].dtype == own[uname["vit"]][leaf].dtype == dt
        assert tuple(vit[leaf].shape) == shape
        np.testing.assert_array_equal(vit[leaf].numpy(), np_j[jname["vit"]][leaf])
    assert vit["tail_dec"].any() and float(vit["metrics"].min()) == 0.0
    for blk in ("enc", "scr", "dscr"):
        assert st_t[uname[blk]].dtype == own[uname[blk]].dtype == torch.int32
        assert int(st_t[uname[blk]]) == int(np_j[jname[blk]])
    for _ in range(2):
        st_j, out_j = cj.step(st_j, cj.gather_params(), {})
        st_t, out_t = ct.step(st_t, ct.gather_params())
    by_name = {b.unique_name: b.name for b in ct.order}
    seen = set()
    for uj, ut in names.items():
        if uj in out_j:
            got, want = out_t[ut]["in"].numpy(), np.asarray(out_j[uj]["in"])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=by_name[ut])
            seen.add(by_name[ut])
    assert seen == set(FEC_EXACT)


def test_cvsd_states_cross_by_interop_both_ways():
    """CvsdEncoder → CvsdDecoder: two compiled steps in one package, the
    (est, delta, run) tuples handed across (``interop.states_from_numpy``
    into the port, ``interop.states_to_numpy`` back to the JAX package), two
    more steps in the other: the bits and the audio equal an unbroken run of
    four steps, bit for bit, both ways."""
    import jax
    import jax.numpy as jnp
    from gnuradio4_tpu_torch.interop import states_from_numpy, states_to_numpy
    bl = CVSD_BLOCK_LEN
    cj = gr.compile_graph(_cvsd(gr), block_len=bl, sample_rate=FS)
    ct = gt.compile_graph(_cvsd(gt), block_len=bl, sample_rate=FS, device="cpu")
    j2t = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    t2j = {v: k for k, v in j2t.items()}
    by_name = {b.unique_name: b.name for b in ct.order}
    uname = {b.name: b.unique_name for b in ct.order}

    def host(a):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a = jax.random.key_data(a)
        return np.asarray(a)

    def sinks_j(out):
        return {by_name[j2t[u]]: np.asarray(d["in"]) for u, d in out.items()}

    def sinks_t(out):
        return {by_name[u]: d["in"].numpy() for u, d in out.items()}

    st = cj.init_states()
    unbroken = []
    for _ in range(4):
        st, out = cj.step(st, cj.gather_params(), {})
        unbroken.append(sinks_j(out))
    assert sorted(unbroken[0]) == sorted(CVSD_EXACT)

    # JAX → port
    st_j = cj.init_states()
    for _ in range(2):
        st_j, _ = cj.step(st_j, cj.gather_params(), {})
    st_t = states_from_numpy(jax.tree_util.tree_map(host, st_j), "cpu", j2t)
    enc = st_t[uname["cvsd_enc"]]
    assert type(enc) is tuple and [a.dtype for a in enc] == \
        [torch.float32, torch.float32, torch.int32]
    for k in (2, 3):
        st_t, out = ct.step(st_t, ct.gather_params())
        for name, want in unbroken[k].items():
            np.testing.assert_array_equal(sinks_t(out)[name], want, err_msg=name)

    # port → JAX
    st_t = ct.init_states()
    for _ in range(2):
        st_t, _ = ct.step(st_t, ct.gather_params())
    back = states_to_numpy(st_t, t2j)
    enc_j = back[t2j[uname["cvsd_enc"]]]
    assert type(enc_j) is tuple and [a.dtype for a in enc_j] == \
        [np.float32, np.float32, np.int32]
    key = t2j[uname["nv"]]
    assert back[key].dtype == np.uint32
    fresh = cj.init_states()
    st_j = {k: (jax.random.wrap_key_data(jnp.asarray(v))
                if k == key and jax.dtypes.issubdtype(fresh[k].dtype,
                                                      jax.dtypes.prng_key)
                else jax.tree_util.tree_map(jnp.asarray, v))
            for k, v in back.items()}
    for k in (2, 3):
        st_j, out = cj.step(st_j, cj.gather_params(), {})
        for name, want in unbroken[k].items():
            np.testing.assert_array_equal(sinks_j(out)[name], want, err_msg=name)
