"""The port's ``blocks/dsp_extras.py``, ``ops/farrow.py`` and the carrier loop
of ``ops/demod.py`` against the JAX package's, on the CPU: every case of
``tests/test_dsp_extras.py`` but Agc, SoftDemapper and ComplexExpRamp, run
through both packages from the same seeded NumPy inputs, the JAX test's own
assertions held on the port's output; and the registry names and settings of
every block type this slice added.

Tolerances:
- ``FF_ATOL`` = 1e-6 · max(1, |y|) for the feed-forward blocks (Farrow,
  IQ imbalance): a few float32 ulps of the output;
- ``COARSE_ATOL`` = 1e-4 · max(1, |y|) for the coarse CFO corrector: the
  two FFT implementations' rounding moves the parabolic sub-bin estimate,
  and the correction ramp carries that over the step (3.1e-5 measured at
  the end of an 8192-sample step);
- ``LOOP_ATOL`` = 1e-5 · max(1, |y|) per sample for the carrier loops (PLL
  and Costas at every order), on the JAX tests' inputs (≤ 2e-6 measured).
  None of the Costas detectors' signs flips on these inputs (Costas at order
  4 and 8 would otherwise part there); after lock the decisions are held
  equal too;
- ``FLL_ATOL`` = 2e-4 · max(1, |y|) per sample for the FLL: its phase
  integrates the frequency estimate's float32 rounding over the run (4.8e-5
  measured after 65536 samples);
- Goertzel power: ``GOERTZEL_RTOL`` = 1e-4 of the chunk's power scale, plus
  the float32 conditioning of s1² + s2² − c·s1·s2 (16 ulps of its terms'
  magnitudes, which near DC and Nyquist dwarf the power), against the JAX
  package's float32 recurrence and a float64 one;
- ``SNR_ATOL`` = 1e-3 dB for the SNR estimator: N = M2 − S cancels, which
  scales the moments' float32 rounding by the SNR (1.05e-4 dB measured at
  20 dB).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import demod as jdemod
from gnuradio4_tpu.ops import farrow as jfarrow
from gnuradio4_tpu_torch.ops import demod as tdemod
from gnuradio4_tpu_torch.ops import farrow as tfarrow

torch.set_num_threads(2)

SEED = 20261017
FF_ATOL = 1e-6
COARSE_ATOL = 1e-4
LOOP_ATOL = 1e-5
FLL_ATOL = 2e-4
GOERTZEL_RTOL = 1e-4
SNR_ATOL = 1e-3

NEW_TYPES = {
    "dsp_extras": ("FarrowResampler", "GoertzelDetector", "IqImbalanceCorrector",
                   "CoarseFrequencyCorrector", "PllCarrierTracking", "CostasLoop",
                   "FllBandEdge", "SnrEstimator"),
    "squelch": ("PowerSquelch", "CtcssSquelch"),
    "rds": ("RdsSource", "RdsDecoder"),
    "monitor": ("ImChartMonitor", "WaterfallMonitor"),
}


def _run(pkg, btype, settings, x, *, block_len, fs=1e6):
    """VectorSource(x) → btype → VectorSink until the source ends; returns
    (sink data, the block's final state)."""
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(btype, **settings)
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=x), blk, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw)
    s.run_and_wait()
    return np.asarray(snk.data()), s._states[blk.unique_name]


def _both(btype, settings, x, *, block_len, fs=1e6):
    (yt, st), (yj, sj) = (_run(pkg, btype, settings, x, block_len=block_len, fs=fs)
                          for pkg in (gt, gr))
    return yt, yj, st, sj


def _close(got, want, atol, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    d = np.abs(got.astype(np.complex128) - want)
    assert np.all(d <= atol * np.maximum(1.0, np.abs(want))), \
        (what, float(np.max(d)), int(np.argmax(d)))


def _state_close(st, sj, atol, what=""):
    for k in sj:
        w = np.asarray(sj[k])
        g = st[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, rtol=atol, atol=atol, err_msg=f"{what} {k}")


# -- registry -------------------------------------------------------------------

def _spec(blk):
    return {k: (s.kind, s.choices, s.unit, s.limits, repr(s.default))
            for k, s in blk.settings.spec.items()}


@pytest.mark.parametrize("name", [n for g in NEW_TYPES.values() for n in g])
def test_new_type_carries_the_jax_name_and_settings(name):
    """Registered in both packages as the same type with the same settings
    (kind, choices, unit, limits, default), ports, ratio and alignment; and
    the registry's entry is the port module's class."""
    bj, bt = gr.global_registry.create(name), gt.global_registry.create(name)
    assert type(bt).__name__ == type(bj).__name__ == name
    assert _spec(bt) == _spec(bj)
    assert [(p.name, p.dtype) for p in bt.in_ports] == \
        [(p.name, p.dtype) for p in bj.in_ports]
    assert [(p.name, p.dtype) for p in bt.out_ports] == \
        [(p.name, p.dtype) for p in bj.out_ports]
    assert (bt.ratio, bt.alignment) == (bj.ratio, bj.alignment)
    assert bt.is_drawable == bj.is_drawable
    assert getattr(bt, "FEED", False) == getattr(bj, "FEED", False)
    module = next(m for m, g in NEW_TYPES.items() if name in g)
    mod = __import__(f"gnuradio4_tpu_torch.blocks.{module}", fromlist=["x"])
    assert gt.global_registry.get(name) is getattr(mod, name)


def test_console_debug_sink_alias_builds_an_imchart_monitor():
    for pkg in (gr, gt):
        b = pkg.global_registry.create("ConsoleDebugSink", stream="none")
        assert type(b).__name__ == "ImChartMonitor" and b.is_drawable
        assert b.settings.get("stream") == "none"


# -- Farrow ------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.75, 1.0, 1.5, 0.9837])
def test_farrow_tone_frequency_preserved(rate):
    fs, f0, n = 48000.0, 1000.0, 48000
    x = np.sin(2 * np.pi * f0 * np.arange(n) / fs).astype(np.float32)
    y, yj, st, sj = _both("FarrowResampler", {"rate": rate}, x,
                          block_len=8000, fs=fs)
    _close(y, yj, FF_ATOL, f"farrow {rate}")
    _state_close(st, sj, FF_ATOL, f"farrow {rate}")
    # the JAX test's assertions, on the port's output
    fs_out = fs * rate
    assert abs(len(y) - n * rate) <= 8000 * rate + 1
    seg = y[1000:1000 + 8192]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * fs_out / len(seg) - f0) < fs_out / len(seg) * 1.5
    assert abs(np.max(np.abs(seg)) - 1.0) < 0.02


def test_farrow_sine_waveform_accuracy():
    fs, rate, n = 1000.0, 4.0 / 3.0, 3000
    x = np.sin(2 * np.pi * 50.0 * np.arange(n) / fs).astype(np.float32)
    y, yj, _, _ = _both("FarrowResampler", {"rate": rate}, x, block_len=600, fs=fs)
    _close(y, yj, FF_ATOL, "farrow 4/3")
    t_out = (np.arange(len(y)) * (1.0 / rate) - 2.0) / fs
    np.testing.assert_allclose(y[10:-10], np.sin(2 * np.pi * 50.0 * t_out)[10:-10],
                               atol=5e-3)


@pytest.mark.parametrize("complex_in", [False, True])
def test_farrow_apply_op_two_channels_two_calls(complex_in):
    """The op on [2, T] (the blocks' multi-channel form), the state carried
    from one call into the next, equal to the JAX op's within FF_ATOL."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 2 * 1000)).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    ratio, n_out = 1.0 / 0.9837, int(1000 * 0.9837)
    st = tfarrow.farrow_init_state(2, torch.from_numpy(x).dtype)
    sj = jfarrow.farrow_init_state(2, jnp.asarray(x).dtype)
    for h in (slice(0, 1000), slice(1000, 2000)):
        yt, st = tfarrow.farrow_apply(torch.from_numpy(x[:, h]), st,
                                      ratio=ratio, n_out=n_out)
        yj, sj = jfarrow.farrow_apply(jnp.asarray(x[:, h]), sj,
                                      ratio=ratio, n_out=n_out)
        _close(yt.numpy(), np.asarray(yj), FF_ATOL, "farrow op")
        _state_close(st, sj, FF_ATOL, "farrow op")


# -- Goertzel ------------------------------------------------------------------------

def _goertzel_f64(x, freq, fs):
    """The float64 Goertzel recurrence over the last axis: (power, the
    float32 rounding bound of its power formula)."""
    x = np.asarray(x, np.float64)
    c = 2.0 * np.cos(2.0 * np.pi * freq / fs)
    s1 = s2 = np.zeros(x.shape[:-1])
    for n in range(x.shape[-1]):
        s1, s2 = x[..., n] + c * s1 - s2, s1
    norm = x.shape[-1] ** 2 / 4.0
    cond = 16 * 2.0 ** -24 * (s1 * s1 + s2 * s2 + np.abs(c * s1 * s2)) / norm
    return (s1 * s1 + s2 * s2 - c * s1 * s2) / norm, cond


@pytest.mark.parametrize("freq, chunk", [(941.0, 1024), (1336.0, 1024), (0.0, 256),
                                         (4000.0, 512), (88.5, 2048), (3999.0, 64)])
def test_goertzel_power_against_jax_and_float64(freq, chunk):
    """The Chebyshev-product form against the JAX package's float32
    recurrence and a float64 recurrence, on noise plus a tone at ``freq``;
    errors relative to the chunk's power scale mean(x²)·4 (the normalized
    bin power of a full-scale tone is its amplitude squared)."""
    fs = 8000.0
    rng = np.random.default_rng(SEED)
    n = np.arange(4 * chunk)
    x = (0.5 * np.sin(2 * np.pi * freq / fs * n + 0.3)
         + 0.2 * rng.standard_normal(4 * chunk)).astype(np.float32).reshape(4, chunk)
    pt = tfarrow.goertzel_power(torch.from_numpy(x), freq=freq, sample_rate=fs).numpy()
    pj = np.stack([np.asarray(jfarrow.goertzel_power(jnp.asarray(r), freq=freq,
                                                     sample_rate=fs)) for r in x])
    p64, cond = _goertzel_f64(x, freq, fs)
    tol = GOERTZEL_RTOL * 4.0 * np.mean(x.astype(np.float64) ** 2, axis=-1) + cond
    assert pt.dtype == np.float32 and pt.shape == (4,)
    assert np.all(np.abs(pt - pj) <= 2 * tol), (pt, pj, tol)
    assert np.all(np.abs(pt - p64) <= tol), (pt, p64, tol)


def test_goertzel_detects_target_tone_only():
    fs, n = 8000.0, 8192
    x = np.sin(2 * np.pi * 941.0 * np.arange(n) / fs).astype(np.float32)
    for f, hit in ((941.0, True), (1336.0, False)):
        y, yj, _, _ = _both("GoertzelDetector", {"frequency": f, "chunk": 1024,
                                                 "sample_rate_in": fs},
                            x, block_len=2048, fs=fs)
        assert y.shape == yj.shape == (8,)
        assert np.all(np.abs(y - yj) <= GOERTZEL_RTOL * 2.0)
        if hit:
            np.testing.assert_allclose(y, 1.0, atol=0.05)
        else:
            assert np.all(y < 0.01)


# -- PLL ---------------------------------------------------------------------------

def test_pll_removes_carrier_offset():
    fs, f_off = 100e3, 500.0
    x = np.exp(2j * np.pi * f_off / fs * np.arange(65536)).astype(np.complex64)
    y, yj, st, sj = _both("PllCarrierTracking", {"loop_bw": 0.02}, x,
                          block_len=16384, fs=fs)
    _close(y, yj, LOOP_ATOL, "pll")
    _state_close(st, sj, LOOP_ATOL, "pll")
    tail = y[40000:]
    assert np.abs(np.mean(np.angle(tail[1:] * np.conj(tail[:-1])))) < 1e-3
    np.testing.assert_allclose(np.abs(tail), 1.0, atol=1e-2)


def test_polar_discriminator_pll_op():
    """The demod PLL's error stream and end state over two calls, the state
    carried, against the JAX op's."""
    rng = np.random.default_rng(SEED)
    n = 2048
    x = (np.exp(1j * (0.01 * np.arange(2 * n) + 0.4))
         + 0.05 * (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
         ).astype(np.complex64)
    pt, ft = torch.zeros(()), torch.zeros(())
    pj, fj = jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)
    for h in (slice(0, n), slice(n, 2 * n)):
        et, pt, ft = tdemod.polar_discriminator_pll(
            torch.from_numpy(x[h]), pt, ft, loop_bw=0.05, fs=1e6)
        ej, pj, fj = jdemod.polar_discriminator_pll(
            jnp.asarray(x[h]), pj, fj, loop_bw=0.05, fs=1e6)
        _close(et.numpy(), np.asarray(ej), LOOP_ATOL, "pll op")
        np.testing.assert_allclose([float(pt), float(ft)], [float(pj), float(fj)],
                                   atol=LOOP_ATOL)
    # locked: the error stream settles to the noise
    assert np.abs(et.numpy()[-512:]).mean() < 0.1


# -- IQ imbalance, coarse CFO --------------------------------------------------------

def test_iq_imbalance_corrects_gain_and_phase_skew(rng):
    n = 65536
    clean = np.exp(2j * np.pi * rng.random(n)).astype(np.complex64)
    i, q = clean.real, clean.imag
    skewed = (i + 1j * (0.8 * q - 0.1 * i)).astype(np.complex64)
    y, yj, st, sj = _both("IqImbalanceCorrector", {"alpha": 0.4}, skewed,
                          block_len=8192)
    _close(y, yj, FF_ATOL, "iq imbalance")
    _state_close(st, sj, FF_ATOL, "iq imbalance")
    assert abs(np.mean(y[32768:] ** 2)) < 0.2 * abs(np.mean(skewed[32768:] ** 2))


@pytest.mark.parametrize("order, w", [(4, 2 * np.pi * 0.003), (2, -0.02), (8, 0.004)])
def test_coarse_cfo_removes_psk_offset(order, w):
    """tests/test_dsp_extras.py's QPSK case, and BPSK and 8PSK beside it."""
    rng = np.random.default_rng(SEED)
    n = 32768
    pts = np.exp(1j * (2 * np.pi / order * rng.integers(0, order, n)
                       + (np.pi / 4 if order == 4 else 0.0)))
    x = (pts * np.exp(1j * w * np.arange(n))).astype(np.complex64)
    y, yj, st, sj = _both("CoarseFrequencyCorrector", {"order": order}, x,
                          block_len=8192)
    _close(y, yj, COARSE_ATOL, f"coarse cfo {order}")
    _state_close(st, sj, COARSE_ATOL, f"coarse cfo {order}")
    spec = np.abs(np.fft.fft(y[16384:] ** order))
    assert np.argmax(spec) in (0, 1, len(spec) - 1)


# -- Costas -----------------------------------------------------------------------

def _psk(order, cfo, ph0, nsym=16384, seed=0):
    rng = np.random.default_rng(seed)
    off = 0.0 if order == 2 else np.pi / order
    pts = np.exp(1j * (off + 2 * np.pi / order * rng.integers(0, order, nsym)))
    return (pts * np.exp(1j * (cfo * np.arange(nsym) + ph0))).astype(np.complex64)


def _decisions(y, order):
    off = 0.0 if order == 2 else np.pi / order
    return np.round(np.angle(y * np.exp(-1j * off)) / (2 * np.pi / order)) % order


@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_locks_on_residual_carrier(order):
    x = _psk(order, 0.003, 0.7)
    y, yj, st, sj = _both("CostasLoop", {"order": order, "loop_bw": 0.05}, x,
                          block_len=4096)
    _close(y, yj, LOOP_ATOL, f"costas {order}")
    _state_close(st, sj, LOOP_ATOL, f"costas {order}")
    np.testing.assert_array_equal(_decisions(y[10000:], order),
                                  _decisions(yj[10000:], order))
    off = 0.0 if order == 2 else np.pi / order
    ang = np.angle(y[10000:] * np.exp(-1j * off))
    err = np.abs(((ang + np.pi / order) % (2 * np.pi / order)) - np.pi / order)
    assert np.degrees(err.mean()) < 4.0


def test_costas_state_continuity_across_blocks():
    """512-sample steps against 4096-sample steps in the port (the JAX test's
    2e-5), and the 512-sample run against the JAX package's."""
    x = _psk(4, 0.002, 0.3)
    y1, _ = _run(gt, "CostasLoop", {"order": 4, "loop_bw": 0.05}, x, block_len=4096)
    y2, yj, _, _ = _both("CostasLoop", {"order": 4, "loop_bw": 0.05}, x,
                         block_len=512)
    np.testing.assert_allclose(y1, y2, atol=2e-5)
    _close(y2, yj, LOOP_ATOL, "costas 512")


# -- FLL -------------------------------------------------------------------------

def _shaped_qpsk(nsym=16384, sps=4, alpha=0.35, cfo=0.0, seed=0):
    from gnuradio4_tpu_torch.ops.digital import rrc_taps
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    ups = np.zeros(nsym * sps, complex)
    ups[::sps] = syms
    shaped = np.convolve(ups, rrc_taps(sps, 11 * sps + 1, beta=alpha))[: nsym * sps]
    return (shaped * np.exp(1j * cfo * np.arange(len(shaped)))).astype(np.complex64)


@pytest.mark.parametrize("cfo", [0.02, -0.05])
def test_fll_acquires_cfo(cfo):
    x = _shaped_qpsk(cfo=cfo)
    settings = {"samples_per_symbol": 4, "rolloff": 0.35, "loop_bw": 0.05}
    y, yj, st, sj = _both("FllBandEdge", settings, x, block_len=8192)
    _close(y, yj, FLL_ATOL, f"fll {cfo}")
    _state_close(st, sj, FLL_ATOL, f"fll {cfo}")
    assert abs(float(st["freq"]) - cfo) < 0.005


def test_fll_tail_and_subblock_seams():
    """A step that is no multiple of the sub-block: the tail is rotated with
    the final estimate and the phase carried, in both packages alike."""
    x = _shaped_qpsk(nsym=3000, cfo=0.03)
    settings = {"samples_per_symbol": 4, "rolloff": 0.35, "loop_bw": 0.05,
                "subblock": 100, "filter_size": 33}
    y, yj, st, sj = _both("FllBandEdge", settings, x, block_len=1000)
    _close(y, yj, FLL_ATOL, "fll tail")
    _state_close(st, sj, FLL_ATOL, "fll tail")


def test_fll_costas_cascade_zeroes_cfo():
    x = _shaped_qpsk(cfo=0.04)
    outs = {}
    for pkg in (gt, gr):
        g = pkg.Graph()
        reg = pkg.global_registry
        snk = reg.create("VectorSink")
        g.connect_chain(reg.create("VectorSource", data=x),
                        reg.create("FllBandEdge", samples_per_symbol=4,
                                   rolloff=0.35, loop_bw=0.05),
                        reg.create("CostasLoop", order=4, loop_bw=0.02), snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=8192, sample_rate=1e6, **kw).run_and_wait()
        outs[pkg] = np.asarray(snk.data())
    _close(outs[gt], outs[gr], FLL_ATOL, "fll → costas")
    y = outs[gt][-16384:]
    S = np.abs(np.fft.fftshift(np.fft.fft(y ** 4)))
    f = np.fft.fftshift(np.fft.fftfreq(len(y)))
    assert abs(f[np.argmax(S)] * 2 * np.pi / 4) < 1e-3


# -- SNR estimator ------------------------------------------------------------------

def _noisy_qpsk(snr_db, n=65536, seed=0):
    rng = np.random.default_rng(seed)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    npow = 10 ** (-snr_db / 10)
    return (sym + np.sqrt(npow / 2) * (rng.standard_normal(n)
                                       + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("snr", [3.0, 10.0, 20.0])
def test_snr_estimator_accuracy(snr):
    y, yj, _, _ = _both("SnrEstimator", {"chunk": 4096}, _noisy_qpsk(snr),
                        block_len=4 * 4096)
    assert y.shape == yj.shape == (16,) and y.dtype == np.float32
    np.testing.assert_allclose(y, yj, atol=SNR_ATOL)
    assert abs(np.mean(y) - snr) < 0.5


def test_snr_estimator_ema_smooths_variance():
    x = _noisy_qpsk(10.0)
    raw, _, _, _ = _both("SnrEstimator", {"chunk": 512}, x, block_len=4 * 512)
    smooth, sj_y, st, sj = _both("SnrEstimator", {"chunk": 512, "alpha": 0.9}, x,
                                 block_len=4 * 512)
    np.testing.assert_allclose(smooth, sj_y, atol=SNR_ATOL)
    assert st["warm"].dtype == torch.bool and bool(st["warm"])
    _state_close(st, sj, 1e-5, "snr ema")
    assert np.std(smooth[16:]) < 0.5 * np.std(raw[16:])
    assert abs(np.mean(smooth[32:]) - 10.0) < 0.7
