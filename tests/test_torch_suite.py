"""Suite configs 1, 2, 4 and 7k (``bench_suite.py:103-162, 318-332``) built in
both packages as the suite builds them, with a ``VectorSink`` in place of the
``NullSink`` so that every output is compared, on the CPU at block_len
2^12–2^14; and the ported blocks' registry names, settings and ports against
the JAX package's.

Tolerances: config 1's magnitude spectra within 1e-5 of the peak (f32 FIR sums
over 127 taps, then two 4096-point FFT implementations); configs 2 and 4 within
1e-5 of the output RMS on top of the noise draws' 1e-5·max(1, |x|) (torch's
erfinv against XLA's float32 polynomial); config 7k's decoded bits exact."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

SPEC_RTOL = 1e-5
RMS_RTOL = 2e-5
STEPS = 3


def _config1(pkg):
    fd = pkg.ops.filter_design
    fs = 20e6
    g = pkg.Graph()
    src = g.emplace("ComplexToneSource", frequency=1e6)
    fir = g.emplace("FirFilter", taps=fd.design_fir(
        "lowpass", 127, sample_rate=fs, f_low=2e6).astype(np.float32))
    fft = g.emplace("FFT", fft_size=4096, window="Hann", output="magnitude",
                    calibrate=False)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, fir, fft, snk)
    return g, snk, fs


def _config2(pkg):
    g = pkg.Graph()
    src = g.emplace("NoiseSource")
    rr = g.emplace("RationalResampler", interp=3, decim=2)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, rr, snk)
    return g, snk, 1e6


def _config4(pkg):
    g = pkg.Graph()
    src = g.emplace("NoiseSource", noise="complex_gaussian")
    chan = g.emplace("PFBChannelizer", n_channels=64, taps_per_phase=8)
    mag = g.emplace("Abs")
    snk = g.emplace("VectorSink")
    g.connect_chain(src, chan, mag, snk)
    return g, snk, 1e9


def _config7k(pkg):
    g = pkg.Graph()
    src = g.emplace("NoiseSource", noise="gaussian")
    dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, dec, snk)
    return g, snk, 1e9


def _run(build, pkg, block_len):
    g, snk, fs = build(pkg)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw).run_and_wait(STEPS)
    return np.asarray(snk.data())


@pytest.mark.parametrize("block_len", [1 << 12, 1 << 14])
def test_config1_matches_jax(block_len):
    a, b = (_run(_config1, pkg, block_len) for pkg in (gr, gt))
    assert b.shape == a.shape == (STEPS * block_len,) and b.dtype == a.dtype
    np.testing.assert_allclose(b, a, atol=SPEC_RTOL * np.max(a))
    # the 1 MHz tone at 20 MHz: bin 204.8 of 4096, past the first spectrum
    assert abs(int(np.argmax(b[4096:8192])) - 204.8) < 1


def _rms_close(got, want, rtol):
    scale = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale


@pytest.mark.parametrize("block_len", [1 << 12, 1 << 14])
def test_config2_matches_jax(block_len):
    a, b = (_run(_config2, pkg, block_len) for pkg in (gr, gt))
    assert b.shape == a.shape == (STEPS * block_len * 3 // 2,)
    _rms_close(b, a, RMS_RTOL)


@pytest.mark.parametrize("block_len", [1 << 12, 1 << 14])
def test_config4_matches_jax(block_len):
    a, b = (_run(_config4, pkg, block_len) for pkg in (gr, gt))
    assert b.shape == a.shape == (64, STEPS * block_len // 64)
    assert b.dtype == a.dtype == np.float32
    _rms_close(b, a, RMS_RTOL)


def test_config7k_matches_jax():
    a, b = (_run(_config7k, pkg, 1 << 13) for pkg in (gr, gt))
    assert b.shape == a.shape == (STEPS * (1 << 13) // 2,)
    np.testing.assert_array_equal(b, a)


NEW_BLOCKS = ("Add", "Subtract", "Multiply", "Divide", "AddConst",
              "SubtractConst", "Rotator", "Abs", "Conjugate", "Log10",
              "IQDemodulator", "LockInDemodulator", "Decimator", "BasicFilter",
              "BasicDecimatingFilter", "RationalResampler", "IFFT",
              "ChannelSelect", "StreamToChannels", "ChannelsToStream",
              "LdpcEncoder", "LdpcDecoder")


# settings the port's block has beyond the JAX package's
PORT_SETTINGS = {"PFBChannelizer": {"oversample_rate"}}


@pytest.mark.parametrize("name", sorted(set(NEW_BLOCKS) | set(
    gt.global_registry.known_blocks())))
def test_block_carries_the_jax_names(name):
    """Every block of the port under the JAX package's registry name, with the
    same settings (name, kind, default, choices), ports and sample-accurate
    set; ``PORT_SETTINGS`` lists the port's own further settings."""
    assert name in gt.global_registry.known_blocks()
    # ArraySource has no default: it is built from its arrays;
    # PreambleCorrelator refuses to be built without a preamble
    kw = {"ArraySource": {"arrays": [np.zeros(8, np.float32)]},
          "PreambleCorrelator": {"preamble": [1.0, -1.0]}}.get(name, {})
    bj = gr.global_registry.create(name, **kw)
    bt = gt.global_registry.create(name, **kw)
    sj, st = bj.settings.spec, bt.settings.spec
    assert sorted(st) == sorted(set(sj) | PORT_SETTINGS.get(name, set()))
    for key in sj:
        for attr in ("kind", "choices", "unit"):
            assert getattr(st[key], attr) == getattr(sj[key], attr), (key, attr)
        assert repr(st[key].default) == repr(sj[key].default), key
    assert [p.name for p in bt.in_ports] == [p.name for p in bj.in_ports]
    assert [p.name for p in bt.out_ports] == [p.name for p in bj.out_ports]
    assert getattr(bt, "SAMPLE_ACCURATE", None) == getattr(bj, "SAMPLE_ACCURATE", None)
