"""The port's hardware drivers against the JAX package's, on the CPU: every
case of ``tests/test_rtl2832.py``, ``tests/test_soapy.py`` and
``tests/test_alsa.py`` in the port, and the two RTL2832U drivers side by side
on one ``FakeRtlUsb`` seed (the same control transfers, the same samples, the
same FM audio).

The SoapySDR and ALSA bindings run against fakes compiled from
``tests/fake_soapy.cpp`` and ``tests/fake_alsa.cpp`` into a temporary
directory (skipped without ``g++``, as the JAX tests are). No case needs a
radio or a sound card.

Tolerances: register values, control-transfer logs and u8 → complex64
samples exact (one NumPy generator, the native u8iq converter in both); the
WBFM audio of the port against the JAX package within 1e-5 (f32 FIRs, demod
and de-emphasis in two libraries); tone frequencies within two FFT bins, as
the JAX tests hold them.
"""

import ctypes
import ctypes.util
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import rtl2832 as jrtl
from gnuradio4_tpu.blocks import sdr as jsdr
from gnuradio4_tpu_torch.blocks import alsa as talsa
from gnuradio4_tpu_torch.blocks import audio as taudio
from gnuradio4_tpu_torch.blocks import rtl2832 as trtl
from gnuradio4_tpu_torch.blocks import sdr as tsdr
from gnuradio4_tpu_torch.blocks import soapy as tsoapy
from gnuradio4_tpu_torch.blocks.usb import FakeUsbDevice, enumerate_usb_devices
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

HERE = Path(__file__).parent
AUDIO_ATOL = 1e-5
RTL = {gr: jrtl, gt: trtl}


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return pkg.Scheduler(g, **kw)


def _fake_lib(tmp_path_factory, name: str, src: str) -> str:
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = tmp_path_factory.mktemp(name) / f"lib{name}.so"
    r = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++20",
                        str(HERE / src), "-o", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return str(out)


# -- USB (TestUsbAbstraction) ---------------------------------------------------

def test_usb_enumeration_runs():
    assert isinstance(enumerate_usb_devices(), list)


def test_fake_usb_logs_transfers():
    f = FakeUsbDevice()
    f.open()
    f.control_out(0x40, 0, 0x2000, 0x0110, b"\x09")
    assert f.control_log[-1] == ("out", 0, 0x2000, 0x0110, b"\x09")
    assert f.control_in(0xC0, 0, 1, 2, 4) == b"\x00" * 4
    assert f.bulk_read(0x81, 6) == b"\x80" * 6


# -- the RTL2832U + R820T driver (TestRtl2832Driver) ---------------------------

def _open(mod=trtl, **kw):
    fake = mod.FakeRtlUsb(**kw)
    drv = mod.Rtl2832Device(usb=fake)
    drv.open()
    return drv, fake


def test_power_on_sequence():
    drv, fake = _open()
    assert fake.regs[(0x0200, trtl.DEMOD_CTL)] == 0xE8
    assert fake.regs[(0x0100, 0x2158)] == 0x0002
    assert set(range(0x05, 0x20)) <= set(fake.tuner)


def test_tuner_detection_and_rejection():
    drv, fake = _open()
    assert fake._ctrl_in(0x34, 0x0600, 1)[0] == trtl.R820T_CHIP_ID

    class NoTuner(trtl.FakeRtlUsb):
        def _ctrl_in(self, value, index, length):
            if index == 0x0600 and value == 0x34:
                return b"\xff" * length
            return super()._ctrl_in(value, index, length)

    with pytest.raises(GrError, match="tuner"):
        trtl.Rtl2832Device(usb=NoTuner()).open()


def test_sample_rate_register_roundtrip():
    drv, fake = _open()
    actual = drv.set_sample_rate(2.048e6)
    assert fake.sample_rate == pytest.approx(actual, rel=1e-9)
    assert actual == pytest.approx(2.048e6, rel=1e-4)
    with pytest.raises(GrError):
        drv.set_sample_rate(10e6)


@pytest.mark.parametrize("freq", [100e6, 433.92e6, 868e6, 1.09e9, 24.1e6])
def test_pll_frequency_roundtrip(freq):
    drv, fake = _open()
    actual = drv.set_center_frequency(freq)
    assert abs(actual - freq) < 2e3
    assert fake.center_frequency == pytest.approx(actual, abs=1.0)
    jdrv, _ = _open(jrtl)
    assert jdrv.set_center_frequency(freq) == actual


def test_gain_steps_and_agc():
    drv, fake = _open()
    assert drv.set_tuner_gain(28.5) == pytest.approx(28.0, abs=1.0)
    assert (fake.tuner[0x05] & 0x0F) == 8
    drv.set_agc_mode(True)
    assert fake.demod[(0, 0x19)] == 0x25


def test_eeprom_parse():
    drv, _ = _open()
    info = drv.eeprom_info()
    assert info["vid"] == 0x0BDA and info["pid"] == 0x2838


def test_stream_tone_at_expected_offset():
    drv, fake = _open(rf_tones=[100.05e6], tone_amps=[0.9])
    fs = drv.set_sample_rate(1.024e6)
    drv.set_center_frequency(100e6)
    x = drv.read_samples(65536)
    assert x.dtype == np.complex64 and x.shape == (65536,)
    freq = np.fft.fftfreq(len(x), 1 / fs)[int(np.argmax(np.abs(np.fft.fft(x))))]
    assert abs(freq - (100.05e6 - drv.center_frequency)) < 2 * fs / len(x)


def _session(mod, **fake_kw):
    """The same driver calls through one package's driver; its control log
    and the samples it read."""
    drv, fake = _open(mod, **fake_kw)
    drv.set_sample_rate(2.4e6)
    drv.set_center_frequency(100e6)
    drv.set_tuner_gain(20.0)
    drv.set_agc_mode(False)
    drv.reset_buffer()
    x = np.concatenate([drv.read_samples(40_000), drv.read_samples(24_000)])
    drv.read_eeprom(16)
    return fake.control_log, x


def test_both_drivers_send_the_same_transfers_and_read_the_same_samples():
    kw = dict(rf_tones=[100.07e6, 99.9e6], tone_amps=[0.4, 0.3])
    log_t, x_t = _session(trtl, **kw)
    log_j, x_j = _session(jrtl, **kw)
    assert len(log_t) > 100 and log_t == log_j
    assert x_t.dtype == x_j.dtype == np.complex64
    np.testing.assert_array_equal(x_t, x_j)


def test_rtlsdr_driver_is_registered():
    assert "rtlsdr" in tsdr._SDR_DRIVERS
    assert tsdr._SDR_DRIVERS["rtlsdr"].__name__ == "RtlSdrDevice"


def test_rtlsdr_without_a_dongle_raises():
    """Without hardware the driver enumerates no dongle and refuses to open
    (nothing is faked on the real path)."""
    dev = tsdr._SDR_DRIVERS["rtlsdr"](device_index=99)
    with pytest.raises(GrError, match="no RTL2832 dongle"):
        dev.configure(sample_rate=2.4e6, center_frequency=100e6)


# -- SdrSource(driver="rtlsdr") (TestRtlSdrSourceBlock, TestRtlFmAcceptance) ---

def test_graph_receives_station():
    fake = trtl.FakeRtlUsb(rf_tones=[100.1e6], tone_amps=[0.8])
    dev = trtl._make_rtlsdr_device()(usb=fake)
    g = gt.Graph()
    src = g.add(tsdr.SdrSource(driver="rtlsdr", device=dev, sample_rate=1.024e6,
                               center_frequency=100e6, gain=20.0))
    head = g.emplace("HeadBlock", n_samples=1 << 16)
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(src, head, snk)
    _sched(gt, g, block_len=1 << 14, sample_rate=1.024e6,
           pipeline_depth=1).run_and_wait()
    x = np.asarray(snk.data())
    assert x.shape == (1 << 16,)
    fs = dev.sample_rate
    freq = np.fft.fftfreq(len(x), 1 / fs)[int(np.argmax(np.abs(np.fft.fft(x))))]
    assert abs(freq - (100.1e6 - dev.center_frequency)) < 2 * fs / len(x)


def _fm_through_rtl(pkg, n=1 << 18, fs=1.024e6, audio_decim=16):
    fc, station, f_tone, max_dev = 100.0e6, 100.1e6, 2000.0, 75e3
    t = np.arange(n) / fs
    phase = 2 * np.pi * np.cumsum(max_dev * np.sin(2 * np.pi * f_tone * t)) / fs
    fake = RTL[pkg].FakeRtlUsb(waveform=0.8 * np.exp(1j * phase),
                               waveform_freq=station)
    dev = RTL[pkg]._make_rtlsdr_device()(usb=fake)
    g = pkg.Graph()
    src = g.emplace("SdrSource", driver="rtlsdr", sample_rate=fs,
                    center_frequency=fc)
    src._dev = dev
    head = g.emplace("HeadBlock", n_samples=n)
    rx = (tsdr if pkg is gt else jsdr).make_wbfm_receiver(quad_rate=fs, audio_decim=audio_decim,
                                    center_freq=station - fc, max_dev=max_dev)
    snk = pkg.global_registry.create("VectorSink")
    g.add(rx)
    g.connect(src, head)
    g.connect(head, rx["in"])
    g.connect(rx["out"], snk)
    _sched(pkg, g, block_len=1 << 16, sample_rate=fs, pipeline_depth=1).run_and_wait()
    return np.asarray(snk.data()), fs / audio_decim, f_tone


def test_fm_station_through_protocol_driver():
    """An FM station on the fake dongle's 8-bit IQ → rtlsdr driver → WBFM
    receiver: the 2 kHz tone dominates the audio, and the port's audio equals
    the JAX package's within AUDIO_ATOL."""
    audio, fs_a, f_tone = _fm_through_rtl(gt)
    n = 1 << 18
    assert audio.shape[0] >= n // 16 - 64
    settled = audio[len(audio) // 4:]
    spec = np.abs(np.fft.rfft(settled * np.hanning(len(settled))))
    k = int(np.argmax(spec[1:])) + 1
    assert abs(k * fs_a / len(settled) - f_tone) < 60.0
    assert spec[k - 2:k + 3].sum() > 0.25 * spec[1:].sum()
    want, _, _ = _fm_through_rtl(gr)
    assert want.shape == audio.shape
    np.testing.assert_allclose(audio, want, atol=AUDIO_ATOL, rtol=0)


# -- SoapySDR (tests/test_soapy.py) -------------------------------------------

@pytest.fixture(scope="module")
def soapy_lib(tmp_path_factory):
    return _fake_lib(tmp_path_factory, "FakeSoapySDR", "fake_soapy.cpp")


def test_soapy_enumerate_and_configure(soapy_lib):
    assert tsoapy.SoapyBinding(soapy_lib).enumerate() == 1
    dev = tsoapy.SoapyDevice(lib_path=soapy_lib)
    dev.configure(sample_rate=1.024e6, center_frequency=100e6, gain=6.0)
    assert dev.sample_rate == pytest.approx(1.024e6)
    dev.activate()
    x, info = dev.read_stream(4096)
    dev.deactivate()
    assert info == {} and x.shape == (4096,) and x.dtype == np.complex64


def test_soapy_stream_tone_at_offset(soapy_lib):
    dev = tsoapy.SoapyDevice(lib_path=soapy_lib)
    dev.configure(sample_rate=1.024e6, center_frequency=100e6)
    dev.activate()
    x, _ = dev.read_stream(65536)
    dev.deactivate()
    freq = np.fft.fftfreq(len(x), 1 / dev.sample_rate)[int(np.argmax(np.abs(np.fft.fft(x))))]
    assert abs(freq - 50e3) < 2 * dev.sample_rate / len(x)


def test_soapy_sdr_source_graph(soapy_lib, monkeypatch):
    monkeypatch.setitem(tsdr._SDR_DRIVERS, "soapy", None)
    tsoapy.register(lib_path=soapy_lib)
    g = gt.Graph()
    src = g.emplace("SdrSource", driver="soapy", sample_rate=1.024e6,
                    center_frequency=100e6)
    head = g.emplace("HeadBlock", n_samples=1 << 15)
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(src, head, snk)
    _sched(gt, g, block_len=1 << 13, sample_rate=1.024e6,
           pipeline_depth=1).run_and_wait()
    x = np.asarray(snk.data())
    assert x.shape == (1 << 15,)
    freq = np.fft.fftfreq(len(x), 1 / 1.024e6)[int(np.argmax(np.abs(np.fft.fft(x))))]
    assert abs(freq - 50e3) < 2 * 1.024e6 / len(x)


def test_soapy_missing_library_clear_error():
    with pytest.raises(GrError, match="libSoapySDR"):
        tsoapy.SoapyBinding("/nonexistent/libSoapySDR.so")


def test_soapy_registered_only_with_its_library():
    """Where libSoapySDR does not load, the port registers no 'soapy' driver
    at import, as the JAX package does (nothing is faked on the real path);
    checked in a fresh process."""
    import sys
    have = ctypes.util.find_library("SoapySDR") is not None
    code = ("import sys; from gnuradio4_tpu_torch.blocks import sdr; "
            "sys.exit(0 if ('soapy' in sdr._SDR_DRIVERS) == %r else 1)" % have)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


# -- ALSA (tests/test_alsa.py) ---------------------------------------------------

@pytest.fixture(scope="module")
def alsa_lib(tmp_path_factory):
    return _fake_lib(tmp_path_factory, "FakeAsound", "fake_alsa.cpp")


def test_alsa_capture_tone(alsa_lib):
    b = talsa.AlsaBackend(lib_path=alsa_lib)
    b.open_capture(48000.0, 1)
    x = b.read(48000)
    b.close()
    assert x.shape == (48000,)
    assert abs(np.argmax(np.abs(np.fft.rfft(x))) * 48000.0 / len(x) - 440.0) < 2.0


def test_alsa_playback_roundtrip(alsa_lib):
    b = talsa.AlsaBackend(lib_path=alsa_lib)
    b.open_playback(48000.0, 1)
    sig = np.sin(2 * np.pi * 1000 / 48000 * np.arange(4096)).astype(np.float32)
    b.write(sig)
    played = np.empty(4096, np.float32)
    n = b.lib.fake_alsa_played(played.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               4096)
    b.close()
    assert n == 4096
    np.testing.assert_array_equal(played[:n], sig[:n])


def test_alsa_audio_source_block_graph(alsa_lib, monkeypatch):
    monkeypatch.setitem(taudio._BACKENDS, "alsa", None)
    talsa.register(lib_path=alsa_lib)
    g = gt.Graph()
    src = g.emplace("AudioSource", backend="alsa", sample_rate=48000.0)
    head = g.emplace("HeadBlock", n_samples=16384)
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(src, head, snk)
    _sched(gt, g, block_len=4096, sample_rate=48000.0, pipeline_depth=1).run_and_wait()
    x = np.asarray(snk.data())
    assert x.shape == (16384,)
    assert abs(np.argmax(np.abs(np.fft.rfft(x))) * 48000.0 / len(x) - 440.0) < 4.0


def test_alsa_missing_library_clear_error():
    with pytest.raises(GrError, match="libasound|asound"):
        talsa.AlsaBackend(lib_path="/nonexistent/libasound.so")


def test_zmq_blocks_registered_in_both_packages_iff_pyzmq_imports():
    """The JAX package and the port register the ZeroMQ blocks exactly when
    ``import zmq`` works."""
    names = {"ZmqPushSink", "ZmqPullSource", "ZmqPubSink", "ZmqSubSource"}
    have = importlib.util.find_spec("zmq") is not None
    for pkg in (gt, gr):
        assert (names <= set(pkg.global_registry.known_blocks())) == have
