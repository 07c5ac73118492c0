"""The port's SDR blocks (AmDemod, SsbDemod, FmStereoDecoder, SdrSource and
SdrSink on a LoopbackDevice) and file IO blocks (FileSource/FileSink with the
wire formats, WavSource/WavSink) against the JAX package, on the CPU, and
``examples/fm_receiver.yaml`` run in both packages on a loopback FM station.

Tolerances: the demodulators within 1e-5 of the output's scale (f32 FIR sums
over up to 129 taps and f32 transcendentals in different orders, as
``tests/test_torch_wbfm.py``'s ``AUDIO_ATOL``); the fm_receiver WAVs within 1
LSB of 16-bit PCM (the headers byte for byte); file round trips exact."""

import wave

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import sdr as jsdr
from gnuradio4_tpu_torch.blocks import sdr as tsdr

torch.set_num_threads(2)

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
FS = 240e3
N = 4800
STEPS = 3
SEED = 20261017
ATOL = 1e-5


def _run(pkg, build, steps=STEPS, block_len=N, fs=FS):
    g, sinks = build(pkg)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw).run_and_wait(steps)
    return {k: s.data() for k, s in sinks.items()}


def _iq(n=N * STEPS):
    rng = np.random.default_rng(SEED)
    t = np.arange(n) / FS
    # an AM/SSB-ish test signal: two tones and noise, complex baseband
    x = (0.6 + 0.3 * np.cos(2 * np.pi * 700 * t)) * np.exp(2j * np.pi * 1200 * t)
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _mpx(n=N * STEPS):
    """An FM stereo composite: L = 1 kHz, R = 2.5 kHz, pilot at 19 kHz."""
    t = np.arange(n) / FS
    left, right = np.sin(2 * np.pi * 1e3 * t), 0.5 * np.sin(2 * np.pi * 2.5e3 * t)
    x = (0.45 * (left + right) + 0.1 * np.sin(2 * np.pi * 19e3 * t)
         + 0.45 * (left - right) * np.sin(2 * np.pi * 38e3 * t))
    return x.astype(np.float32)


def _single(block_type, settings, data, outs):
    def build(pkg):
        g = pkg.Graph()
        reg = pkg.global_registry
        src = reg.create("VectorSource", data=data)
        blk = reg.create(block_type, **settings)
        g.connect(src, blk)
        sinks = {}
        for port in outs:
            sinks[port] = reg.create("VectorSink")
            g.connect(blk[port], sinks[port])
        return g, sinks
    return build


@pytest.mark.parametrize("block_type, settings, data, outs", [
    ("AmDemod", {"gain": 2.0}, "iq", ["out"]),
    ("SsbDemod", {"sideband": "usb", "bandwidth": 2700.0}, "iq", ["out"]),
    ("SsbDemod", {"sideband": "lsb", "ntaps": 63, "sample_rate_in": FS}, "iq", ["out"]),
    ("FmStereoDecoder", {}, "mpx", ["left", "right"]),
], ids=["am", "ssb_usb", "ssb_lsb", "fm_stereo"])
def test_demodulators_match_jax(block_type, settings, data, outs):
    x = _iq() if data == "iq" else _mpx()
    build = _single(block_type, settings, x, outs)
    want, got = _run(gr, build), _run(gt, build)
    for port in outs:
        assert got[port].dtype == want[port].dtype == np.float32
        scale = max(1.0, float(np.max(np.abs(want[port]))))
        np.testing.assert_allclose(got[port], want[port], rtol=0, atol=ATOL * scale)


def test_fm_stereo_separates_left_and_right():
    build = _single("FmStereoDecoder", {}, _mpx(N * 8), ["left", "right"])
    out = _run(gt, build, steps=8)
    f = np.fft.rfftfreq(N * 4, 1 / FS)
    for port, tone in (("left", 1e3), ("right", 2.5e3)):
        spec = np.abs(np.fft.rfft(out[port][-N * 4:]))
        assert abs(f[np.argmax(spec)] - tone) < 100, port


def _fm_station(n=int(FS)):
    t = np.arange(n) / FS
    phase = 2 * np.pi * 75e3 * np.cumsum(0.5 * np.sin(2 * np.pi * 1e3 * t)) / FS
    return np.exp(1j * phase)


@pytest.fixture
def fm_station():
    """``driver: fmstation`` in both packages: a LoopbackDevice carrying an
    FM-modulated 1 kHz tone at 100 MHz."""
    wf = _fm_station()
    for mod in (jsdr, tsdr):
        mod.register_sdr_driver(
            "fmstation", lambda mod=mod: mod.LoopbackDevice(
                waveform=wf, waveform_freq=100e6))
    yield
    for mod in (jsdr, tsdr):
        mod._SDR_DRIVERS.pop("fmstation", None)


def test_fm_receiver_yaml_in_both_packages(tmp_path, fm_station):
    src = (ROOT / "examples" / "fm_receiver.yaml").read_text().replace(
        "driver: loopback", "driver: fmstation")
    pcm = {}
    for name, pkg, kw in (("jax", gr, {}), ("port", gt, {"device": "cpu"})):
        path = tmp_path / f"{name}.wav"
        sched = pkg.run_grc(src.replace("/tmp/fm_audio.wav", str(path)),
                            n_steps=4, scheduler_kwargs=kw)
        wav = next(b for b in sched.graph.blocks if b.name == "wav")
        wav.stop()
        assert wav.n_written == 4 * 24000 // 5
        pcm[name] = path.read_bytes()
    assert pcm["port"][:44] == pcm["jax"][:44]
    a = np.frombuffer(pcm["jax"][44:], "<i2").astype(int)
    b = np.frombuffer(pcm["port"][44:], "<i2").astype(int)
    assert a.shape == b.shape == (4 * 24000 // 5,)
    assert np.max(np.abs(a - b)) <= 1
    spec = np.abs(np.fft.rfft(b[4800:].astype(float)))
    assert np.fft.rfftfreq(len(b) - 4800, 1 / 48000)[np.argmax(spec[1:]) + 1] == 1000.0


def test_sdr_source_tags_and_sink_records():
    out = []
    for pkg in (gr, gt):
        mod = jsdr if pkg is gr else tsdr
        dev = mod.LoopbackDevice(tone_freqs=(100.01e6,), total_samples=3 * 1000 + 200)
        tx = mod.LoopbackDevice()
        g = pkg.Graph()
        src = mod.SdrSource(device=dev, sample_rate=1e6, center_frequency=100e6)
        sink = mod.SdrSink(device=tx)
        tags = pkg.global_registry.create("TagSink")
        g.connect(src, sink)
        g.connect(src, tags)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=1000, sample_rate=1e6, **kw).run_and_wait()
        out.append((np.concatenate(tx.tx_record), [t.map for t in tags.tags][:1]))
    (xj, tj), (xt, tt) = out
    np.testing.assert_array_equal(xt, xj)
    assert xt.shape == (3200,)
    assert tt == tj and tt[0]["sample_rate"] == 1e6


@pytest.mark.parametrize("dtype", ["float32", "complex64", "int16"])
def test_file_sink_then_source_round_trips(tmp_path, dtype):
    rng = np.random.default_rng(SEED)
    x = (rng.standard_normal(5000) * 100).astype(dtype) if dtype != "complex64" else \
        (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(dtype)
    path = tmp_path / "x.bin"
    g = gt.Graph()
    snk = gt.global_registry.create("FileSink", path=str(path))
    g.connect(gt.global_registry.create("VectorSource", data=x), snk)
    gt.Scheduler(g, block_len=1024, device="cpu").run_and_wait()
    snk.stop()
    assert path.read_bytes() == x.tobytes()
    g = gt.Graph()
    src = gt.global_registry.create("FileSource", path=str(path), dtype=dtype)
    back = gt.global_registry.create("VectorSink")
    g.connect(src, back)
    gt.Scheduler(g, block_len=1024, device="cpu").run_and_wait()
    np.testing.assert_array_equal(back.data(), x)


@pytest.mark.parametrize("wire", ["i16", "u8", "i16iq", "u8iq"])
def test_file_source_wire_formats_match_jax(tmp_path, wire):
    rng = np.random.default_rng(SEED)
    raw = (rng.integers(-30000, 30000, 6000).astype(np.int16) if wire.startswith("i16")
           else rng.integers(0, 255, 6000).astype(np.uint8))
    path = tmp_path / "raw.bin"
    path.write_bytes(raw.tobytes())
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = pkg.global_registry.create("FileSource", path=str(path),
                                         wire_format=wire, offset_items=10)
        snk = pkg.global_registry.create("VectorSink")
        g.connect(src, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=512, **kw).run_and_wait()
        out.append(snk.data())
    assert out[1].dtype == out[0].dtype
    np.testing.assert_array_equal(out[1], out[0])


def test_wav_sink_bytes_and_wav_source(tmp_path):
    rng = np.random.default_rng(SEED)
    x = np.clip(rng.standard_normal((2, 4000)) * 0.3, -1, 1).astype(np.float32)
    files = {}
    for name, pkg in (("jax", gr), ("port", gt)):
        path = tmp_path / f"{name}.wav"
        g = pkg.Graph()
        snk = pkg.global_registry.create("WavSink", path=str(path), sample_rate=22050.0)
        g.connect(pkg.global_registry.create("VectorSource", data=x), snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=1000, **kw).run_and_wait()
        snk.stop()
        files[name] = path.read_bytes()
    assert files["port"][:44] == files["jax"][:44]
    assert files["port"] == files["jax"]
    with wave.open(str(tmp_path / "port.wav")) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 22050, 4000)
    g = gt.Graph()
    src = gt.global_registry.create("WavSource", path=str(tmp_path / "port.wav"))
    back = gt.global_registry.create("VectorSink")
    g.connect(src, back)
    gt.Scheduler(g, block_len=1000, device="cpu").run_and_wait()
    np.testing.assert_allclose(back.data(), x, atol=1 / 32768 + 1e-7)
