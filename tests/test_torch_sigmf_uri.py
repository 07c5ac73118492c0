"""The port's SigMF recordings, URI factory and audio blocks against the JAX
package's, on the CPU: every case of ``tests/test_sigmf.py``, of
``tests/test_uri.py`` and of ``tests/test_io_blocks.py``'s ``TestAudio``
through both packages, recordings written by each package and read by the
other, and the port's WAV file audio backend.

Tolerances: recordings, replays and URIs are bitwise equal across the two
packages (the blocks only copy and convert; ``ci16_le`` rounds half to even
at ×32767 and reads ÷32768 in both); a ``ci16_le`` round trip of samples
inside the unit square within two int16 steps (2/32768: half a step of
rounding, and up to one step from the ×32767/÷32768 scales); WAV round trips within half a 16-bit step
(0.6/32768); the RTTY text, tags and annotations exact.
"""

import json
import os
import uuid
import wave

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import sigmf as jsigmf
from gnuradio4_tpu.blocks import uri as juri
from gnuradio4_tpu_torch.blocks import sigmf as tsigmf
from gnuradio4_tpu_torch.blocks import uri as turi
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

SEED = 20261018
PKGS = {"jax": gr, "port": gt}
SIGMF = {gr: jsigmf, gt: tsigmf}
URI = {gr: juri, gt: turi}
CI16_ATOL = 2.0 / 32768
WAV_ATOL = 0.6 / 32768


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return pkg.Scheduler(g, **kw)


def _reg(pkg, name, **kw):
    return pkg.global_registry.create(name, **kw)


def _replay(pkg, base, block_len=2048, sample_rate=48000.0):
    g = pkg.Graph()
    src = g.emplace("SigmfSource", path=base)
    snk = g.add(_reg(pkg, "VectorSink"))
    g.connect(src, snk)
    _sched(pkg, g, block_len=block_len, sample_rate=sample_rate).run_and_wait()
    return np.asarray(snk.data()), snk.tags


# -- helpers (TestHelpers) -----------------------------------------------------

@pytest.mark.parametrize("dtype,name", [
    (np.complex64, "cf32_le"), (np.float32, "rf32_le"), (np.int16, "ri16_le"),
    (np.uint8, "ru8"), (np.complex128, "cf64_le"), (np.int8, "ri8")])
def test_datatype_roundtrip(tmp_path, dtype, name):
    base = str(tmp_path / "rec")
    x = (np.arange(100) % 17).astype(dtype)
    tsigmf.write_sigmf(base, x, sample_rate=1e6)
    y, meta = tsigmf.read_sigmf(base)
    assert meta["global"]["core:datatype"] == name
    assert meta["global"]["core:version"] == tsigmf.SIGMF_VERSION
    np.testing.assert_array_equal(y, x)
    yj, metaj = jsigmf.read_sigmf(base)
    np.testing.assert_array_equal(yj, y)
    assert metaj == meta


def test_ci16_quantized(tmp_path):
    base = str(tmp_path / "rec")
    iq = (0.5 * np.exp(2j * np.pi * 0.01 * np.arange(500))).astype(np.complex64)
    tsigmf.write_sigmf(base, iq, sample_rate=2e6, frequency=433e6,
                       datatype="ci16_le")
    y, meta = tsigmf.read_sigmf(base)
    assert meta["captures"][0]["core:frequency"] == 433e6
    assert y.dtype == np.complex64
    assert np.abs(y - iq).max() < 1e-4         # sub-LSB of int16


def test_ci8_written_and_read(tmp_path):
    """ci8 is converted on write (×127, rounded, clipped) and on read (÷128)."""
    base = str(tmp_path / "rec")
    iq = (0.9 * np.exp(2j * np.pi * 0.013 * np.arange(300))).astype(np.complex64)
    tsigmf.write_sigmf(base, iq, sample_rate=1e6, datatype="ci8")
    assert os.path.getsize(base + ".sigmf-data") == 2 * len(iq)
    y, meta = tsigmf.read_sigmf(base)
    assert meta["global"]["core:datatype"] == "ci8"
    np.testing.assert_allclose(y, iq, atol=2.0 / 127)
    yj, _ = jsigmf.read_sigmf(base)
    np.testing.assert_array_equal(y, yj)


def test_meta_is_valid_json_file_pair(tmp_path):
    base = str(tmp_path / "rec")
    tsigmf.write_sigmf(base, np.zeros(8, np.float32), sample_rate=1.0)
    assert os.path.exists(base + ".sigmf-data")
    meta = json.loads(open(base + ".sigmf-meta").read())
    assert set(meta) == {"global", "captures", "annotations"}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unsupported_datatype_raises(tmp_path, pkg):
    base = str(tmp_path / "rec")
    tsigmf.write_sigmf(base, np.zeros(8, np.float32), sample_rate=1.0)
    meta = json.loads(open(base + ".sigmf-meta").read())
    meta["global"]["core:datatype"] = "cq128_le"
    open(base + ".sigmf-meta", "w").write(json.dumps(meta))
    with pytest.raises(Exception, match="unsupported datatype"):
        SIGMF[PKGS[pkg]].read_sigmf(base)


# -- written by one package, read by the other --------------------------------

@pytest.mark.parametrize("datatype", [None, "ci16_le"])
@pytest.mark.parametrize("writer", list(PKGS))
def test_recording_crosses_packages(tmp_path, writer, datatype):
    rng = np.random.default_rng(SEED)
    x = np.clip(rng.standard_normal((3001, 2)) * 0.3, -0.999, 0.999)
    x = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
    base = str(tmp_path / "x")
    kw = dict(sample_rate=2.4e6, frequency=100e6, description="cross",
              annotations=[{"core:sample_start": 7, "core:label": "a=b"}],
              datatype=datatype)
    SIGMF[PKGS[writer]].write_sigmf(base, x, **kw)
    data = open(base + ".sigmf-data", "rb").read()
    other = gt if writer == "jax" else gr
    SIGMF[other].write_sigmf(str(tmp_path / "y"), x, **kw)
    assert open(str(tmp_path / "y") + ".sigmf-data", "rb").read() == data
    assert (open(str(tmp_path / "y") + ".sigmf-meta").read()
            == open(base + ".sigmf-meta").read())
    yt, mt = tsigmf.read_sigmf(base)
    yj, mj = jsigmf.read_sigmf(base)
    np.testing.assert_array_equal(yt, yj)
    assert mt == mj
    if datatype is None:
        np.testing.assert_array_equal(yt, x)
    else:
        assert np.abs(yt - x).max() <= CI16_ATOL


# -- record and play back (TestRecordPlayback) ---------------------------------

def _record(pkg, base, n=8192, **sink_kw):
    g = pkg.Graph()
    src = g.emplace("ComplexToneSource", frequency=1000.0, n_samples=n)
    snk = (g.add(tsigmf.SigmfSink(path=base, description="tone rec", **sink_kw))
           if sink_kw else g.emplace("SigmfSink", path=base, description="tone rec"))
    g.connect(src, snk)
    _sched(pkg, g, block_len=2048, sample_rate=48000.0).run_and_wait()


def test_scheduler_roundtrip_exact(tmp_path):
    for pkg in (gt, gr):
        base = str(tmp_path / f"tone_{pkg.__name__}")
        _record(pkg, base)
    for pkg in (gt, gr):
        base = str(tmp_path / f"tone_{pkg.__name__}")
        x, meta = SIGMF[pkg].read_sigmf(base)
        assert meta["global"]["core:sample_rate"] == 48000.0
        assert meta["global"]["core:datatype"] == "cf32_le"
        assert len(x) == 8192
        y, tags = _replay(pkg, base)
        np.testing.assert_array_equal(y, x)
        rate = [t for t in tags if t.map.get("sample_rate") == 48000.0]
        assert rate and rate[0].index == 0
    xt = tsigmf.read_sigmf(str(tmp_path / "tone_gnuradio4_tpu_torch"))[0]
    xj = jsigmf.read_sigmf(str(tmp_path / "tone_gnuradio4_tpu"))[0]
    np.testing.assert_allclose(xt, xj, atol=1e-6)    # two sin/cos libraries
    # the port replays the JAX package's recording as the JAX package does
    np.testing.assert_array_equal(_replay(gt, str(tmp_path / "tone_gnuradio4_tpu"))[0],
                                  _replay(gr, str(tmp_path / "tone_gnuradio4_tpu"))[0])


def test_sink_writes_ci16_le(tmp_path):
    """SigmfSink(datatype="ci16_le") stores what write_sigmf(datatype=
    "ci16_le") of the JAX package stores for the same samples, and the
    replay comes back within one int16 step."""
    base = str(tmp_path / "q")
    _record(gt, base, datatype="ci16_le")
    g = gt.Graph()
    snk = g.add(_reg(gt, "VectorSink"))
    g.connect(g.emplace("ComplexToneSource", frequency=1000.0, n_samples=8192), snk)
    _sched(gt, g, block_len=2048, sample_rate=48000.0).run_and_wait()
    tone = np.asarray(snk.data())
    jsigmf.write_sigmf(str(tmp_path / "ref"), tone, sample_rate=48000.0,
                       description="tone rec", datatype="ci16_le")
    assert (open(base + ".sigmf-data", "rb").read()
            == open(str(tmp_path / "ref") + ".sigmf-data", "rb").read())
    meta = json.loads(open(base + ".sigmf-meta").read())
    assert meta["global"]["core:datatype"] == "ci16_le"
    y, _ = _replay(gt, base)
    yj, _ = _replay(gr, base)
    np.testing.assert_array_equal(y, yj)
    assert y.dtype == np.complex64 and np.abs(y - tone).max() <= CI16_ATOL


def test_sink_refuses_other_datatypes():
    with pytest.raises(GrError, match="datatype"):
        tsigmf.SigmfSink(path="x", datatype="cf32_le")


def test_string_tags_become_annotations_and_replay(tmp_path):
    def run(pkg):
        base = str(tmp_path / f"tagged_{pkg.__name__}")
        g = pkg.Graph()
        src = g.add(_reg(pkg, "TagSource", n_samples=4096, tags=[
            pkg.Tag(100, {"burst_id": "alpha"}), pkg.Tag(3000, {"burst_id": "beta"})]))
        g.connect(src, g.emplace("SigmfSink", path=base))
        _sched(pkg, g, block_len=1024, sample_rate=1e6).run_and_wait()
        meta = json.loads(open(base + ".sigmf-meta").read())
        _, tags = _replay(pkg, base, block_len=1024, sample_rate=1e6)
        return ({a["core:sample_start"]: a["core:label"] for a in meta["annotations"]},
                {int(t.index): t.map["annotation"] for t in tags if "annotation" in t.map})
    got, want = run(gt), run(gr)
    assert got == want
    assert got[0] == {100: "burst_id=alpha", 3000: "burst_id=beta"}
    assert got[1] == {100: "burst_id=alpha", 3000: "burst_id=beta"}


@pytest.mark.parametrize("datatype", [None, "ci16_le"])
def test_repeat_playback(tmp_path, datatype):
    base = str(tmp_path / "loop")
    x = (np.arange(100, dtype=np.float32) / 128).astype(
        np.complex64 if datatype else np.float32)
    tsigmf.write_sigmf(base, x, sample_rate=1e3, datatype=datatype)
    outs = []
    for mod in (tsigmf, jsigmf):
        src = mod.SigmfSource(path=base, repeat=True)
        src.start()
        got, n = src.host_feed(250, 30)
        assert n == 250
        outs.append(got["out"])
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][:70], outs[0][100:170])


@pytest.mark.parametrize("pkg", list(PKGS))
def test_missing_recording_raises(pkg):
    src = SIGMF[PKGS[pkg]].SigmfSource(path="/nonexistent/rec")
    with pytest.raises(Exception, match="no such recording"):
        src.start()


def test_decode_a_recorded_transmission(tmp_path):
    """An RTTY transmission recorded to SigMF and played back into the
    decoder: the text survives the disk trip, in both packages."""
    from gnuradio4_tpu.blocks.rtty import rtty_modulate
    base = str(tmp_path / "rtty")
    tsigmf.write_sigmf(base, rtty_modulate("VIA SIGMF 73", fs=48000.0),
                       sample_rate=48000.0)
    for pkg in (gt, gr):
        g = pkg.Graph()
        src = g.emplace("SigmfSource", path=base)
        dec = g.emplace("RttyDecoder")
        g.connect(src, dec)
        _sched(pkg, g, block_len=8192, sample_rate=48000.0).run_and_wait()
        assert dec.text == "VIA SIGMF 73"


def test_empty_recording_ends_at_once(tmp_path):
    base = str(tmp_path / "empty")
    tsigmf.write_sigmf(base, np.zeros(0, np.float32), sample_rate=1.0)
    src = tsigmf.SigmfSource(path=base)
    src.start()
    assert src.host_feed(64, 0) is None


# -- URIs (tests/test_uri.py) ----------------------------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_file_uri_roundtrip(tmp_path, pkg):
    pkg = PKGS[pkg]
    data = np.arange(4096, dtype=np.float32)
    p_in, p_out = tmp_path / "in.f32", tmp_path / "out.f32"
    p_in.write_bytes(data.tobytes())
    g = pkg.Graph()
    g.connect(URI[pkg].source_for_uri(f"file://{p_in}?dtype=float32"),
              URI[pkg].sink_for_uri(f"file://{p_out}"))
    _sched(pkg, g, block_len=1024).run_and_wait()
    np.testing.assert_array_equal(np.frombuffer(p_out.read_bytes(), np.float32), data)


def test_wire_format_uri(tmp_path):
    p = tmp_path / "cap.dat"
    p.write_bytes(np.arange(2000, dtype=np.int16).tobytes())
    outs = []
    for pkg in (gt, gr):
        g = pkg.Graph()
        snk = _reg(pkg, "VectorSink")
        g.connect(URI[pkg].source_for_uri(f"file://{p}?wire_format=i16iq"), snk)
        _sched(pkg, g, block_len=250).run_and_wait()
        outs.append(np.asarray(snk.data()))
    assert outs[0].dtype == np.complex64 and outs[0].shape == (1000,)
    np.testing.assert_array_equal(*outs)


def test_wav_uri(tmp_path):
    p = tmp_path / "t.wav"
    tone = (0.25 * np.sin(np.linspace(0, 100, 4000))).astype(np.float32)
    g = gt.Graph()
    g.connect(_reg(gt, "VectorSource", data=tone),
              turi.sink_for_uri(f"file://{p}", sample_rate=8000.0))
    sched = _sched(gt, g, block_len=1000)
    sched.run_and_wait()
    for b in sched.compiled.order:
        b.stop()
    for pkg in (gt, gr):
        g2 = pkg.Graph()
        snk = _reg(pkg, "VectorSink")
        g2.connect(URI[pkg].source_for_uri(f"file://{p}"), snk)
        _sched(pkg, g2, block_len=1000).run_and_wait()
        np.testing.assert_allclose(snk.data(), tone, atol=1e-4)


URIS = ["file:///data/capture.f32?dtype=float32&repeat=1",
        "file:///data/iq.dat?wire_format=i16iq",
        "/plain/path.f32",
        "wav:///music.wav", "file:///a/b.WAV",
        "http://host:8080/stream?parse=bytes&dtype=float32",
        "http://host:8080/stream",
        "audio://loopback/devname", "audio://",
        "sdr://loopback?sample_rate=1e6&center_frequency=99.5e6&gain=3"]


@pytest.mark.parametrize("uri", URIS)
def test_source_for_uri_matches_jax(uri):
    t, j = turi.source_for_uri(uri), juri.source_for_uri(uri)
    assert type(t).__name__ == type(j).__name__
    assert t.settings.as_dict() == j.settings.as_dict()


@pytest.mark.parametrize("uri", [
    "file:///data/out.f32", "/plain/out.f32", "wav:///out.wav",
    "file:///a/b.WAV?sample_rate=8000", "http://host:8080/post?parse=json",
    "audio://loopback/devname", "audio://",
    "sdr://loopback?sample_rate=1e6&center_frequency=99.5e6&gain=3"])
def test_sink_for_uri_matches_jax(uri):
    t, j = turi.sink_for_uri(uri), juri.sink_for_uri(uri)
    assert type(t).__name__ == type(j).__name__
    assert t.settings.as_dict() == j.settings.as_dict()


def test_sdr_uri():
    src = turi.source_for_uri("sdr://loopback?sample_rate=1e6&center_frequency=99.5e6")
    assert type(src).__name__ == "SdrSource"
    assert src.settings.get("sample_rate") == 1e6
    assert src.settings.get("center_frequency") == 99.5e6


@pytest.mark.parametrize("fn", ["source_for_uri", "sink_for_uri"])
def test_unknown_scheme(fn):
    with pytest.raises(GrError, match="ftp"):
        getattr(turi, fn)("ftp://nope/file")


# -- audio (TestAudio) and the WAV file backend ---------------------------------

def test_loopback_roundtrip():
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(4096) / 48000.0)
            ).astype(np.float32)
    outs = []
    for pkg in (gt, gr):
        key = f"t{uuid.uuid4().hex}"
        g1 = pkg.Graph()
        out = g1.emplace("AudioSink", backend="loopback", device=key)
        g1.connect(_reg(pkg, "VectorSource", data=tone), out)
        _sched(pkg, g1, block_len=1024).run_and_wait()
        out.stop()  # EOS on the ring
        g2 = pkg.Graph()
        mic = g2.emplace("AudioSource", backend="loopback", device=key,
                         n_samples=4096)
        cap = _reg(pkg, "VectorSink")
        g2.connect(mic, cap)
        _sched(pkg, g2, block_len=1024).run_and_wait()
        outs.append(np.asarray(cap.data()))
    np.testing.assert_allclose(outs[0], tone, atol=1e-6)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("pkg", list(PKGS))
def test_null_backend_runs(pkg):
    pkg = PKGS[pkg]
    g = pkg.Graph()
    src = g.emplace("AudioSource", backend="null", sample_rate=48000.0,
                    n_samples=2048)
    snk = _reg(pkg, "VectorSink")
    g.connect(src, snk)
    _sched(pkg, g, block_len=1024).run_and_wait()
    assert snk.data().shape == (2048,)


def test_file_backend_writes_what_wavsink_writes(tmp_path):
    """AudioSink(backend="file") writes the 16-bit WAV the JAX package's
    WavSink writes for the same stream; AudioSource(backend="file") reads it
    back as WavSource does."""
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(5000) / 48000.0)
            ).astype(np.float32)
    ours, ref = tmp_path / "a.wav", tmp_path / "ref.wav"
    g = gt.Graph()
    g.connect(_reg(gt, "VectorSource", data=tone),
              g.emplace("AudioSink", backend="file", device=str(ours),
                        sample_rate=48000.0))
    _sched(gt, g, block_len=1024).run_and_wait()
    gj = gr.Graph()
    gj.connect(_reg(gr, "VectorSource", data=tone),
               _reg(gr, "WavSink", path=str(ref), sample_rate=48000.0))
    gr.Scheduler(gj, block_len=1024).run_and_wait()
    with wave.open(str(ours)) as a, wave.open(str(ref)) as b:
        assert (a.getnchannels(), a.getsampwidth(), a.getframerate(),
                a.getnframes()) == (1, 2, 48000, 5000)
        assert a.readframes(5000) == b.readframes(b.getnframes())[:10000]
    g2 = gt.Graph()
    snk = _reg(gt, "VectorSink")
    g2.connect(g2.emplace("AudioSource", backend="file", device=str(ours)), snk)
    _sched(gt, g2, block_len=1024).run_and_wait()
    y = np.asarray(snk.data())
    assert y.shape == (5000,)
    np.testing.assert_allclose(y, tone, atol=WAV_ATOL)


def test_file_backend_needs_a_path():
    with pytest.raises(GrError, match="WAV path"):
        from gnuradio4_tpu_torch.blocks.audio import make_backend
        make_backend("file", path="default")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unknown_audio_backend(pkg):
    from importlib import import_module
    mod = import_module(f"{PKGS[pkg].__name__}.blocks.audio")
    with pytest.raises(Exception, match="unknown audio backend"):
        mod.make_backend("no-such-backend")
