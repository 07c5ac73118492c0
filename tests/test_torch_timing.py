"""The port's GPS/PPS timing blocks (``blocks/timing.py``) against the JAX
package's, on the CPU: every NMEA/GPS/PPS case of ``tests/test_io_blocks.py``
through both packages, the parsed fixes and the emitted tags compared.

Tolerance: none. Parsed fields, tag indices and tag maps are compared
exactly (the same float parsing on both sides), the sample streams bit for
bit."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import timing as jtiming
from gnuradio4_tpu_torch.blocks import timing as ttiming
from gnuradio4_tpu_torch.core.tags import Keys

torch.set_num_threads(2)

NMEA_OK = "$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*6A"
NMEA_GGA = "$GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*47"
NMEA_VOID = "$GPRMC,123520,V,,,,,,,230394,,*"
SENTENCES = [NMEA_OK, NMEA_GGA, NMEA_OK.replace("A,4807", "A,4808"), "garbage",
             "$GPGSV,3,1,11,03,03,111,00*74", NMEA_OK[:-3] + "*00"]
MODS = {"jax": (gr, jtiming), "port": (gt, ttiming)}


def _void():
    body = NMEA_VOID[1:-1]
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"${body}*{c:02X}"


def test_checksum():
    for mod in (jtiming, ttiming):
        assert mod.nmea_checksum_ok(NMEA_OK)
        assert not mod.nmea_checksum_ok(NMEA_OK.replace("A,4807", "A,4808"))


def test_parse_rmc():
    fix = ttiming.parse_nmea(NMEA_OK)
    assert fix["valid"] and fix["type"] == "RMC"
    np.testing.assert_allclose(fix["lat"], 48 + 7.038 / 60, rtol=1e-6)
    np.testing.assert_allclose(fix["lon"], 11 + 31.0 / 60, rtol=1e-6)
    assert "utc" in fix  # 1994-03-23T12:35:19Z
    assert abs(fix["utc"] - 764426119.0) < 1.0


def test_parse_gga():
    fix = ttiming.parse_nmea(NMEA_GGA)
    assert fix["fix_quality"] == 1 and fix["n_satellites"] == 8
    np.testing.assert_allclose(fix["altitude_m"], 545.4)


@pytest.mark.parametrize("sentence", SENTENCES + [_void()])
def test_parse_matches_jax(sentence):
    assert ttiming.parse_nmea(sentence) == jtiming.parse_nmea(sentence)
    assert ttiming.nmea_checksum_ok(sentence) == jtiming.nmea_checksum_ok(sentence)


def _tags(snk, name):
    return [(int(t.index), dict(t.map)) for t in snk.tags
            if t.map.get(Keys.TRIGGER_NAME) == name]


def _gps(key, sentences, **settings):
    pkg, mod = MODS[key]
    dev = mod.ReplayNmeaDevice(sentences)
    g = pkg.Graph()
    src = mod.GpsSource(device=dev, **settings)
    snk = pkg.global_registry.create("VectorSink")
    g.connect(src, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=100, **kw).run_and_wait()
    return snk, src


def test_gps_source_emits_fix_tags():
    snk, src = _gps("port", [NMEA_OK, NMEA_GGA, NMEA_OK], sample_rate=100.0,
                    n_samples=400)
    pps = [t for t in snk.tags if t.map.get(Keys.TRIGGER_NAME) == "gps_pps"]
    assert len(pps) >= 2
    assert any("lat" in t.map for t in pps)
    jsnk, jsrc = _gps("jax", [NMEA_OK, NMEA_GGA, NMEA_OK], sample_rate=100.0,
                      n_samples=400)
    assert _tags(snk, "gps_pps") == _tags(jsnk, "gps_pps")
    got, want = snk.data(), jsnk.data()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert {k: v for k, v in src.last_fix.items()} == \
        {k: v for k, v in jsrc.last_fix.items()}


def test_gps_source_ends_with_its_device():
    """``n_samples`` 0: the stream ends when the device has no more
    sentences; a void fix (status V) is parsed but not tagged."""
    lines = [NMEA_OK, _void(), NMEA_GGA]
    snk, _ = _gps("port", lines)
    jsnk, _ = _gps("jax", lines)
    assert _tags(snk, "gps_pps") == _tags(jsnk, "gps_pps")
    assert len(_tags(snk, "gps_pps")) == 2
    assert len(snk.data()) == len(jsnk.data())


@pytest.mark.parametrize("fs, n, block", [(100.0, 1000, 250), (1000.0, 2500, 600),
                                          (48.0, 500, 64)])
def test_pps_source_cadence(fs, n, block):
    out = {}
    for key, (pkg, mod) in MODS.items():
        g = pkg.Graph()
        src = mod.PpsSource(sample_rate=fs, n_samples=n)
        snk = pkg.global_registry.create("VectorSink")
        g.connect(src, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=block, **kw).run_and_wait()
        out[key] = (_tags(snk, "pps"), np.asarray(snk.data()))
    assert out["port"][0] == out["jax"][0]
    assert [i for i, _ in out["port"][0]] == list(range(0, n, int(fs)))
    assert out["port"][1].dtype == np.uint8
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    if (fs, n, block) == (100.0, 1000, 250):   # tests/test_io_blocks.py:174
        assert [i for i, _ in out["port"][0]] == [0, 100, 200, 300, 400, 500,
                                                  600, 700, 800, 900]


def test_sources_make_their_samples_on_the_graph_device():
    from gnuradio4_tpu_torch.core.block import BlockCtx
    ctx = BlockCtx(in_len={}, out_len={"out": 16}, sample_rate=1.0, params={},
                   device=torch.device("cpu"))
    for blk in (ttiming.PpsSource(), ttiming.GpsSource()):
        _, outs = blk.apply(None, {"out": np.zeros(16, np.uint8)}, ctx)
        assert isinstance(outs["out"], torch.Tensor)
        assert outs["out"].dtype == torch.uint8 and outs["out"].shape == (16,)
        assert outs["out"].device == ctx.device


def test_paced_replay_waits_between_sentences():
    import time
    dev = ttiming.ReplayNmeaDevice([NMEA_OK, NMEA_GGA], paced=True, interval_s=0.02)
    t0 = time.monotonic()
    assert dev.readline() == NMEA_OK and dev.readline() == NMEA_GGA
    assert dev.readline() is None
    assert time.monotonic() - t0 >= 0.05
    ttiming.NmeaDevice().close()
