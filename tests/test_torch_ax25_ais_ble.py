"""The port's AX.25, AIS and BLE receivers (``blocks/ax25.py``,
``ais.py``, ``ble.py``) against the JAX package's, on the CPU: every host
helper on seeded inputs; Ax25Decoder behind the dual-tone correlator graph,
AisSource → QuadratureDemod → AisDecoder and BleSource → QuadratureDemod →
BleDecoder through both schedulers; ``examples/ais_receiver.yaml`` and
``examples/ble_scanner.yaml`` run by ``run_grc`` in both packages; and every
case of ``tests/test_ax25.py``, ``test_ais.py`` and ``test_ble.py`` run on
the port.

Tolerances: the coding layers and the waveform synthesis are host NumPy in
both packages and are compared exactly. The discriminators (QuadratureDemod,
the FreqXlatingFir correlator) run in float32 in each package and differ in
rounding; what the packages must agree on is the decoded packets, vessels
and devices, compared exactly with every field."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import ais as jais, ax25 as jax25, ble as jble
from gnuradio4_tpu_torch.blocks import ais as tais, ax25, ble as tble
from gnuradio4_tpu_torch.blocks.ais import (ais_demod_bits, ais_frame_bits,
                                            ais_modulate, bits_to_bytes,
                                            build_position_report,
                                            bytes_to_bits, gmsk_modulate,
                                            parse_position_report,
                                            sixbit_decode, sixbit_encode)
from gnuradio4_tpu_torch.blocks.ax25 import deframe, nrzi_decode
from gnuradio4_tpu_torch.blocks.ble import (ADV_ACCESS_ADDRESS,
                                            build_ad_structures,
                                            ble_demod_bits, ble_modulate,
                                            crc24, crc24_bits, decode_bits,
                                            encode_advertising, gfsk_modulate,
                                            parse_ad_structures, whiten_bits,
                                            whitening_sequence)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261017
AIS_FS = 96000.0
AIS_SPS = AIS_FS / 9600.0
BLE_FS = 8e6
BLE_SPS = 8.0
ADDR = bytes([0x12, 0x34, 0x56, 0x78, 0x9A, 0xBC])   # little-endian on air


def _sched(g, **kw):
    return gt.Scheduler(g, device="cpu", **kw)


def _eq(a, b):
    """Exact equality of host results: arrays (values and dtype), bytes,
    strings, numbers, None, and lists/tuples/dicts of them."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _eq(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# -- host helpers: exact ----------------------------------------------------------

def test_ax25_helpers_equal():
    rng = np.random.default_rng(SEED)
    _eq(ax25._FLAG, jax25._FLAG)
    for data in (b"", b"123456789", bytes(rng.integers(0, 256, 90).astype(np.uint8))):
        _eq(ax25.crc16_x25(data), jax25.crc16_x25(data))
    frame = ax25.build_ui_frame("APRS", "N0CALL", "!4903.50N/07201.75W-x~\x7f",
                                path=["WIDE1", "WIDE2"], src_ssid=9)
    _eq(frame, jax25.build_ui_frame("APRS", "N0CALL",
                                    "!4903.50N/07201.75W-x~\x7f",
                                    path=["WIDE1", "WIDE2"], src_ssid=9))
    _eq(ax25.parse_frame(frame), jax25.parse_frame(frame))
    _eq(ax25.parse_frame(frame[:5]), jax25.parse_frame(frame[:5]))
    for kw in ({}, {"preamble_flags": 3, "tail_flags": 1}):
        _eq(ax25.hdlc_bits(frame, **kw), jax25.hdlc_bits(frame, **kw))
    bits = ax25.hdlc_bits(frame)
    _eq(ax25.nrzi_encode(bits), jax25.nrzi_encode(bits))
    _eq(ax25.nrzi_decode(bits), jax25.nrzi_decode(bits))
    bad = bits.copy()
    bad[200] ^= 1
    for b in (bits, bad):
        _eq(ax25.deframe(b), jax25.deframe(b))
    wave = ax25.afsk_modulate(frame, fs=48000.0)
    _eq(wave, jax25.afsk_modulate(frame, fs=48000.0))
    noisy = (wave + 0.3 * rng.standard_normal(len(wave))).astype(np.float32)
    disc = ax25.afsk_discriminate(noisy)
    _eq(disc, jax25.afsk_discriminate(noisy))
    _eq(ax25.demod_bits(disc, 40.0), jax25.demod_bits(disc, 40.0))


def test_ais_helpers_equal():
    rng = np.random.default_rng(SEED + 1)
    bits = rng.integers(0, 2, 168).astype(np.uint8)
    _eq(tais.bits_to_bytes(bits), jais.bits_to_bytes(bits))
    _eq(tais.bytes_to_bits(b"\x01\xfe"), jais.bytes_to_bits(b"\x01\xfe"))
    armored = "177KQJ5000G?tO`K>RA1wUbN0TKH"
    _eq(tais.sixbit_decode(armored), jais.sixbit_decode(armored))
    _eq(tais.sixbit_encode(bits), jais.sixbit_encode(bits))
    kw = dict(mmsi=211234560, lat=-33.8568, lon=151.2153, sog_kn=14.5,
              cog_deg=200.0, heading_deg=199, nav_status=3, msg_type=2,
              timestamp=42)
    msg = tais.build_position_report(**kw)
    _eq(msg, jais.build_position_report(**kw))
    _eq(tais.parse_position_report(msg), jais.parse_position_report(msg))
    _eq(tais.ais_frame_bits(msg), jais.ais_frame_bits(msg))
    iq = tais.ais_modulate(msg, fs=AIS_FS)
    _eq(iq, jais.ais_modulate(msg, fs=AIS_FS))
    _eq(tais.gmsk_modulate(bits, fs=48000.0), jais.gmsk_modulate(bits, fs=48000.0))
    iq = iq + 0.1 * (rng.standard_normal(len(iq))
                     + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    disc = np.angle(iq[1:] * np.conj(iq[:-1]))
    _eq(tais.ais_demod_bits(disc, AIS_SPS), jais.ais_demod_bits(disc, AIS_SPS))


def test_ble_helpers_equal():
    rng = np.random.default_rng(SEED + 2)
    for name in ("ADV_ACCESS_ADDRESS", "CRC_INIT_ADV", "ADV_CHANNELS",
                 "PDU_TYPES", "_AA_BITS"):
        _eq(getattr(tble, name), getattr(jble, name))
    data = bytes(rng.integers(0, 256, 30).astype(np.uint8))
    _eq(tble.crc24(data), jble.crc24(data))
    _eq(tble.crc24_bits(data, init=0x123456), jble.crc24_bits(data, init=0x123456))
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    for ch in (37, 38, 39):
        _eq(tble.whitening_sequence(200, ch), jble.whitening_sequence(200, ch))
        _eq(tble.whiten_bits(bits, ch), jble.whiten_bits(bits, ch))
    ad = tble.build_ad_structures(flags=0x05, name="GR4", manufacturer=b"\x4c\x00")
    _eq(ad, jble.build_ad_structures(flags=0x05, name="GR4",
                                     manufacturer=b"\x4c\x00"))
    _eq(tble.parse_ad_structures(ad + b"\x09"), jble.parse_ad_structures(ad + b"\x09"))
    for pdu_type in (0, 2):
        enc = tble.encode_advertising(ADDR, ad, channel=38, pdu_type=pdu_type)
        _eq(enc, jble.encode_advertising(ADDR, ad, channel=38, pdu_type=pdu_type))
        _eq(tble.decode_bits(enc, channel=38), jble.decode_bits(enc, channel=38))
    iq = tble.ble_modulate(ADDR, ad, fs=BLE_FS, channel=39)
    _eq(iq, jble.ble_modulate(ADDR, ad, fs=BLE_FS, channel=39))
    _eq(tble.gfsk_modulate(bits, fs=BLE_FS), jble.gfsk_modulate(bits, fs=BLE_FS))
    iq = iq + 0.05 * (rng.standard_normal(len(iq))
                      + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    disc = np.angle(iq[1:] * np.conj(iq[:-1]))
    _eq(tble.ble_demod_bits(disc, BLE_SPS), jble.ble_demod_bits(disc, BLE_SPS))


# -- the receivers through both schedulers ---------------------------------------------

def _ax25_graph(pkg):
    rng = np.random.default_rng(SEED + 3)
    f1 = jax25.build_ui_frame("APRS", "N0CALL", "!4903.50N/07201.75W-both",
                              path=["WIDE1"], src_ssid=9)
    f2 = jax25.build_ui_frame("APRS", "W1AW", ">second packet")
    wave = np.concatenate([jax25.afsk_modulate(f1, fs=48000.0),
                           np.zeros(4800, np.float32),
                           jax25.afsk_modulate(f2, fs=48000.0)])
    wave = (wave + 0.15 * rng.standard_normal(len(wave))).astype(np.float32)
    boxcar = tuple((np.ones(40) / 40.0).tolist())
    g = pkg.Graph()
    reg = pkg.global_registry
    cvt = reg.create("Convert", to="complex64")
    g.connect(reg.create("VectorSource", data=wave), cvt)
    sub = reg.create("Subtract")
    for f, port in ((1200.0, "in0"), (2200.0, "in1")):
        xl = reg.create("FreqXlatingFir", center_freq=f, decim=4, taps=boxcar)
        ab = reg.create("Abs")
        g.connect(cvt["out"], xl["in"])
        g.connect(xl["out"], ab["in"])
        g.connect(ab["out"], sub[port])
    dec = reg.create("Ax25Decoder", sps=10.0)
    g.connect(sub, dec)
    return g, dec


def _chain(pkg, src_type, src_kw, dec_type, dec_kw):
    g = pkg.Graph()
    reg = pkg.global_registry
    src = reg.create(src_type, **src_kw)
    snk = reg.create("VectorSink")
    dec = reg.create(dec_type, **dec_kw)
    g.connect(src, snk)
    g.connect_chain(src, reg.create("QuadratureDemod", gain=1.0), dec)
    return g, dec, snk


def _both(build, block_len, fs):
    out = {}
    for pkg in (gr, gt):
        g, dec, *snk = build(pkg)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw).run_and_wait()
        out[pkg] = (dec, [np.asarray(s.data()) for s in snk])
    for a, b in zip(out[gt][1], out[gr][1]):
        _eq(a, b)                     # the host-synthesized waveform
    return out[gt][0], out[gr][0]


@pytest.mark.parametrize("block_len", [4800, 3000])
def test_ax25_decoder_equal_through_both_schedulers(block_len):
    dt, dj = _both(_ax25_graph, block_len, 48000.0)
    assert [p["src"] for p in dt.packets] == [("N0CALL", 9), ("W1AW", 0)]
    _eq(dt.packets, dj.packets)


REPORTS = [dict(mmsi=477553000, lat=47.58283, lon=-122.34583, sog_kn=0.0,
                cog_deg=51.0, heading_deg=181, nav_status=5),
           dict(mmsi=211234560, lat=54.1833, lon=12.0833, sog_kn=14.5,
                cog_deg=200.0, heading_deg=199, nav_status=0)]


@pytest.mark.parametrize("block_len", [4096, 1536])
def test_ais_chain_equal_through_both_schedulers(block_len):
    dt, dj = _both(lambda pkg: _chain(
        pkg, "AisSource", {"reports": REPORTS, "sample_rate": AIS_FS},
        "AisDecoder", {"sps": AIS_SPS}), block_len, AIS_FS)
    assert set(dt.vessels) == {477553000, 211234560}
    _eq(dt.packets, dj.packets)
    _eq(dt.vessels, dj.vessels)


ADVERTISERS = [{"adv_addr": ADDR, "name": "GR4-TPU", "flags": 0x06},
               {"adv_addr": bytes(range(6)), "name": "BEACON-2",
                "pdu_type": 2, "manufacturer": b"\x4c\x00"}]


@pytest.mark.parametrize("block_len", [8192, 3000])
def test_ble_chain_equal_through_both_schedulers(block_len):
    dt, dj = _both(lambda pkg: _chain(
        pkg, "BleSource", {"advertisers": ADVERTISERS, "sample_rate": BLE_FS,
                           "channel": 38},
        "BleDecoder", {"sps": BLE_SPS, "channel": 38}), block_len, BLE_FS)
    assert {p["name"] for p in dt.packets} == {"GR4-TPU", "BEACON-2"}
    _eq(dt.packets, dj.packets)
    _eq(dt.devices, dj.devices)


def _flow(pkg, stem, name):
    text = (ROOT / "examples" / f"{stem}.yaml").read_text()
    kw = {"scheduler_kwargs": {"device": "cpu"}} if pkg is gt else {}
    return {b.name: b for b in pkg.run_grc(text, **kw).graph.blocks}[name]


def test_ais_receiver_example_runs_in_the_port_as_in_the_jax_package():
    """examples/ais_receiver.yaml through ``run_grc`` on the CPU: both MMSIs,
    the moored one with nav_status 5 (tests/test_examples.py), and every
    vessel field equal to the JAX package's."""
    rt, rj = _flow(gt, "ais_receiver", "tracker"), _flow(gr, "ais_receiver", "tracker")
    assert set(rt.vessels) == {477553000, 211234560}
    assert rt.vessels[477553000]["nav_status"] == 5
    _eq(rt.vessels, rj.vessels)
    _eq(rt.packets, rj.packets)


def test_ble_scanner_example_runs_in_the_port_as_in_the_jax_package():
    """examples/ble_scanner.yaml through ``run_grc`` on the CPU: both
    advertisers, one named GR4-TPU, equal to the JAX package's devices."""
    rt, rj = _flow(gt, "ble_scanner", "scan"), _flow(gr, "ble_scanner", "scan")
    assert set(rt.devices) == {"BC:9A:78:56:34:12", "05:04:03:02:01:00"}
    assert rt.devices["BC:9A:78:56:34:12"]["name"] == "GR4-TPU"
    _eq(rt.devices, rj.devices)
    _eq(rt.packets, rj.packets)


# -- tests/test_ax25.py, test_ais.py and test_ble.py, on the port ------------------------

class TestAx25Coding:
    def test_fcs_known_answer(self):
        # X.25 FCS of "123456789" is the published 0x906E check value
        assert ax25.crc16_x25(b"123456789") == 0x906E

    def test_address_encoding(self):
        frame = ax25.build_ui_frame("APRS", "N0CALL", "hi", src_ssid=9)
        # callsigns ride shifted-ASCII with SSID + last-bit in byte 7
        assert frame[0] == ord("A") << 1
        p = ax25.parse_frame(frame)
        assert p["dest"] == ("APRS", 0) and p["src"] == ("N0CALL", 9)
        assert p["control"] == 0x03 and p["pid"] == 0xF0
        assert p["info"] == "hi"

    def test_hdlc_bit_stuffing_roundtrip(self):
        # 0xFF bytes force maximal stuffing
        payload = ax25.build_ui_frame("TEST", "CALL", "\x7f\x7f~~~~")
        bits = ax25.hdlc_bits(payload)
        frames = ax25.deframe(bits)
        assert frames == [payload]

    def test_corrupted_fcs_rejected(self):
        payload = ax25.build_ui_frame("TEST", "CALL", "hello")
        bits = ax25.hdlc_bits(payload)
        # flip a payload bit inside the frame body
        bits2 = bits.copy()
        bits2[16 * 8 + 30] ^= 1
        assert ax25.deframe(bits2) == []

    def test_nrzi_roundtrip(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 200).astype(np.uint8)
        np.testing.assert_array_equal(
            ax25.nrzi_decode(ax25.nrzi_encode(bits))[1:], bits[1:])


class TestAfskModem:
    FRAME = ax25.build_ui_frame("APRS", "N0CALL",
                                "!4903.50N/07201.75W-Test GR4 TPU",
                                path=["WIDE1"], src_ssid=9)

    @pytest.mark.parametrize("noise", [0.0, 0.2, 0.4])
    def test_host_loopback(self, noise):
        rng = np.random.default_rng(1)
        wave = ax25.afsk_modulate(self.FRAME, fs=48000.0)
        wave = wave + noise * rng.standard_normal(len(wave)).astype(np.float32)
        disc = ax25.afsk_discriminate(wave)
        tones = ax25.demod_bits(disc, 40.0)
        pkts = [p for f in ax25.deframe(ax25.nrzi_decode(tones))
                if (p := ax25.parse_frame(f))]
        assert len(pkts) == 1
        assert pkts[0]["src"] == ("N0CALL", 9)
        assert pkts[0]["path"] == [("WIDE1", 0)]
        assert pkts[0]["info"].endswith("GR4 TPU")

    def test_graph_chain_dual_tone_correlator(self):
        """The Bell-202 detector expressed as a flowgraph: two FreqXlatingFir
        branches (one-bit boxcars at 1200/2200 Hz) → Abs → Subtract →
        Ax25Decoder; two packets back-to-back through scheduler chunking."""
        rng = np.random.default_rng(2)
        f2 = ax25.build_ui_frame("APRS", "W1AW", ">APRS test via TPU")
        wave = np.concatenate([
            ax25.afsk_modulate(self.FRAME, fs=48000.0),
            np.zeros(4800, np.float32),
            ax25.afsk_modulate(f2, fs=48000.0)])
        wave = wave + 0.15 * rng.standard_normal(len(wave)).astype(np.float32)

        boxcar = tuple((np.ones(40) / 40.0).tolist())
        g = gt.Graph()
        src = g.emplace("VectorSource", data=wave)
        cvt = g.emplace("Convert", to="complex64")
        mark = g.emplace("FreqXlatingFir", center_freq=1200.0, decim=4,
                         taps=boxcar)
        space = g.emplace("FreqXlatingFir", center_freq=2200.0, decim=4,
                          taps=boxcar)
        amark, aspace = g.emplace("Abs"), g.emplace("Abs")
        sub = g.emplace("Subtract")
        dec = g.emplace("Ax25Decoder", sps=10.0)
        g.connect(src, cvt)
        g.connect(cvt["out"], mark["in"])
        g.connect(cvt["out"], space["in"])
        g.connect(mark["out"], amark["in"])
        g.connect(space["out"], aspace["in"])
        g.connect(amark["out"], sub["in0"])
        g.connect(aspace["out"], sub["in1"])
        g.connect(sub, dec)
        _sched(g, block_len=4800, sample_rate=48000.0).run_and_wait()

        assert len(dec.packets) == 2, dec.packets
        assert dec.packets[0]["src"] == ("N0CALL", 9)
        assert dec.packets[0]["info"].endswith("GR4 TPU")
        assert dec.packets[1]["src"] == ("W1AW", 0)
        assert dec.packets[1]["info"] == ">APRS test via TPU"


class TestDeframeEdgeCases:
    def test_closing_flag_at_exact_buffer_end(self):
        payload = ax25.build_ui_frame("TEST", "CALL", "edge")
        bits = ax25.hdlc_bits(payload, tail_flags=1)
        assert ax25.deframe(bits) == [payload]     # last 8 bits ARE the flag


class TestAisCoding:
    def test_published_aivdm_vector(self):
        """The GPSd AIVDM documentation's canonical type-1 example:
        !AIVDM,1,1,,B,177KQJ5000G?tO`K>RA1wUbN0TKH,0*5C"""
        rpt = parse_position_report(
            sixbit_decode("177KQJ5000G?tO`K>RA1wUbN0TKH"))
        assert rpt["type"] == 1
        assert rpt["mmsi"] == 477553000
        assert rpt["nav_status"] == 5          # Moored
        assert rpt["sog_kn"] == 0.0
        assert abs(rpt["lon"] - (-122.34583)) < 1e-4
        assert abs(rpt["lat"] - 47.58283) < 1e-4
        assert rpt["cog_deg"] == 51.0
        assert rpt["heading_deg"] == 181
        assert rpt["timestamp"] == 15

    def test_sixbit_roundtrip(self):
        armored = "177KQJ5000G?tO`K>RA1wUbN0TKH"
        assert sixbit_encode(sixbit_decode(armored)) == armored

    @pytest.mark.parametrize("lat,lon", [(47.58283, -122.34583),
                                         (-33.8568, 151.2153),
                                         (59.9139, 10.7522),
                                         (-0.0005, -0.0005)])
    def test_build_parse_roundtrip(self, lat, lon):
        rpt = parse_position_report(build_position_report(
            mmsi=123456789, lat=lat, lon=lon, sog_kn=10.2, cog_deg=123.4,
            heading_deg=120, nav_status=3, msg_type=3, timestamp=42))
        assert rpt["mmsi"] == 123456789 and rpt["type"] == 3
        assert abs(rpt["lat"] - lat) < 2e-6 and abs(rpt["lon"] - lon) < 2e-6
        assert rpt["sog_kn"] == 10.2 and rpt["cog_deg"] == 123.4
        assert rpt["heading_deg"] == 120 and rpt["nav_status"] == 3
        assert rpt["timestamp"] == 42

    def test_bit_byte_roundtrip(self):
        rng = np.random.default_rng(3)
        bits = rng.integers(0, 2, 168).astype(np.uint8)
        np.testing.assert_array_equal(bytes_to_bits(bits_to_bytes(bits)),
                                      bits)

    def test_other_message_types_rejected(self):
        bits = build_position_report(mmsi=1, lat=0, lon=0)
        bits[0:6] = [0, 0, 0, 1, 0, 1]         # type 5: static voyage data
        assert parse_position_report(bits) is None


class TestAisPhysicalLayer:
    def test_gmsk_constant_envelope(self):
        iq = ais_modulate(build_position_report(mmsi=1, lat=1.0, lon=2.0),
                          fs=AIS_FS)
        np.testing.assert_allclose(np.abs(iq), 1.0, atol=1e-6)

    def test_gmsk_deviation_bounded(self):
        # modulation index 0.5 → |instantaneous frequency| ≤ baud/4
        iq = ais_modulate(build_position_report(mmsi=1, lat=1.0, lon=2.0),
                          fs=AIS_FS)
        freq = np.angle(iq[1:] * np.conj(iq[:-1])) * AIS_FS / (2 * np.pi)
        assert np.max(np.abs(freq)) <= 9600.0 / 4.0 + 1.0

    def test_host_loopback_clean(self):
        msg = build_position_report(mmsi=477553000, lat=47.58283,
                                    lon=-122.34583, sog_kn=12.3,
                                    cog_deg=51.0, heading_deg=181)
        iq = ais_modulate(msg, fs=AIS_FS)
        disc = np.angle(iq[1:] * np.conj(iq[:-1]))
        frames = deframe(nrzi_decode(ais_demod_bits(disc, AIS_SPS)))
        assert len(frames) == 1
        rpt = parse_position_report(bytes_to_bits(frames[0]))
        assert rpt["mmsi"] == 477553000
        assert abs(rpt["lat"] - 47.58283) < 2e-6
        assert abs(rpt["lon"] + 122.34583) < 2e-6

    def test_host_loopback_noisy(self):
        rng = np.random.default_rng(7)
        msg = build_position_report(mmsi=211234560, lat=54.18, lon=12.08,
                                    sog_kn=7.7)
        iq = ais_modulate(msg, fs=AIS_FS)
        iq = iq + (rng.standard_normal(len(iq))
                   + 1j * rng.standard_normal(len(iq))).astype(np.complex64) \
            * 0.05                                  # ≈ 23 dB SNR
        disc = np.angle(iq[1:] * np.conj(iq[:-1]))
        frames = deframe(nrzi_decode(ais_demod_bits(disc, AIS_SPS)))
        assert frames, "no frame decoded at 23 dB SNR"
        rpt = parse_position_report(bytes_to_bits(frames[0]))
        assert rpt["mmsi"] == 211234560

    def test_corrupted_fcs_rejected(self):
        msg = build_position_report(mmsi=1, lat=1.0, lon=2.0)
        bits = ais_frame_bits(msg)
        bits[60] ^= 1                              # flip a payload bit
        iq = gmsk_modulate(bits, fs=AIS_FS)
        disc = np.angle(iq[1:] * np.conj(iq[:-1]))
        assert deframe(nrzi_decode(ais_demod_bits(disc, AIS_SPS))) == []


class TestAisGraphChain:
    @pytest.mark.parametrize("block_len", [4096, 1536])
    def test_two_vessels_through_scheduler(self, block_len):
        reports = [
            dict(mmsi=477553000, lat=47.58283, lon=-122.34583, sog_kn=0.0,
                 cog_deg=51.0, heading_deg=181, nav_status=5),
            dict(mmsi=211234560, lat=54.1833, lon=12.0833, sog_kn=14.5,
                 cog_deg=200.0, heading_deg=199, nav_status=0),
        ]
        g = gt.Graph()
        src = g.emplace("AisSource", reports=reports, sample_rate=AIS_FS)
        demod = g.emplace("QuadratureDemod", gain=1.0)
        dec = g.emplace("AisDecoder", sps=AIS_SPS)
        g.connect_chain(src, demod, dec)
        _sched(g, block_len=block_len, sample_rate=AIS_FS).run_and_wait()
        assert len(dec.packets) == 2, dec.packets
        assert set(dec.vessels) == {477553000, 211234560}
        v = dec.vessels[211234560]
        assert abs(v["lat"] - 54.1833) < 2e-6
        assert abs(v["lon"] - 12.0833) < 2e-6
        assert v["sog_kn"] == 14.5 and v["nav_status"] == 0
        m = dec.vessels[477553000]
        assert m["nav_status"] == 5 and m["cog_deg"] == 51.0


class TestBlePrimitives:
    def test_crc_detects_single_bit_errors(self):
        pdu = bytes([0x00, 0x08]) + ADDR + bytes([2, 0x01, 0x06])
        good = crc24(pdu)
        for byte_i in range(len(pdu)):
            for bit_i in range(8):
                bad = bytearray(pdu)
                bad[byte_i] ^= 1 << bit_i
                assert crc24(bytes(bad)) != good

    def test_crc_bits_shape_and_determinism(self):
        b = crc24_bits(b"\x42\x10\xff")
        assert b.shape == (24,) and set(np.unique(b)) <= {0, 1}
        assert np.array_equal(b, crc24_bits(b"\x42\x10\xff"))

    def test_whitening_involution_and_channel_dependence(self):
        rng = np.random.default_rng(7)
        bits = rng.integers(0, 2, 300).astype(np.uint8)
        for ch in (37, 38, 39):
            assert np.array_equal(whiten_bits(whiten_bits(bits, ch), ch),
                                  bits)
        seqs = {ch: whitening_sequence(64, ch).tobytes()
                for ch in (37, 38, 39)}
        assert len(set(seqs.values())) == 3
        # period of the maximal-length 7-bit LFSR is 127
        s = whitening_sequence(254, 37)
        assert np.array_equal(s[:127], s[127:])
        assert s[:127].sum() == 64                   # 64 ones, 63 zeros

    def test_ad_structures_roundtrip(self):
        data = build_ad_structures(flags=0x06, name="GR4",
                                   manufacturer=b"\x4c\x00\x02")
        ads = parse_ad_structures(data)
        assert (0x01, b"\x06") in ads
        assert (0x09, b"GR4") in ads
        assert (0xFF, b"\x4c\x00\x02") in ads
        # malformed tail is ignored, prefix survives
        assert parse_ad_structures(data + b"\x09\x01")[:3] == ads


class TestBleBitCodec:
    def test_encode_decode_roundtrip(self):
        data = build_ad_structures(flags=0x05, name="GR4-TPU")
        bits = encode_advertising(ADDR, data, channel=38)
        # preamble 0xAA LSB-first then the AA LSB-first
        assert list(bits[:8]) == [0, 1, 0, 1, 0, 1, 0, 1]
        aa = sum(int(b) << k for k, b in enumerate(bits[8:40]))
        assert aa == ADV_ACCESS_ADDRESS
        pkts = decode_bits(bits, channel=38)
        assert len(pkts) == 1
        p = pkts[0]
        assert p["crc_ok"] and p["pdu_type"] == "ADV_IND"
        assert p["name"] == "GR4-TPU" and p["flags"] == 0x05
        assert p["adv_addr"] == "BC:9A:78:56:34:12"

    def test_wrong_channel_whitening_rejected(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="X"),
                                  channel=37)
        assert decode_bits(bits, channel=39) == []

    def test_crc_corruption_rejected(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="X"),
                                  channel=37)
        bits[60] ^= 1                                # a whitened PDU bit
        assert decode_bits(bits, channel=37) == []

    def test_aa_bit_error_budget(self):
        bits = encode_advertising(ADDR, build_ad_structures(name="Y"),
                                  channel=37)
        bits[10] ^= 1                                # error inside the AA
        bits[20] ^= 1
        pkts = decode_bits(bits, channel=37)
        assert len(pkts) == 1 and pkts[0]["name"] == "Y"

    def test_payload_length_guard(self):
        with pytest.raises(ValueError):
            encode_advertising(ADDR, bytes(32))      # 6 + 32 > 37
        with pytest.raises(ValueError):
            encode_advertising(b"\x01", b"")


class TestBleRfLoop:
    def test_gfsk_loop_with_noise_and_offset(self):
        data = build_ad_structures(flags=0x06, name="NOISY")
        iq = ble_modulate(ADDR, data, fs=BLE_FS, channel=37)
        iq = np.concatenate([np.zeros(777, np.complex64), iq,
                             np.zeros(500, np.complex64)])
        rng = np.random.default_rng(3)
        iq = iq + 0.05 * (rng.standard_normal(len(iq))
                          + 1j * rng.standard_normal(len(iq))
                          ).astype(np.complex64)     # ≈ 23 dB SNR
        disc = np.angle(iq[1:] * np.conj(iq[:-1]))
        pkts = decode_bits(np.asarray(ble_demod_bits(disc, BLE_SPS)), channel=37)
        assert len(pkts) == 1 and pkts[0]["name"] == "NOISY"

    def test_gfsk_constant_envelope(self):
        iq = gfsk_modulate(np.array([1, 0, 1, 1, 0, 0, 1, 0] * 8), fs=BLE_FS)
        assert np.allclose(np.abs(iq), 1.0, atol=1e-5)


class TestBleGraphChain:
    @pytest.mark.parametrize("block_len", [8192, 3000])
    def test_two_advertisers_through_scheduler(self, block_len):
        advertisers = [
            {"adv_addr": ADDR, "name": "GR4-TPU", "flags": 0x06},
            {"adv_addr": bytes(range(6)), "name": "BEACON-2",
             "pdu_type": 2, "manufacturer": b"\x4c\x00"},
        ]
        g = gt.Graph()
        src = g.emplace("BleSource", advertisers=advertisers,
                        sample_rate=BLE_FS, channel=37)
        demod = g.emplace("QuadratureDemod", gain=1.0)
        dec = g.emplace("BleDecoder", sps=BLE_SPS, channel=37)
        g.connect_chain(src, demod, dec)
        _sched(g, block_len=block_len, sample_rate=BLE_FS).run_and_wait()
        assert len(dec.packets) == 2, dec.packets
        names = {p.get("name") for p in dec.packets}
        assert names == {"GR4-TPU", "BEACON-2"}
        by_name = {p["name"]: p for p in dec.packets}
        assert by_name["GR4-TPU"]["adv_addr"] == "BC:9A:78:56:34:12"
        assert by_name["GR4-TPU"]["pdu_type"] == "ADV_IND"
        assert by_name["BEACON-2"]["pdu_type"] == "ADV_NONCONN_IND"
        assert (0xFF, b"\x4c\x00") in by_name["BEACON-2"]["ad"]
        assert dec.devices["05:04:03:02:01:00"]["name"] == "BEACON-2"
