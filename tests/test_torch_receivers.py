"""The port's six host receivers (``blocks/ieee802154.py``, ``adsb.py``,
``pocsag.py``, ``apt.py``, ``dcf77.py``, ``wefax.py``) against the JAX
package's, on the CPU: every case of ``tests/test_ieee802154.py``,
``test_adsb.py``, ``test_pocsag.py``, ``test_apt.py``, ``test_dcf77.py`` and
``test_wefax.py`` runs the same seeded input through both packages, and the
JAX test's assertions hold on the port's result. The sources feed the graph's
device and the decoders are host sinks, as in the JAX package.

Tolerances: the coding layers, the waveform synthesis and the decoders are
host NumPy in both packages and are compared exactly — frames, pages, times,
images and every field. Where a graph puts float32 device math in front of a
decoder (QuadratureDemod, Abs, the AM front end's Multiply and a NoiseSource's
Gaussian draws), the packages round differently and what must agree is the
decoded result; the APT image behind a discriminator is compared within
1e-4 (the JAX test's own tolerance against the one-shot decode)."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import (adsb as jadsb, apt as japt, dcf77 as jdcf,
                                  ieee802154 as jzb, pocsag as jpoc,
                                  sstv as jsstv, wefax as jwefax)
from gnuradio4_tpu_torch.blocks import (adsb, apt, dcf77, ieee802154 as zb,
                                        pocsag, sstv, wefax)

torch.set_num_threads(2)

MODS = {"adsb": (adsb, jadsb), "apt": (apt, japt), "dcf77": (dcf77, jdcf),
        "zb": (zb, jzb), "pocsag": (pocsag, jpoc), "wefax": (wefax, jwefax),
        "sstv": (sstv, jsstv)}
APT_ATOL = 1e-4


def _eq(a, b):
    """Exact equality of host results, with their types."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), (a, b)
        for k in b:
            _eq(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _both(name, fn):
    """``fn(module, package)`` with the port's module then the JAX package's;
    the results must be equal. Returns the port's."""
    t, j = MODS[name]
    got, want = fn(t, gt), fn(j, gr)
    _eq(got, want)
    return got


def _sched(pkg, g, **kw):
    extra = {"device": "cpu"} if pkg is gt else {}
    return pkg.Scheduler(g, **kw, **extra)


# -- IEEE 802.15.4 --------------------------------------------------------------------

SPS = 4


class TestIeee802154Primitives:
    def test_crc16_kermit_check_vector(self):
        assert _both("zb", lambda m, _: m.crc16_kermit(b"123456789")) == 0x2189

    def test_fcs_roundtrip_and_rejection(self):
        def f(m, _):
            psdu = m.append_fcs(b"\x01\x02\x03hello")
            bad = bytearray(psdu)
            bad[2] ^= 0x10
            return m.check_fcs(psdu), m.check_fcs(bytes(bad)), m.check_fcs(b"\x00")
        assert _both("zb", f) == (True, False, False)

    def test_chip_table_structure(self):
        tab = _both("zb", lambda m, _: m.chip_table())
        assert tab.shape == (16, 32)
        d = (tab[:, None, :] != tab[None, :, :]).sum(axis=2)
        assert d[~np.eye(16, dtype=bool)].min() >= 12
        flip = np.zeros(32, np.uint8)
        flip[1::2] = 1
        assert np.array_equal(tab[8:], tab[:8] ^ flip)
        for k in range(1, 8):
            assert np.array_equal(tab[k], np.roll(tab[0], 4 * k))

    def test_nibble_order(self):
        syms, back = _both("zb", lambda m, _: (m.bytes_to_symbols(b"\xa7"),
                                               m.symbols_to_bytes(m.bytes_to_symbols(b"\xa7"))))
        assert list(syms) == [0x7, 0xA] and back == b"\xa7"

    def test_frame_symbols_guard(self):
        for m in (zb, jzb):
            with pytest.raises(ValueError):
                m.frame_symbols(b"\x00")
            with pytest.raises(ValueError):
                m.frame_symbols(bytes(128))


class TestIeee802154Waveform:
    def test_near_constant_envelope(self):
        iq = _both("zb", lambda m, _: m.oqpsk_modulate(np.arange(16, dtype=np.uint8), sps=8))
        env = np.abs(iq[16:-32])
        assert env.min() > 0.6 and env.max() < 1.2

    def test_clean_loop_exact(self):
        def f(m, _):
            psdu = m.build_data_frame(b"ZIGBEE-TPU", seq=7, dst_addr=0x1234,
                                      src_addr=0x00AB)
            return m.decode_stream(m.ieee802154_modulate(psdu, sps=SPS), sps=SPS)
        frames = _both("zb", f)
        assert len(frames) == 1
        fr = frames[0]
        assert fr["fcs_ok"] and fr["chip_errors"] == 0
        assert fr["frame_type"] == "data" and fr["seq"] == 7
        assert fr["dst_addr"] == 0x1234 and fr["src_addr"] == 0x00AB
        assert fr["payload"] == b"ZIGBEE-TPU"

    def test_loop_with_noise_phase_and_padding(self):
        def f(m, _):
            iq = m.ieee802154_modulate(m.build_data_frame(b"NOISY", seq=1), sps=SPS)
            iq = np.concatenate([np.zeros(333, np.complex64), iq,
                                 np.zeros(200, np.complex64)]) * np.exp(1j * 1.1)
            rng = np.random.default_rng(5)
            iq = iq + 0.15 * (rng.standard_normal(len(iq))
                              + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
            return m.decode_stream(iq, sps=SPS)
        frames = _both("zb", f)
        assert len(frames) == 1 and frames[0]["payload"] == b"NOISY"

    def test_chip_error_resilience_via_dsss(self):
        def f(m, _):
            iq = m.ieee802154_modulate(m.build_data_frame(b"ROBUST", seq=2), sps=SPS).copy()
            for k in range(20):
                s = 12 * 32 * SPS + k * 97 * SPS
                iq[s:s + SPS] = -iq[s:s + SPS]
            return m.decode_stream(iq, sps=SPS)
        frames = _both("zb", f)
        assert len(frames) == 1 and frames[0]["payload"] == b"ROBUST"
        assert frames[0]["chip_errors"] > 0

    def test_corrupted_fcs_rejected(self):
        def f(m, _):
            psdu = bytearray(m.append_fcs(m.build_data_frame(b"BAD")))
            psdu[4] ^= 0xFF
            return m.decode_stream(m.oqpsk_modulate(m.frame_symbols(bytes(psdu)),
                                                    sps=SPS), sps=SPS)
        assert _both("zb", f) == []

    def test_mac_parse_non_intra_pan(self):
        fcf = 0x8801
        psdu = bytes([fcf & 0xFF, fcf >> 8, 9, 0xCD, 0xAB, 0x34, 0x12,
                      0xEF, 0xBE, 0x78, 0x56])
        h = _both("zb", lambda m, _: m.parse_mac_header(m.append_fcs(psdu + b"PP")))
        assert h["dst_pan"] == 0xABCD and h["dst_addr"] == 0x1234
        assert h["src_pan"] == 0xBEEF and h["src_addr"] == 0x5678
        assert h["payload"] == b"PP"


class TestIeee802154Graph:
    @pytest.mark.parametrize("block_len", [8192, 3000])
    def test_two_frames_through_scheduler(self, block_len):
        frames = [{"payload": b"HELLO-PAN", "seq": 1, "src_addr": 0x0001},
                  {"payload": b"SECOND", "seq": 2, "src_addr": 0x0002,
                   "dst_addr": 0x00FE}]

        def f(_, pkg):
            g = pkg.Graph()
            src = g.emplace("Ieee802154Source", frames=frames, sps=SPS)
            dec = g.emplace("Ieee802154Decoder", sps=SPS)
            g.connect_chain(src, dec)
            _sched(pkg, g, block_len=block_len,
                   sample_rate=SPS * 2_000_000.0).run_and_wait()
            return dec.frames
        got = _both("zb", f)
        assert len(got) == 2
        assert [fr["seq"] for fr in got] == [1, 2]
        assert got[0]["payload"] == b"HELLO-PAN" and got[1]["payload"] == b"SECOND"
        assert got[1]["dst_addr"] == 0x00FE
        assert all(fr["fcs_ok"] for fr in got)


# -- ADS-B ----------------------------------------------------------------------------

class TestModeSCoding:
    def test_crc_of_valid_frame_is_zero(self):
        f = _both("adsb", lambda m, _: m.make_df17_identification(0xABCDEF, "GR4TPU01"))
        assert len(f) == 112 and adsb.crc24(f) == jadsb.crc24(f) == 0

    def test_single_bit_error_breaks_crc(self):
        def f(m, _):
            fr = m.make_df17_identification(0x4840D6, "KLM1023")
            out = []
            for i in (0, 5, 31, 87, 111):
                g = fr.copy()
                g[i] ^= 1
                out.append(m.crc24(g))
            return out
        assert all(c != 0 for c in _both("adsb", f))

    def test_callsign_roundtrip(self):
        for cs in ("KLM1023", "BAW38K", "N123AB", "A"):
            recs = _both("adsb", lambda m, _: m.decode_bits_stream(
                m.modulate([m.make_df17_identification(0x123456, cs)])))
            assert len(recs) == 1 and recs[0]["callsign"] == cs
            assert recs[0]["icao"] == 0x123456 and recs[0]["df"] == 17

    def test_decode_under_noise(self):
        def f(m, _):
            rng = np.random.default_rng(0)
            frames = [m.make_df17_identification(0x100000 + k, f"AC{k:05d}")
                      for k in range(5)]
            wave = m.modulate(frames)
            return m.decode_bits_stream(wave + 0.05 * rng.standard_normal(len(wave)))
        recs = _both("adsb", f)
        assert [r["callsign"] for r in recs] == [f"AC{k:05d}" for k in range(5)]


def _adsb_graph(pkg, iq, block_len, **settings):
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=iq)
    mag = g.emplace("Abs")
    dec = g.emplace("AdsbDecoder", **settings)
    g.connect_chain(src, mag, dec)
    _sched(pkg, g, block_len=block_len, sample_rate=2e6).run_and_wait()
    return dec


class TestAdsbGraphChain:
    def test_iq_stream_to_aircraft_table(self):
        rng = np.random.default_rng(1)
        frames = [adsb.make_df17_identification(0xABC000 + k, f"TPU{k:04d}")
                  for k in range(8)]
        wave = adsb.modulate(frames, gap_us=137.5)
        iq = (wave * np.exp(1j * np.cumsum(rng.normal(0.0, 0.3, len(wave))))
              ).astype(np.complex64)
        iq += (0.02 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)
        dec = _adsb_graph(gt, iq, 1000, threshold=0.3)
        want = _adsb_graph(gr, iq, 1000, threshold=0.3)
        _eq(dec.frames, want.frames)
        _eq(dec.aircraft, want.aircraft)
        assert len(dec.frames) == 8
        assert {i: a["callsign"] for i, a in dec.aircraft.items()} \
            == {0xABC000 + k: f"TPU{k:04d}" for k in range(8)}


class TestAdsbPosition:
    EVEN = "8D40621D58C382D690C8AC2863A7"
    ODD = "8D40621D58C386435CC412692AD6"

    def test_published_vector_pair(self):
        def f(m, _):
            ev, od = m.hex_to_bits(self.EVEN), m.hex_to_bits(self.ODD)
            pe, po = m.parse_position_fields(ev), m.parse_position_fields(od)
            return (m.crc24(ev), m.crc24(od), pe, po,
                    m.cpr_decode(pe["lat_cpr"], pe["lon_cpr"], po["lat_cpr"],
                                 po["lon_cpr"]))
        ce, co, pe, po, (lat, lon) = _both("adsb", f)
        assert ce == 0 and co == 0 and not pe["odd"] and po["odd"]
        assert pe["alt_ft"] == 38000 and po["alt_ft"] == 38000
        assert abs(lat - 52.2572) < 1e-3 and abs(lon - 3.91937) < 1e-3

    def test_encode_decode_roundtrip(self):
        for lat, lon, alt in [(52.2572, 3.91937, 38000), (-33.9461, 151.1772, 2500),
                              (37.6188, -122.3756, 12775)]:
            def f(m, _):
                fe = m.make_df17_airborne_position(0x111111, lat, lon, alt, odd=False)
                fo = m.make_df17_airborne_position(0x111111, lat, lon, alt, odd=True)
                pe, po = m.parse_position_fields(fe), m.parse_position_fields(fo)
                return (m.crc24(fe), m.crc24(fo), pe,
                        m.cpr_decode(pe["lat_cpr"], pe["lon_cpr"], po["lat_cpr"],
                                     po["lon_cpr"]))
            ce, co, pe, (glat, glon) = _both("adsb", f)
            assert ce == 0 and co == 0 and pe["alt_ft"] == alt
            assert abs(glat - lat) < 1e-3 and abs(glon - lon) < 1e-3

    def test_graph_chain_builds_aircraft_picture(self):
        rng = np.random.default_rng(2)
        frames = [adsb.make_df17_identification(0x40621D, "KLM1023"),
                  adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937,
                                                   38000, odd=False),
                  adsb.make_df17_airborne_position(0x40621D, 52.2572, 3.91937,
                                                   38000, odd=True)]
        wave = adsb.modulate(frames)
        iq = (wave * np.exp(1j * np.cumsum(rng.normal(0, 0.25, len(wave))))
              ).astype(np.complex64)
        dec = _adsb_graph(gt, iq, 700)
        _eq(dec.aircraft, _adsb_graph(gr, iq, 700).aircraft)
        ac = dec.aircraft[0x40621D]
        assert ac["callsign"] == "KLM1023" and ac["alt_ft"] == 38000
        assert abs(ac["lat"] - 52.2572) < 1e-3 and abs(ac["lon"] - 3.91937) < 1e-3


# -- POCSAG ---------------------------------------------------------------------------

class TestBch:
    def test_valid_codeword_zero_syndrome(self):
        for data in (0x00000, 0x12345, 0x1FFFFF, 0x0F0F0):
            out = _both("pocsag", lambda m, _: m.correct_codeword(m.encode_codeword(data)))
            assert out == (data & 0x1FFFFF, 0)

    def test_corrects_all_one_and_two_bit_errors(self):
        def f(m, _):
            cw = m.encode_codeword(0x12345)
            rng = np.random.default_rng(0)
            out = []
            for _ in range(300):
                k = int(rng.integers(1, 3))
                w = cw
                for e in rng.choice(31, size=k, replace=False):
                    w ^= 1 << (int(e) + 1)
                out.append((m.correct_codeword(w), k))
            return out
        for (data, nerr), k in _both("pocsag", f):
            assert data == 0x12345 and nerr == k

    def test_three_bit_errors_detected_or_miscorrected_not_silent(self):
        def f(m, _):
            cw = m.encode_codeword(0x12345)
            return m.correct_codeword(cw ^ (1 << 5) ^ (1 << 9) ^ (1 << 20))
        out = _both("pocsag", f)
        assert out is None or out != (0x12345, 0)


class TestPocsagTransmission:
    def test_loopback(self):
        pages = _both("pocsag", lambda m, _: m.decode_transmission(
            m.encode_transmission(1234567, 2, "GR4-TPU PAGING OK")))
        assert len(pages) == 1 and pages[0]["ric"] == 1234567
        assert pages[0]["function"] == 2
        assert pages[0]["message"] == "GR4-TPU PAGING OK"

    def test_two_bit_errors_per_codeword_still_decode(self):
        def f(m, _):
            rng = np.random.default_rng(1)
            noisy = m.encode_transmission(99, 0, "ECC WORKS").copy()
            for start in range(576, len(noisy) - 32, 32):
                for e in rng.choice(31, size=2, replace=False):
                    noisy[start + int(e)] ^= 1
            return m.decode_transmission(noisy)
        pages = _both("pocsag", f)
        assert pages and pages[0]["message"] == "ECC WORKS"
        assert pages[0]["corrected_bits"] > 0

    def test_frame_position_carries_ric_lsbs(self):
        for ric in (8, 13, 1048575):
            pages = _both("pocsag", lambda m, _: m.decode_transmission(
                m.encode_transmission(ric, 1, "X")))
            assert pages and pages[0]["ric"] == ric


class TestPocsagGraphChain:
    def test_fsk_chain_decodes_page(self):
        rng = np.random.default_rng(2)
        bits = pocsag.encode_transmission(423133, 3, "CALL THE TPU ROOM")
        sps, dev = 32, 4500.0
        fs = 1200.0 * sps
        freq = np.repeat(np.where(bits == 0, dev, -dev), sps)
        iq = np.exp(1j * 2 * np.pi * np.cumsum(freq) / fs).astype(np.complex64)
        iq += (0.05 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)

        def f(_, pkg):
            g = pkg.Graph()
            src = g.emplace("VectorSource", data=iq)
            qd = g.emplace("QuadratureDemod", gain=fs / (2 * np.pi * dev))
            dec = g.emplace("PocsagDecoder", sps=float(sps), invert=True)
            g.connect_chain(src, qd, dec)
            _sched(pkg, g, block_len=4800, sample_rate=fs).run_and_wait()
            return dec.pages
        pages = _both("pocsag", f)
        assert len(pages) == 1 and pages[0]["ric"] == 423133
        assert pages[0]["function"] == 3
        assert pages[0]["message"] == "CALL THE TPU ROOM"


# -- APT ------------------------------------------------------------------------------

def _test_image(rows, rng=None):
    rng = rng or np.random.default_rng(0)
    x = np.linspace(0.0, 1.0, 909, dtype=np.float32)
    img = np.empty((rows, 909), np.float32)
    for r in range(rows):
        img[r] = 0.5 * x + 0.3 * ((x * (4 + r % 3)) % 1.0 > 0.5)
    img += rng.uniform(0.0, 0.2, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _row_corr(dec, ref):
    assert dec.shape[0] >= ref.shape[0] - 1
    return min(np.corrcoef(dec[r], ref[r])[0, 1] for r in range(dec.shape[0]))


class TestAptCoding:
    def test_line_layout(self):
        row = np.linspace(0.0, 1.0, 909, dtype=np.float32)
        line = _both("apt", lambda m, _: m._line_template(row))
        assert line.shape == (apt.LINE_WORDS,)
        np.testing.assert_array_equal(line[:39], apt.SYNC_A)
        np.testing.assert_array_equal(line[apt.IMAGE_A], row)
        np.testing.assert_allclose(line[1040 + 86:1040 + 86 + 909], 0.5 * row)

    def test_modulate_envelope_roundtrip(self):
        img = _test_image(10)
        dec = _both("apt", lambda m, _: m.decode_image(m.apt_envelope(m.apt_modulate(img))))
        assert dec.shape == (10, 909) and _row_corr(dec, img) > 0.97

    def test_decode_under_noise(self):
        def f(m, _):
            rng = np.random.default_rng(1)
            img = _test_image(8, rng)
            audio = m.apt_modulate(img)
            audio = audio + 0.05 * rng.standard_normal(len(audio)).astype(np.float32)
            return img, m.decode_image(m.apt_envelope(audio))
        img, dec = _both("apt", f)
        assert dec.shape[0] == 8 and _row_corr(dec, img) > 0.95

    def test_sync_locks_despite_leading_junk(self):
        def f(m, _):
            rng = np.random.default_rng(2)
            img = _test_image(6, rng)
            audio = m.apt_modulate(img)
            junk = (0.1 * rng.standard_normal(3333)).astype(np.float32)
            return img, m.decode_image(m.apt_envelope(np.concatenate([junk, audio])))
        img, dec = _both("apt", f)
        assert dec.shape[0] >= 5
        assert max(np.corrcoef(dec[0], img[r])[0, 1] for r in range(3)) > 0.95

    def test_empty_and_short_streams(self):
        out = _both("apt", lambda m, _: (m.decode_image(np.zeros(0, np.float32)),
                                         m.decode_image(np.zeros(100, np.float32)),
                                         m.find_sync_offsets(np.zeros(50, np.float32))))
        assert out[0].shape == out[1].shape == (0, 909) and out[2] == []


class TestAptGraphChain:
    def test_decoder_sink_matches_oneshot(self):
        img = _test_image(6)
        audio = apt.apt_modulate(img)

        def f(_, pkg):
            g = pkg.Graph()
            dec = g.emplace("AptDecoder")
            g.connect(g.emplace("VectorSource", data=audio), dec)
            _sched(pkg, g, block_len=7001, sample_rate=20800.0).run_and_wait()
            return dec.image
        image = _both("apt", f)
        ref = apt.decode_image(apt.apt_envelope(audio.astype(np.float64)))
        assert image.shape == ref.shape
        np.testing.assert_allclose(image, ref, atol=1e-4)
        assert _row_corr(image, img) > 0.97

    def test_fm_downlink_chain(self):
        rng = np.random.default_rng(3)
        img = _test_image(5, rng)
        audio = apt.apt_modulate(img)
        fs, f_dev = 20800.0, 4000.0
        iq = np.exp(1j * (2 * np.pi * f_dev / fs * np.cumsum(audio.astype(np.float64))
                          + 0.7)).astype(np.complex64)
        iq += (0.01 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)
        images = {}
        for name, pkg in (("port", gt), ("jax", gr)):
            g = pkg.Graph()
            dem = g.emplace("QuadratureDemod", gain=fs / (2 * np.pi * f_dev))
            dec = g.emplace("AptDecoder")
            g.connect_chain(g.emplace("VectorSource", data=iq), dem, dec)
            _sched(pkg, g, block_len=9973, sample_rate=fs).run_and_wait()
            images[name] = dec.image
        assert images["port"].shape == images["jax"].shape
        np.testing.assert_allclose(images["port"], images["jax"], atol=APT_ATOL)
        assert images["port"].shape[0] >= 4
        assert _row_corr(images["port"], img) > 0.93

    def test_history_bound(self):
        audio = apt.apt_modulate(_test_image(8))

        def f(_, pkg):
            g = pkg.Graph()
            dec = g.emplace("AptDecoder", max_lines=4)
            g.connect(g.emplace("VectorSource", data=audio), dec)
            _sched(pkg, g, block_len=8192, sample_rate=20800.0).run_and_wait()
            return dec.image, len(dec._audio)
        image, n_audio = _both("apt", f)
        assert n_audio <= 4 * 0.5 * 20800
        assert 3 <= image.shape[0] <= 4


# -- DCF77 ----------------------------------------------------------------------------

T0 = dict(minute=34, hour=21, day=17, weekday=1, month=8, year2=26, cest=True)
T1 = dict(minute=35, hour=21, day=17, weekday=1, month=8, year2=26, cest=True)
T2 = dict(minute=59, hour=23, day=31, weekday=7, month=12, year2=99, cest=False)


class TestDcf77Coding:
    @pytest.mark.parametrize("t", [T0, T1, T2, dict(minute=0, hour=0, day=1,
                                                    weekday=1, month=1, year2=0)])
    def test_encode_decode_roundtrip(self, t):
        d = _both("dcf77", lambda m, _: m.decode_minute(m.encode_minute(**t)))
        assert d == {**t, "cest": t.get("cest", False)}

    def test_fixed_bits(self):
        bits = _both("dcf77", lambda m, _: m.encode_minute(**T0))
        assert bits[0] == 0 and bits[20] == 1 and bits[17] == 1 and bits[18] == 0

    def test_parity_violations_rejected(self):
        for flip in (22, 30, 40, 51):
            def f(m, _):
                bad = m.encode_minute(**T0)
                bad[flip] ^= 1
                return m.decode_minute(bad)
            assert _both("dcf77", f) is None, flip

    def test_nonsense_fields_rejected(self):
        def f(m, _):
            bits = m.encode_minute(minute=34, hour=21, day=17, weekday=1,
                                   month=8, year2=26)
            bits[29:35] = [1, 0, 0, 1, 0, 1]
            bits[35] = int(bits[29:35].sum()) & 1
            return m.decode_minute(bits)
        assert _both("dcf77", f) is None

    def test_envelope_pulse_widths(self):
        fs = 1000.0
        bits = dcf77.encode_minute(**T0)
        env = _both("dcf77", lambda m, _: m.am_envelope(bits, fs=fs))
        assert len(env) == 60000
        for sec, b in enumerate(bits):
            lo = int(sec * fs)
            assert int(np.sum(env[lo:lo + int(0.3 * fs)] < 0.5)) == (200 if b else 100)
        assert np.all(env[59000:] == 1.0)


def _dcf_chain(pkg, minutes, block_len, noise=0.0, carrier=False, seed=0):
    fs = 1000.0
    n_total = int(60 * fs) * len(minutes)
    g = pkg.Graph()
    head = src = g.emplace("Dcf77Source", minutes=minutes, sample_rate=fs)
    if carrier:
        to_iq = g.emplace("Convert", to="complex64")
        tone = g.emplace("ComplexToneSource", frequency=77.5, n_samples=n_total)
        mul = g.emplace("Multiply", n_inputs=2)
        mag = g.emplace("Abs")
        g.connect(src, to_iq)
        g.connect(to_iq, mul, dst_port="in0")
        g.connect(tone, mul, dst_port="in1")
        g.connect(mul, mag)
        head = mag
    if noise:
        nz = g.emplace("NoiseSource", std=noise, seed=seed, n_samples=n_total)
        add = g.emplace("Add", n_inputs=2)
        g.connect(head, add, dst_port="in0")
        g.connect(nz, add, dst_port="in1")
        head = add
    dec = g.emplace("Dcf77Decoder", sample_rate=fs)
    g.connect(head, dec)
    _sched(pkg, g, block_len=block_len, sample_rate=fs).run_and_wait()
    return dec


class TestDcf77ReceiverChain:
    @pytest.mark.parametrize("block_len", [60000, 8192, 1000])
    def test_two_minutes_through_scheduler(self, block_len):
        frames, last = _both("dcf77", lambda _, pkg: (
            lambda d: (d.frames, d.last_time))(_dcf_chain(pkg, [T0, T1], block_len)))
        assert len(frames) == 2
        assert frames[0]["minute"] == 34 and frames[1]["minute"] == 35
        assert last["hour"] == 21 and last["cest"]

    def test_noisy_envelope(self):
        frames = _both("dcf77", lambda _, pkg: _dcf_chain(pkg, [T0], 8192,
                                                          noise=0.08).frames)
        assert frames and frames[0]["minute"] == 34

    def test_am_carrier_front_end(self):
        frames = _both("dcf77", lambda _, pkg: _dcf_chain(pkg, [T2], 8192,
                                                          carrier=True).frames)
        assert frames and frames[0] == {**T2}

    def test_corrupted_frame_not_decoded(self):
        fs = 1000.0
        bits = dcf77.encode_minute(**T0)
        bits[23] ^= 1
        env = dcf77.am_envelope(bits, fs=fs)

        def f(_, pkg):
            g = pkg.Graph()
            dec = g.emplace("Dcf77Decoder", sample_rate=fs)
            g.connect(g.emplace("VectorSource", data=env), dec)
            _sched(pkg, g, block_len=10000, sample_rate=fs).run_and_wait()
            return dec.frames
        assert _both("dcf77", f) == []


# -- WEFAX ----------------------------------------------------------------------------

FS = 11025.0


def _chart(n_lines=6, width=800):
    img = np.zeros((n_lines, width), np.uint8)
    img[:] = np.linspace(0, 255, width)[None, :]
    if n_lines > 2:
        img[2] = 30
    if n_lines > 4:
        img[4] = 220
    return img


def test_wefax_takes_sstv_helpers_from_the_port():
    assert wefax.instantaneous_frequency is sstv.instantaneous_frequency
    assert wefax._close_gaps is sstv._close_gaps
    audio = wefax.wefax_modulate(_chart(2), fs=FS)
    _eq(sstv.instantaneous_frequency(audio, FS),
        jsstv.instantaneous_frequency(audio, FS))


class TestWefaxWaveform:
    def test_phasing_line_shape(self):
        line = _both("wefax", lambda m, _: m.phasing_line_freqs(FS))
        assert len(line) == int(round(60.0 / wefax.LPM * FS))
        pulse_n = int(round(wefax.PHASE_PULSE_FRAC * len(line)))
        assert np.all(line[:pulse_n] == wefax.F_BLACK)
        assert np.all(line[pulse_n:] == wefax.F_WHITE)

    def test_total_duration(self):
        audio = _both("wefax", lambda m, _: m.wefax_modulate(
            _chart(4), fs=FS, start_s=2.0, n_phasing=10, stop_s=1.0))
        line_s = 60.0 / wefax.LPM
        expect = (2.0 + 10 * line_s + 4 * line_s + 1.0) * FS
        assert abs(len(audio) - expect) < 1 + 14 * 0.5

    def test_rgb_input_converted_by_luma(self):
        rgb = np.repeat(_chart(2)[..., None], 3, axis=-1)
        a1, a2 = _both("wefax", lambda m, _: (m.wefax_modulate(rgb, fs=FS),
                                              m.wefax_modulate(_chart(2), fs=FS)))
        np.testing.assert_allclose(a1, a2)

    def test_start_tone_detected(self):
        pos = _both("wefax", lambda m, _: m.detect_start_tone(
            MODS["sstv"][m is jwefax].instantaneous_frequency(
                m.wefax_modulate(_chart(2), fs=FS, start_s=2.0), FS), FS))
        assert pos is not None and abs(pos - 2.0 * FS) < FS / wefax.START_TONE_HZ

    def test_no_start_tone_in_plain_audio(self):
        tone = np.sin(2 * np.pi * 1900.0 / FS * np.arange(int(3 * FS)))
        assert _both("wefax", lambda m, _: m.detect_start_tone(
            MODS["sstv"][m is jwefax].instantaneous_frequency(tone, FS), FS)) is None


def _wefax_decode(m, audio, **settings):
    d = m.WefaxDecoder(**settings)
    d.consume({"in": audio}, {}, len(audio), 0)
    d.stop()
    return d.started, d.image


class TestWefaxLoopback:
    def test_clean_roundtrip(self):
        img = _chart(6)
        started, image = _both("wefax", lambda m, _: _wefax_decode(
            m, m.wefax_modulate(img, fs=FS)))
        assert started and image.shape == img.shape
        assert np.abs(image.astype(float) - img.astype(float)).mean() < 0.5

    @pytest.mark.parametrize("noise,tol", [(0.05, 8.0), (0.10, 15.0)])
    def test_noise(self, noise, tol):
        img = _chart(6)

        def f(m, _):
            rng = np.random.default_rng(2)
            audio = m.wefax_modulate(img, fs=FS)
            return _wefax_decode(m, (audio + noise * rng.standard_normal(len(audio))
                                     ).astype(np.float32))
        _, image = _both("wefax", f)
        assert image.shape == img.shape
        assert np.abs(image.astype(float) - img.astype(float)).mean() < tol

    def test_stop_tone_truncates_exactly(self):
        _, image = _both("wefax", lambda m, _: _wefax_decode(
            m, m.wefax_modulate(_chart(5), fs=FS, stop_s=1.0)))
        assert image.shape[0] == 5

    def test_custom_width(self):
        img = _chart(3, width=400)
        _, image = _both("wefax", lambda m, _: _wefax_decode(
            m, m.wefax_modulate(img, fs=FS), width=400))
        assert image.shape == (3, 400)
        assert np.abs(image.astype(float) - img.astype(float)).mean() < 0.5


class TestWefaxGraph:
    @pytest.mark.parametrize("block_len", [2048, 8192])
    def test_source_to_decoder_chain(self, block_len):
        img = _chart(4)

        def f(_, pkg):
            g = pkg.Graph()
            src = g.emplace("WefaxSource", image=img)
            dec = g.emplace("WefaxDecoder")
            g.connect(src, dec)
            _sched(pkg, g, block_len=block_len, sample_rate=FS).run_and_wait()
            return dec.image
        image = _both("wefax", f)
        assert image.shape == img.shape
        assert np.abs(image.astype(float) - img.astype(float)).mean() < 0.5

    def test_incremental_live_image(self):
        img = _chart(8)

        def f(m, _):
            audio = m.wefax_modulate(img, fs=FS)
            d = m.WefaxDecoder()
            seen = []
            step = int(FS)
            for i in range(0, len(audio), step):
                chunk = audio[i:i + step]
                d.consume({"in": chunk}, {}, len(chunk), i)
                seen.append(d.image.shape[0])
            d.stop()
            return d.image, seen
        image, seen = _both("wefax", f)
        assert image.shape[0] == 8
        assert sorted(seen) == seen and seen[0] < 8


# -- the sources feed the graph's device -------------------------------------------

@pytest.mark.parametrize("btype, settings", [
    ("Ieee802154Source", {"frames": [{"payload": b"DEV", "seq": 3}], "sps": 4}),
    ("Dcf77Source", {"minutes": [T0], "sample_rate": 1000.0}),
    ("WefaxSource", {"image": np.zeros((2, 64), np.uint8)})])
def test_sources_feed_the_same_samples(btype, settings):
    """Each host-fed source, up to two steps through both schedulers: the
    samples its feed puts on the graph's device equal the JAX package's."""
    def f(_, pkg):
        g = pkg.Graph()
        snk = g.emplace("VectorSink")
        g.connect(g.emplace(btype, **settings), snk)
        s = _sched(pkg, g, block_len=4096, sample_rate=1e6)
        s.run_and_wait(2)
        return np.asarray(snk.data())
    out = _both("zb", f)
    assert 0 < out.shape[0] <= 8192 and np.any(out != 0)
