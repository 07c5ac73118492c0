"""The port's 802.11a/g OFDM PHY (``blocks/wifi.py``) against the JAX
package's, on the CPU: every host helper on seeded inputs, frames of every
rate encoded and decoded, WifiSource and WifiDecoder through both schedulers
(the decoder behind a threefry ChannelModel), ``examples/wifi_link.yaml``
run by ``run_grc`` in both packages; and every case of ``tests/test_wifi.py``
run on the port.

Tolerances: the PHY is host NumPy in both packages and is compared exactly
(bits, soft values, waveforms, decoded frames with their float fields).
Behind ChannelModel the two packages' float32 channels differ in rounding:
the frames' rate, length, PSDU, FCS verdict and offset are compared exactly,
``cfo_hz`` within ``CFO_RTOL``."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import wifi as jw
from gnuradio4_tpu_torch.blocks import wifi as w
from gnuradio4_tpu_torch.blocks.wifi import (RATES, append_fcs, check_fcs,
                                             decode_frames, deinterleave,
                                             demap_soft, depuncture,
                                             encode_frame, interleave,
                                             map_symbols, puncture,
                                             scramble_sequence,
                                             viterbi_decode_soft, _conv_encode)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261017
CFO_RTOL = 1e-6


def _sched(g, **kw):
    return gt.Scheduler(g, device="cpu", **kw)


def _eq(a, b):
    """Exact equality of host results: arrays (values and dtype), bytes,
    numbers, and lists/tuples/dicts of them."""
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


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert sorted(fa) == sorted(fb)
        for k in fb:
            if k == "cfo_hz":
                assert abs(fa[k] - fb[k]) <= CFO_RTOL * abs(fb[k]), (fa[k], fb[k])
            else:
                _eq(fa[k], fb[k])


# -- host helpers: exact ----------------------------------------------------------

def test_host_helpers_equal():
    rng = np.random.default_rng(SEED)
    for name in ("N_FFT", "N_CP", "N_DATA", "PILOT_CARRIERS", "RATES",
                 "_RATE_BY_BITS", "_PUNCT", "_K_MOD", "_GRAY_AXIS"):
        _eq(getattr(w, name), getattr(jw, name))
    for name in ("PILOT_VALUES", "LTF_FREQ", "STF_FREQ", "_DATA_IDX",
                 "_PILOT_POLARITY"):
        _eq(getattr(w, name), getattr(jw, name))
    _eq(w.data_carrier_indices(), jw.data_carrier_indices())
    for seed in (0x7F, 0x5D, 0x01):
        _eq(w.scramble_sequence(300, seed), jw.scramble_sequence(300, seed))
    bits = rng.integers(0, 2, 246).astype(np.uint8)
    coded = w._conv_encode(bits)
    _eq(coded, jw._conv_encode(bits))
    for punct in ("1/2", "2/3", "3/4"):
        tx = w.puncture(coded, punct)
        _eq(tx, jw.puncture(coded, punct))
        _eq(w.depuncture(tx.astype(np.float64), punct),
            jw.depuncture(tx.astype(np.float64), punct))
    for rate, p in RATES.items():
        _eq(w.interleave_map(p["ncbps"], p["nbpsc"]),
            jw.interleave_map(p["ncbps"], p["nbpsc"]))
        blk = rng.integers(0, 2, p["ncbps"]).astype(np.uint8)
        _eq(w.interleave(blk, p["ncbps"], p["nbpsc"]),
            jw.interleave(blk, p["ncbps"], p["nbpsc"]))
        _eq(w.deinterleave(blk, p["ncbps"], p["nbpsc"]),
            jw.deinterleave(blk, p["ncbps"], p["nbpsc"]))
    for mod, nbpsc in (("bpsk", 1), ("qpsk", 2), ("qam16", 4), ("qam64", 6)):
        b = rng.integers(0, 2, nbpsc * 96).astype(np.uint8)
        pts = w.map_symbols(b, mod)
        _eq(pts, jw.map_symbols(b, mod))
        noisy = pts + 0.2 * (rng.standard_normal(len(pts))
                             + 1j * rng.standard_normal(len(pts)))
        _eq(w.demap_soft(noisy, mod), jw.demap_soft(noisy, mod))
    soft = np.clip(coded + rng.normal(0, 0.4, len(coded)), 0, 1)
    soft[5:50:4] = 0.5
    _eq(w.viterbi_decode_soft(soft), jw.viterbi_decode_soft(soft))
    data = bytes(rng.integers(0, 256, 37).astype(np.uint8))
    _eq(w._bytes_to_bits(data), jw._bytes_to_bits(data))
    _eq(w._bits_to_bytes(bits), jw._bits_to_bytes(bits))
    _eq(w.append_fcs(data), jw.append_fcs(data))
    for psdu in (w.append_fcs(data), data, b"abc"):
        _eq(w.check_fcs(psdu), jw.check_fcs(psdu))
    _eq(w.preamble(), jw.preamble())
    _eq(w._ltf_reference(), jw._ltf_reference())
    f53 = rng.standard_normal(53) + 1j * rng.standard_normal(53)
    _eq(w._ofdm_symbol(f53), jw._ofdm_symbol(f53))
    _eq(w._data_symbol(f53[:48], -1.0), jw._data_symbol(f53[:48], -1.0))
    x80 = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    _eq(w._fft_symbol(x80), jw._fft_symbol(x80))


@pytest.mark.parametrize("rate", sorted(RATES))
def test_frames_encode_and_decode_equal(rate):
    """Every rate's waveform, and its decode after CFO and AWGN, equal."""
    rng = np.random.default_rng(SEED + rate)
    psdu = append_fcs(bytes(rng.integers(0, 256, 60).astype(np.uint8)))
    iq = encode_frame(psdu, rate=rate, scrambler_seed=0x2B)
    _eq(iq, jw.encode_frame(psdu, rate=rate, scrambler_seed=0x2B))
    n = len(iq) + 300
    x = np.concatenate([np.zeros(200, np.complex64), iq,
                        np.zeros(100, np.complex64)])
    x = x * np.exp(2j * np.pi * 2e4 / 20e6 * np.arange(n)) + 0.02 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x.astype(np.complex64)
    got = decode_frames(x)
    _eq(got, jw.decode_frames(x))
    assert len(got) == 1 and got[0]["psdu"] == psdu and got[0]["fcs_ok"]


# -- the blocks through both schedulers --------------------------------------------

FRAMES = [{"psdu": append_fcs(b"frame one at 6"), "rate": 6},
          {"psdu": "text frame at 24 Mbps", "rate": 24, "add_fcs": True}]


def _source_graph(pkg, channel):
    g = pkg.Graph()
    reg = pkg.global_registry
    src = reg.create("WifiSource", frames=FRAMES, name="tx")
    snk = reg.create("VectorSink", name="wave")
    dec = reg.create("WifiDecoder", name="rx")
    g.connect(src, snk)
    if channel:
        chan = reg.create("ChannelModel", noise_voltage=0.02,
                          frequency_offset=0.0005, seed=3, name="chan")
        g.connect_chain(src, chan, dec)
    else:
        g.connect(src, dec)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=20000, sample_rate=20e6, **kw).run_and_wait()
    return np.asarray(snk.data()), dec


@pytest.mark.parametrize("channel", [False, True], ids=["direct", "channel"])
def test_source_and_decoder_equal_through_both_schedulers(channel):
    wt, dt = _source_graph(gt, channel)
    wj, dj = _source_graph(gr, channel)
    _eq(wt, wj)
    assert [f["psdu"][:-4] for f in dt.frames] == [b"frame one at 6",
                                                    b"text frame at 24 Mbps"]
    assert all(f["fcs_ok"] for f in dt.frames) and not dt.truncated
    _same_frames(dt.frames, dj.frames)
    if not channel:
        _eq(dt.frames, dj.frames)


def _flow(pkg):
    text = (ROOT / "examples" / "wifi_link.yaml").read_text()
    kw = {"scheduler_kwargs": {"device": "cpu"}} if pkg is gt else {}
    return {b.name: b for b in pkg.run_grc(text, **kw).graph.blocks}["rx"]


def test_wifi_link_example_runs_in_the_port_as_in_the_jax_package():
    """examples/wifi_link.yaml (a 24 Mbps frame through ChannelModel(seed=3)
    into WifiDecoder) through ``run_grc`` on the CPU: one frame, 24 Mbps,
    the PSDU's text, the FCS good; the same frame as the JAX package's."""
    rt, rj = _flow(gt), _flow(gr)
    assert len(rt.frames) == 1
    f = rt.frames[0]
    assert f["rate_mbps"] == 24 and f["fcs_ok"]
    assert f["psdu"][:-4] == b"Hello from the 802.11a OFDM PHY"
    _same_frames(rt.frames, rj.frames)


# -- tests/test_wifi.py, on the port -------------------------------------------------

PSDU = append_fcs(b"The quick brown fox jumps over the lazy dog")


class TestPrimitives:
    def test_scrambler_is_127_periodic_and_balanced(self):
        s = scramble_sequence(254, 0x7F)
        assert np.array_equal(s[:127], s[127:])
        assert s[:127].sum() == 64               # maximal-length property
        # different seeds give shifted (not equal) sequences
        assert not np.array_equal(scramble_sequence(127, 0x5D), s[:127])

    @pytest.mark.parametrize("punct", ["1/2", "2/3", "3/4"])
    def test_puncture_depuncture_shapes(self, punct):
        coded = np.arange(144) % 2
        tx = puncture(coded.astype(np.uint8), punct)
        rx = depuncture(tx.astype(np.float64), punct)
        assert len(rx) == 144
        kept = rx != 0.5
        np.testing.assert_array_equal(rx[kept], coded[kept])
        num, den = (int(v) for v in punct.split("/"))
        assert len(tx) * num == len(coded) // 2 * den

    @pytest.mark.parametrize("rate", sorted(RATES))
    def test_interleaver_is_a_permutation(self, rate):
        p = RATES[rate]
        bits = np.arange(p["ncbps"]) % 2
        rt = deinterleave(interleave(bits, p["ncbps"], p["nbpsc"]),
                          p["ncbps"], p["nbpsc"])
        np.testing.assert_array_equal(rt, bits)

    @pytest.mark.parametrize("mod,nbpsc", [("bpsk", 1), ("qpsk", 2),
                                           ("qam16", 4), ("qam64", 6)])
    def test_constellation_unit_power_and_demap(self, mod, nbpsc):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, nbpsc * 480).astype(np.uint8)
        pts = map_symbols(bits, mod)
        assert abs(np.mean(np.abs(pts) ** 2) - 1.0) < 0.05
        hard = (demap_soft(pts, mod) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(hard, bits)

    def test_viterbi_terminated_roundtrip_with_erasures(self):
        rng = np.random.default_rng(1)
        msg = np.concatenate([rng.integers(0, 2, 240),
                              np.zeros(6)]).astype(np.uint8)
        coded = _conv_encode(msg).astype(np.float64)
        coded[10:40:3] = 0.5                     # erasures
        coded[100] = 1 - coded[100]              # plus a hard error
        dec = viterbi_decode_soft(coded)
        np.testing.assert_array_equal(dec, msg)

    def test_fcs(self):
        assert check_fcs(PSDU)
        bad = bytearray(PSDU)
        bad[3] ^= 1
        assert not check_fcs(bytes(bad))


class TestRoundtrip:
    @pytest.mark.parametrize("rate", sorted(RATES))
    def test_all_rates_clean(self, rate):
        iq = encode_frame(PSDU, rate=rate)
        iq = np.concatenate([np.zeros(137, np.complex64), iq,
                             np.zeros(80, np.complex64)])
        fr = decode_frames(iq)
        assert len(fr) == 1
        assert fr[0]["rate_mbps"] == rate
        assert fr[0]["psdu"] == PSDU and fr[0]["fcs_ok"]

    @pytest.mark.parametrize("rate,snr_db,cfo_hz",
                             [(6, 8, 30e3), (12, 12, 50e3),
                              (24, 18, 20e3), (54, 26, 10e3)])
    def test_awgn_and_cfo(self, rate, snr_db, cfo_hz):
        rng = np.random.default_rng(7)
        iq = encode_frame(PSDU, rate=rate)
        iq = np.concatenate([np.zeros(211, np.complex64), iq,
                             np.zeros(64, np.complex64)])
        n = len(iq)
        iq = iq * np.exp(1j * (2 * np.pi * cfo_hz / 20e6 * np.arange(n)
                               + 0.7))
        sig_p = np.mean(np.abs(iq) ** 2)
        sigma = np.sqrt(sig_p / 10 ** (snr_db / 10) / 2)
        iq = iq + sigma * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))
        fr = decode_frames(iq.astype(np.complex64))
        assert len(fr) == 1 and fr[0]["psdu"] == PSDU and fr[0]["fcs_ok"]
        assert abs(fr[0]["cfo_hz"] - cfo_hz) < 3e3

    def test_corrupted_payload_fails_fcs_but_decodes(self):
        iq = encode_frame(PSDU, rate=12)
        # smash a mid-payload data symbol beyond FEC repair
        iq[600:680] = 0
        fr = decode_frames(np.concatenate([np.zeros(50, np.complex64), iq]))
        assert len(fr) == 1 and not fr[0]["fcs_ok"]

    def test_length_guard(self):
        with pytest.raises(ValueError):
            encode_frame(b"", rate=6)
        with pytest.raises(ValueError):
            encode_frame(bytes(4096), rate=6)

    def test_multipath_one_tap_echo(self):
        iq = encode_frame(PSDU, rate=12)
        iq = np.concatenate([np.zeros(90, np.complex64), iq,
                             np.zeros(64, np.complex64)])
        echo = np.zeros_like(iq)
        echo[3:] = 0.3j * iq[:-3]                # 150 ns echo, within CP
        fr = decode_frames((iq + echo).astype(np.complex64))
        assert len(fr) == 1 and fr[0]["psdu"] == PSDU and fr[0]["fcs_ok"]


class TestGraphChain:
    @pytest.mark.parametrize("block_len", [32768, 20000])
    def test_two_frames_two_rates_through_scheduler(self, block_len):
        frames = [{"psdu": append_fcs(b"frame one at 6"), "rate": 6},
                  {"psdu": append_fcs(b"frame two at 24 Mbps"), "rate": 24}]
        g = gt.Graph()
        src = g.emplace("WifiSource", frames=frames)
        dec = g.emplace("WifiDecoder")
        g.connect_chain(src, dec)
        _sched(g, block_len=block_len, sample_rate=20e6).run_and_wait()
        assert len(dec.frames) == 2, dec.frames
        assert dec.frames[0]["rate_mbps"] == 6
        assert dec.frames[0]["psdu"] == frames[0]["psdu"]
        assert dec.frames[1]["rate_mbps"] == 24
        assert dec.frames[1]["psdu"] == frames[1]["psdu"]
        assert all(f["fcs_ok"] for f in dec.frames)


class TestIncrementalDecoder:
    """ADVICE r2: frames spanning a buffer trim must survive; scans must be
    incremental (resume offset) and dedupe across the overlap."""

    def test_frame_spanning_trim_survives(self):
        from gnuradio4_tpu_torch.blocks.wifi import WifiDecoder
        iq = encode_frame(PSDU, rate=12)
        # cap the buffer at 200k samples; a frame straddles the trim point
        dec = WifiDecoder(max_buffer_s=0.01)
        pre = 255_000           # frame starts just before the first trim
        stream = np.concatenate([
            np.zeros(pre, np.complex64), iq.astype(np.complex64),
            np.zeros(300_000, np.complex64)])
        # feed in chunks that trigger several _process/trim rounds
        chunk = 262_144
        for i in range(0, len(stream), chunk):
            c = stream[i:i + chunk]
            dec.consume({"in": c}, {}, len(c), i)
        dec.stop()
        assert len(dec.frames) == 1, [f.get("sample_offset")
                                      for f in dec.frames]
        f = dec.frames[0]
        assert f["fcs_ok"] and bytes(f["psdu"]) == PSDU
        # absolute offset is preserved across trims (LTF lock point is
        # ~192 samples in: after the STF(160) + the LTF cyclic prefix(32))
        assert abs(f["sample_offset"] - (pre + 192)) < 128

    def test_no_duplicate_frames_across_scans(self):
        from gnuradio4_tpu_torch.blocks.wifi import WifiDecoder
        iq = encode_frame(PSDU, rate=24)
        dec = WifiDecoder()
        stream = np.concatenate([
            np.zeros(1000, np.complex64), iq.astype(np.complex64),
            np.zeros(600_000, np.complex64)])
        chunk = 262_144
        for i in range(0, len(stream), chunk):
            c = stream[i:i + chunk]
            dec.consume({"in": c}, {}, len(c), i)
        dec.stop()
        # the overlap re-scans the frame's region — it must appear ONCE
        assert len(dec.frames) == 1
        assert not dec.truncated
