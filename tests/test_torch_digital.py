"""The port's digital-modem layer (``ops/digital.py``, ``blocks/digital.py``)
against the JAX package's, on the CPU, from the same seeded NumPy inputs over
several scheduler steps; and the registry names, settings and defaults of
every block type and alias this layer's slice added.

Tolerances: bits, symbol indices, CRC bits, detection indices, BER counts
and packets exactly; feed-forward float32/complex64 outputs within
``FF_RTOL`` = 1e-5 of max(1, |y|); the feedback scans (``MMSymbolSync``,
``PfbClockSync``) within ``SCAN_ATOL`` = 1e-4 over at least 1024 symbols.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import digital as jdig
from gnuradio4_tpu.ops import digital as jops
from gnuradio4_tpu_torch.blocks import digital as tdig
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import digital as tops

torch.set_num_threads(2)

SEED = 20261017
FF_RTOL = 1e-5
SCAN_ATOL = 1e-4
KINDS = ("BPSK", "QPSK", "8PSK", "QAM16", "QAM64")


def _data(n):
    rng = np.random.default_rng(SEED)
    return {
        "c": ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              * 0.7).astype(np.complex64),
        "sym64": rng.integers(0, 64, n).astype(np.int32),
        "sym4": rng.integers(-1, 5, n).astype(np.int32),     # clipped ends
        "bits": rng.integers(0, 2, n).astype(np.int32),
    }


def _run(pkg, btype, settings, ins, outs, *, block_len, steps):
    """``ins``: {input port: array}; every output port of ``outs`` goes to a
    VectorSink. Returns {port: data}."""
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(btype, name="dut", **settings)
    g.add(blk)
    for port, arr in ins.items():
        g.connect(reg.create("VectorSource", data=arr, name=f"src_{port}"),
                  blk[port])
    sinks = {p: reg.create("VectorSink", name=f"snk_{p}") for p in outs}
    for p, s in sinks.items():
        g.connect(blk[p], s)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw).run_and_wait(steps)
    return {p: np.asarray(s.data()) for p, s in sinks.items()}


def _close(got, want, rtol=FF_RTOL, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    d = np.abs(got.astype(np.complex128) - want)
    assert np.all(d <= rtol * np.maximum(1.0, np.abs(want))), \
        (what, float(np.max(d)))


def _both(btype, settings, ins, outs, *, block_len, steps):
    want = _run(gr, btype, settings, ins, outs, block_len=block_len, steps=steps)
    got = _run(gt, btype, settings, ins, outs, block_len=block_len, steps=steps)
    return got, want


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_constellations_equal(kind):
    np.testing.assert_array_equal(tops.make_constellation(kind),
                                  jops.make_constellation(kind))


@pytest.mark.parametrize("sps, ntaps, beta", [(4, 45, 0.35), (8, 64, 0.5),
                                              (2, 11, 0.25)])
def test_rrc_taps_equal(sps, ntaps, beta):
    np.testing.assert_array_equal(tops.rrc_taps(sps, ntaps, beta=beta),
                                  jops.rrc_taps(sps, ntaps, beta=beta))


def test_host_tables_equal():
    for fft, n in ((64, 48), (256, 200), (64, 7)):
        np.testing.assert_array_equal(tops.default_occupied(fft, n),
                                      jops.default_occupied(fft, n))
    for fft, cp in ((64, 16), (256, 32)):
        np.testing.assert_array_equal(tdig.schmidl_cox_preamble(fft, cp),
                                      jdig.schmidl_cox_preamble(fft, cp))


def test_mm_timing_recovery_op():
    rng = np.random.default_rng(SEED)
    sps, n_sym = 4, 1024
    syms = tops.make_constellation("QPSK")[rng.integers(0, 4, n_sym)]
    x = (np.repeat(syms, sps) + 0.05 * (rng.standard_normal(n_sym * sps)
         + 1j * rng.standard_normal(n_sym * sps))).astype(np.complex64)
    yj, muj, lj = jops.mm_timing_recovery(
        jnp.asarray(x), sps=sps, mu0=jnp.float32(0.3),
        last_sym=jnp.complex64(0.5 - 0.5j), gain=0.05)
    yt, mut, lt = tops.mm_timing_recovery(
        torch.from_numpy(x), sps=sps, mu0=torch.tensor(0.3),
        last_sym=torch.tensor(0.5 - 0.5j, dtype=torch.complex64), gain=0.05)
    _close(yt.numpy(), np.asarray(yj), rtol=SCAN_ATOL)
    assert abs(float(mut) - float(muj)) <= SCAN_ATOL
    assert abs(complex(lt) - complex(lj)) <= SCAN_ATOL


# -- feed-forward blocks --------------------------------------------------------

N = 3 * 960     # three steps of 960 (a multiple of every alignment below)


def _ff_cases():
    d = _data(N)
    pre = jdig.schmidl_cox_preamble(64, 16)
    sc = d["c"].copy()
    sc[200:280] += 3 * pre
    sc[1500:1580] += 3 * pre
    cases = {}
    for kind in KINDS:
        cases[f"ConstellationMapper_{kind}"] = (
            "ConstellationMapper", {"constellation": kind},
            {"in": d["sym64"] % len(jops.make_constellation(kind))}, ["out"], 960)
        cases[f"ConstellationDemapper_{kind}"] = (
            "ConstellationDemapper", {"constellation": kind}, {"in": d["c"]},
            ["out"], 960)
        cases[f"SoftDemapper_{kind}"] = (
            "SoftDemapper", {"constellation": kind, "noise_var": 0.3},
            {"in": d["c"]}, ["out"], 960)
    cases.update({
        "ConstellationMapper_clip": ("ConstellationMapper", {},
                                     {"in": d["sym4"]}, ["out"], 960),
        "OfdmModulator": ("OfdmModulator", {}, {"in": d["c"]}, ["out"], 960),
        "OfdmDemodulator": ("OfdmDemodulator", {}, {"in": d["c"]}, ["out"], 960),
        "OfdmDemodulator_256": ("OfdmDemodulator", {"fft_size": 256, "cp_len": 32,
                                                    "n_occupied": 200},
                                {"in": d["c"]}, ["out"], 576),
        "RrcFilter": ("RrcFilter", {"sps": 4, "ntaps": 45}, {"in": d["c"]},
                      ["out"], 960),
        "RrcFilter_real": ("RrcFilter", {"sps": 8, "ntaps": 65, "beta": 0.5},
                           {"in": d["c"].real.copy()}, ["out"], 960),
        "SymbolSampler": ("SymbolSampler", {"sps": 4}, {"in": d["c"]}, ["out"], 960),
        "DiffEncoder": ("DiffEncoder", {}, {"in": d["c"] / np.abs(d["c"])},
                        ["out"], 960),
        "DiffDecoder": ("DiffDecoder", {}, {"in": d["c"]}, ["out"], 960),
        "PackBits": ("PackBits", {"k": 4}, {"in": d["bits"]}, ["out"], 960),
        "UnpackBits": ("UnpackBits", {"k": 6}, {"in": d["sym64"]}, ["out"], 960),
        "OfdmPilotInserter": ("OfdmPilotInserter", {}, {"in": d["c"]}, ["out"], 840),
        "OfdmChannelEqualizer_zf": ("OfdmChannelEqualizer", {}, {"in": d["c"] + 2},
                                    ["out"], 960),
        "OfdmChannelEqualizer_mmse": (
            "OfdmChannelEqualizer", {"mode": "mmse", "noise_var": 0.2,
                                     "smoothing": 0.6},
            {"in": d["c"]}, ["out"], 960),
        "OfdmChannelEqualizer_spaced": (
            "OfdmChannelEqualizer", {"n_occupied": 40, "pilot_spacing": 6,
                                     "fft_size": 128, "smoothing": 0.3},
            {"in": d["c"] + 1}, ["out"], 960),
        "PacketFramer": ("PacketFramer", {"payload_bits": 64},
                         {"in": d["bits"]}, ["out"], 960),
        "PacketFramer_512": ("PacketFramer", {"payload_bits": 512},
                             {"in": np.tile(d["bits"], 2)[:3 * 1024]}, ["out"], 1024),
        "OfdmSync": ("OfdmSync", {"fft_size": 64, "cp_len": 16, "threshold": 0.5},
                     {"in": sc}, ["out", "det"], 960),
    })
    return cases


FF = _ff_cases()


@pytest.mark.parametrize("case", sorted(FF))
def test_feed_forward_block_matches_jax(case):
    btype, settings, ins, outs, block_len = FF[case]
    got, want = _both(btype, settings, ins, outs, block_len=block_len, steps=3)
    for port in outs:
        g_, w = got[port], want[port]
        if port == "det" or w.dtype.kind in "iu":
            if port == "det":   # indices exactly, values within FF_RTOL
                np.testing.assert_array_equal(g_[0], w[0])
                _close(g_[1:], w[1:], what=case)
            else:
                np.testing.assert_array_equal(g_, w)
                assert g_.dtype == w.dtype
        else:
            _close(g_, w, what=case)


def test_preamble_correlator_detects_bursts_in_both():
    """The reference scenario (tests/test_digital.py): five preambles in
    noise, one straddling a step seam; detections equal."""
    rng = np.random.default_rng(0)
    n = 65536
    pre = np.exp(1j * np.pi / 4 * (2 * rng.integers(0, 4, 63) + 1)
                 ).astype(np.complex64)
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * 0.15).astype(np.complex64)
    for off in [5000, 8192 - 30, 21777, 40000, 60001]:
        sig[off:off + 63] += pre
    out = {}
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=sig)
        cor = g.emplace("PreambleCorrelator", preamble=pre, threshold=0.6)
        det = g.emplace("DetectionSink")
        snk = g.emplace("VectorSink")
        g.connect(src, cor)
        g.connect(cor["out"], snk["in"])
        g.connect(cor["det"], det["in"])
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=8192, sample_rate=1e6, **kw).run_and_wait()
        out[pkg] = (det.detections, snk.data())
    (dj, sj), (dt, st) = out[gr], out[gt]
    assert [i for i, _ in dt] == [i for i, _ in dj] and len(dt) == 5
    np.testing.assert_allclose([m for _, m in dt], [m for _, m in dj],
                               rtol=FF_RTOL)
    np.testing.assert_array_equal(st, sj)


def test_preamble_correlator_needs_a_preamble():
    with pytest.raises(GrError, match="preamble"):
        gt.Graph().emplace("PreambleCorrelator", preamble=[])


# -- the scans -------------------------------------------------------------------

def _shaped(sps, nsym, seed, tau=0.0):
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    ups = np.zeros(nsym * sps, complex)
    ups[::sps] = syms
    shaped = np.convolve(ups, jops.rrc_taps(sps, 11 * sps + 1, beta=0.35)
                         )[: nsym * sps]
    f = np.fft.fftfreq(len(shaped))
    rx = np.fft.ifft(np.fft.fft(shaped) * np.exp(-2j * np.pi * f * tau))
    rx = rx + 0.02 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))
    return rx.astype(np.complex64)


@pytest.mark.parametrize("btype, settings", [
    ("MMSymbolSync", {"sps": 4, "gain": 0.05}),
    ("PfbClockSync", {"sps": 4, "rolloff": 0.35}),
    ("PfbClockSync", {"sps": 2, "nfilts": 16, "taps_per_arm": 7, "loop_bw": 0.1}),
])
def test_symbol_sync_scans_match_jax(btype, settings):
    """1536 symbols over three steps, the state carried across the seams."""
    sps = settings["sps"]
    x = _shaped(sps, 1536, 5, tau=0.37)
    got, want = _both(btype, settings, {"in": x}, ["out"],
                      block_len=512 * sps, steps=3)
    assert got["out"].shape == want["out"].shape == (1536,)
    _close(got["out"], want["out"], rtol=SCAN_ATOL, what=btype)


# -- bits: PRBS, packing, BER, CRC, packets ---------------------------------------

@pytest.mark.parametrize("order", sorted(jdig._PRBS_TAPS))
def test_prbs_stream_equals_the_lfsr(order):
    """The chunked recurrence gives the reference LFSR's bits across every
    seam of an irregular sequence of takes."""
    src = jdig.PrbsSource(order=order)
    lfsr = tdig.PrbsStream(order)
    for n in (1, 5, order, 3 * order + 1, 4096, 70000, 17):
        np.testing.assert_array_equal(lfsr.take(n).astype(np.int32),
                                      src._gen(n))


@pytest.mark.parametrize("order, n_bits, block_len", [(7, 254, 127),
                                                      (9, 5000, 1024),
                                                      (15, 0, 4096)])
def test_prbs_source_graph_equal(order, n_bits, block_len):
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        g.connect(g.emplace("PrbsSource", order=order, n_bits=n_bits),
                  snk := g.emplace("VectorSink"))
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=block_len, sample_rate=1e6,
                      **kw).run_and_wait(None if n_bits else 3)
        outs.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].dtype == np.int32


def _ber_link(pkg, std):
    g = pkg.Graph()
    src = g.emplace("PrbsSource", order=9, n_bits=16384)
    pk = g.emplace("PackBits", k=2)
    mp = g.emplace("ConstellationMapper", constellation="QPSK")
    dm = g.emplace("ConstellationDemapper", constellation="QPSK")
    up = g.emplace("UnpackBits", k=2)
    ber = g.emplace("BerSink", order=9, sync_window=1024)
    if std:
        ni = g.emplace("NoiseSource", std=std, seed=1, n_samples=8192)
        nq = g.emplace("NoiseSource", std=std, seed=2, n_samples=8192)
        cx = g.emplace("RealImagToComplex")
        ad = g.emplace("Add", n_inputs=2)
        g.connect(ni, cx["real"])
        g.connect(nq, cx["imag"])
        g.connect(mp, ad["in0"])
        g.connect(cx, ad["in1"])
        g.connect_chain(src, pk, mp)
        g.connect_chain(ad, dm, up, ber)
    else:
        g.connect_chain(src, pk, mp, dm, up, ber)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=2048, sample_rate=1e6, **kw).run_and_wait()
    return ber.report()


@pytest.mark.parametrize("std", [0.0, 0.45])
def test_ber_link_reports_equal(std):
    """The clean and the noisy QPSK links (tests/test_digital.py), at 16384
    bits: the BER counts equal."""
    want, got = _ber_link(gr, std), _ber_link(gt, std)
    assert got == want and got["synced"] and got["bits"] == 16384
    assert (got["errors"] == 0) if std == 0.0 else (0.04 < got["ber"] < 0.08)


@pytest.mark.parametrize("lag, invert", [(0, False), (37, False), (300, True)])
def test_ber_sink_sync_lag_and_inversion(lag, invert):
    """A stream entering at a PRBS phase, inverted or not, with a few flipped
    bits, fed in uneven steps: reports equal."""
    bits = jdig.PrbsSource(order=9)._gen(lag + 6000)[lag:]
    if invert:
        bits = 1 - bits
    bits[[100, 2500, 5999]] ^= 1
    reports = []
    for pkg in (gr, gt):
        snk = pkg.global_registry.create("BerSink", order=9, sync_window=512)
        for a, b in ((0, 300), (300, 1700), (1700, 1701), (1701, 6000)):
            snk.consume({"in": bits[a:b]}, {}, b - a, a)
        reports.append((snk.report(), snk._synced))
    assert reports[1] == reports[0]
    assert reports[1][0]["errors"] == 3


@pytest.mark.parametrize("n_bits", [8, 64, 512, 1000])
def test_crc32c_affine_equals_the_bit_loop(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (4, n_bits)).astype(np.int32)
    g, k = tdig._crc32c_affine(n_bits)
    got = (bits.astype(np.int64) @ g.astype(np.int64) + k) & 1
    for row, crc_bits in zip(bits, got):
        want = int(jdig._crc32c_bits_jax(jnp.asarray(row)))
        assert want == jdig._crc32c_bits_np(row)
        assert int("".join(map(str, crc_bits)), 2) == want


PB = 512
FSYMS = 63 + 8 + PB // 2 + 16


def _packet_link(pkg, nframes=6):
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, nframes * PB).astype(np.int32)
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=bits)
    fr = g.emplace("PacketFramer", payload_bits=PB)
    ni = g.emplace("NoiseSource", std=0.05, seed=1, n_samples=nframes * FSYMS)
    nq = g.emplace("NoiseSource", std=0.05, seed=2, n_samples=nframes * FSYMS)
    cx = g.emplace("RealImagToComplex")
    ad = g.emplace("Add", n_inputs=2)
    cor = g.emplace("PreambleCorrelator", preamble=fr.preamble,
                    threshold=0.6, max_detections=32)
    prx = g.emplace("PacketReceiver")
    g.connect(ni, cx["real"])
    g.connect(nq, cx["imag"])
    g.connect_chain(src, fr)
    g.connect(fr, ad["in0"])
    g.connect(cx, ad["in1"])
    g.connect(ad, cor)
    g.connect(cor["out"], prx["in"])
    g.connect(cor["det"], prx["det"])
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=FSYMS * 2, sample_rate=1e6, **kw).run_and_wait()
    return bits, prx.packets


def test_packet_link_packets_equal():
    bits, want = _packet_link(gr)
    _, got = _packet_link(gt)
    assert len(got) == len(want) == 6
    for p, q in zip(got, want):
        assert p["index"] == q["index"] and p["ok"] and q["ok"]
        np.testing.assert_array_equal(p["bits"], q["bits"])
    sent = {bits[i * PB:(i + 1) * PB].tobytes() for i in range(6)}
    assert all(p["bits"].tobytes() in sent for p in got)


def test_packet_receiver_flags_a_bad_crc_as_the_jax_package_does():
    """Frame 1 has a payload symbol rotated, frame 3 a CRC symbol: both
    packages decode every frame and mark exactly those two not ok."""
    rng = np.random.default_rng(11)
    nframes = 5
    bits = rng.integers(0, 2, nframes * PB).astype(np.int32)
    g = gt.Graph()
    snk = g.emplace("VectorSink")
    fr = g.emplace("PacketFramer", payload_bits=PB)
    g.connect_chain(g.emplace("VectorSource", data=bits), fr, snk)
    gt.Scheduler(g, block_len=PB, sample_rate=1e6, device="cpu").run_and_wait()
    syms = snk.data().copy()
    syms[1 * FSYMS + 63 + 8 + 5] *= 1j
    syms[3 * FSYMS + FSYMS - 3] *= -1j
    got = {}
    for pkg in (gr, gt):
        g = pkg.Graph()
        cor = g.emplace("PreambleCorrelator", preamble=fr.preamble,
                        threshold=0.6, max_detections=32)
        prx = g.emplace("PacketReceiver")
        g.connect(g.emplace("VectorSource", data=syms), cor)
        g.connect(cor["out"], prx["in"])
        g.connect(cor["det"], prx["det"])
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=FSYMS * 2, sample_rate=1e6,
                      **kw).run_and_wait()
        got[pkg] = prx.packets
    want = got[gr]
    assert [p["ok"] for p in got[gt]] == [p["ok"] for p in want] == [
        True, False, True, False, True]
    for p, q in zip(got[gt], want):
        assert p["index"] == q["index"]
        np.testing.assert_array_equal(p["bits"], q["bits"])


def test_ofdm_sync_sink_detections_equal():
    """Schmidl & Cox timing and CFO (tests/test_digital.py's scenario)."""
    fft, cp = 256, 32
    pre = jdig.schmidl_cox_preamble(fft, cp)
    rng = np.random.default_rng(1)
    n = 16384
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
           ).astype(np.complex64)
    for o in (3000, 9000):
        sig[o:o + len(pre)] += pre
    sig = (sig * np.exp(2j * np.pi * 0.3 * np.arange(n) / fft)).astype(np.complex64)
    dets = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=sig)
        sync = g.emplace("OfdmSync", fft_size=fft, cp_len=cp, threshold=0.6)
        det = g.emplace("OfdmSyncSink")
        g.connect(src, sync)
        g.connect(sync["out"], g.emplace("NullSink")["in"])
        g.connect(sync["det"], det["in"])
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=4096, sample_rate=1e6, **kw).run_and_wait()
        dets.append(det.detections)
    want, got = dets
    assert [d[0] for d in got] == [d[0] for d in want] and len(got) == 2
    np.testing.assert_allclose([d[1:] for d in got], [d[1:] for d in want],
                               rtol=FF_RTOL, atol=FF_RTOL)
    for (i, m, c), o in zip(got, (3000, 9000)):
        assert o <= i <= o + cp and m > 0.9 and abs(c - 0.3) < 0.02


def test_ofdm_chain_through_awgn():
    """Mapper → OFDM modulator + AWGN → demodulator → demapper: the symbols
    equal in both packages and to those sent (tests/test_digital.py)."""
    n_occ, fft, cp = 48, 64, 16
    syms = np.random.default_rng(3).integers(0, 4, n_occ * 64).astype(np.int32)
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=syms)
        mapper = g.emplace("ConstellationMapper", constellation="QPSK")
        mod = g.emplace("OfdmModulator", fft_size=fft, cp_len=cp, n_occupied=n_occ)
        noise = g.emplace("NoiseSource", noise="complex_gaussian", std=0.05,
                          n_samples=64 * (fft + cp))
        add = g.emplace("Add", n_inputs=2)
        demod = g.emplace("OfdmDemodulator", fft_size=fft, cp_len=cp,
                          n_occupied=n_occ)
        demap = g.emplace("ConstellationDemapper", constellation="QPSK")
        snk = g.emplace("VectorSink")
        g.connect(src, mapper)
        g.connect(mapper, mod)
        g.connect(mod, add["in0"])
        g.connect(noise, add["in1"])
        g.connect_chain(add, demod, demap, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=n_occ * 16, sample_rate=1e6, **kw).run_and_wait()
        outs.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], syms)


# -- the registry ------------------------------------------------------------------

NEW_TYPES = {
    "digital": ("ConstellationMapper", "ConstellationDemapper", "OfdmModulator",
                "RrcFilter", "SymbolSampler", "MMSymbolSync", "OfdmDemodulator",
                "PfbClockSync", "DiffEncoder", "DiffDecoder",
                "PreambleCorrelator", "DetectionSink", "PrbsSource", "PackBits",
                "UnpackBits", "BerSink", "PacketFramer", "PacketReceiver",
                "OfdmSync", "OfdmSyncSink", "OfdmPilotInserter",
                "OfdmChannelEqualizer", "SoftDemapper"),
    "channels": ("ChannelModel", "FadingModel", "SelectiveFadingModel",
                 "PhaseNoise", "IqImbalanceGen"),
    "util_blocks": ("Throttle", "MovingAverage", "DcBlocker", "Threshold",
                    "MuteSwitch", "KeepOneInN", "Repeat", "Integrate",
                    "PeakDetector", "SampleAndHold", "DiffPhasor"),
    "equalizer": ("CmaEqualizer", "LmsDDEqualizer"),
}
ALIASES = ("SoapySource", "SoapySink", "SoapyDualSource", "SoapyQuadSource",
           "SoapyDualSink", "SoapyQuadSink", "RTL2832Source", "BasicFileSource",
           "BasicFileSink", "Real", "Imag", "DegreeToRadians", "RadiansToDegree",
           "fir_filter", "iir_filter", "builtin_multiply", "builtin_counter",
           "BasicFilterProto")


def _spec(blk):
    return {k: (s.kind, s.choices, s.unit, repr(s.default))
            for k, s in blk.settings.spec.items()}


def test_new_types_and_aliases_carry_the_jax_names_and_settings():
    """The 41 block types of the four modules and the 18 aliases whose
    targets the port has: registered in both packages, built into the same
    type with the same settings (kind, choices, unit, default), current
    values, ports, ratio and alignment."""
    names = [n for group in NEW_TYPES.values() for n in group]
    assert len(names) == 41 and len(ALIASES) == 18
    for name in names + list(ALIASES):
        kw = {"preamble": [1, 1j, -1]} if name == "PreambleCorrelator" else {}
        bj = gr.global_registry.create(name, **kw)
        bt = gt.global_registry.create(name, **kw)
        assert type(bt).__name__ == type(bj).__name__, name
        assert _spec(bt) == _spec(bj), name
        assert {k: repr(bt.settings.get(k)) for k in bt.settings.spec} \
            == {k: repr(bj.settings.get(k)) for k in bj.settings.spec}, name
        assert [p.name for p in bt.in_ports] == [p.name for p in bj.in_ports]
        assert [p.name for p in bt.out_ports] == [p.name for p in bj.out_ports]
        assert (bt.ratio, bt.alignment) == (bj.ratio, bj.alignment), name
    for module, group in NEW_TYPES.items():
        mod = __import__(f"gnuradio4_tpu_torch.blocks.{module}",
                         fromlist=["x"])
        for name in group:
            assert gt.global_registry.get(name) is getattr(mod, name)


def test_aliases_apply_their_presets_and_key_map():
    for pkg in (gr, gt):
        b = pkg.global_registry.create("builtin_multiply", factor=3.5)
        assert type(b).__name__ == "MultiplyConst" and b.settings.get("value") == 3.5
        assert pkg.global_registry.create("SoapyQuadSource").settings.get("channels") == 4
        assert pkg.global_registry.create(
            "SoapyDualSource", channels=3).settings.get("channels") == 3


def test_alias_to_a_missing_target_raises():
    from gnuradio4_tpu_torch.blocks import ref_aliases
    with pytest.raises(GrError, match="unknown block type 'NoSuchBlock'"):
        ref_aliases._alias("Nope", "NoSuchBlock")
    assert not gt.global_registry.contains("Nope")


# -- the receiver front half with carrier recovery ----------------------------------

def _impaired_qpsk_link(pkg, rx):
    """The chain FLL → PfbClockSync → Costas; the FLL's, the clock sync's
    and the chain's outputs."""
    g = pkg.Graph()
    reg = pkg.global_registry
    snk, fll_snk, sync_snk = (reg.create("VectorSink") for _ in range(3))
    fll = reg.create("FllBandEdge", samples_per_symbol=4, rolloff=0.35, loop_bw=0.01)
    sync = reg.create("PfbClockSync", sps=4, rolloff=0.35)
    g.connect_chain(reg.create("VectorSource", data=rx), fll, sync,
                    reg.create("CostasLoop", order=4, loop_bw=0.06), snk)
    g.connect(fll, fll_snk)
    g.connect(sync, sync_snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=8192, sample_rate=1e6, **kw).run_and_wait()
    return (np.asarray(fll_snk.data()), np.asarray(sync_snk.data()),
            np.asarray(snk.data()))


def _one_block(pkg, x, block_len, btype, **settings):
    """``btype`` alone over ``x`` (VectorSource → block → VectorSink)."""
    g = pkg.Graph()
    reg = pkg.global_registry
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=x),
                    reg.create(btype, **settings), snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw).run_and_wait()
    return np.asarray(snk.data())


def test_full_receiver_chain_all_impairments():
    """tests/test_digital.py's FLL → PfbClockSync → Costas through CFO 0.03
    rad/sample, a 0.6-sample delay, 15 ppm clock drift and 20 dB SNR, in both
    packages from the same input.

    Stage by stage, on identical inputs: the FLL's outputs (tapped) agree
    within 2e-4·max(1, |y|) per sample, tests/test_torch_dsp_extras.py's
    FLL_ATOL (its phase integrates its float32 rounding: 3.9e-5 measured
    over these 65536 samples); PfbClockSync, fed the JAX package's FLL
    output in both packages, within 1e-3 over the first 1024 symbols (its
    first arm flip comes at symbol 2205); CostasLoop, fed the JAX package's
    clock-sync output in both, within 1e-5 (1.5e-6 measured).

    End to end: both chains recover the symbols (> 99.9%, the JAX test's
    bound) and their decisions agree after the chained outputs first part
    by more than 1e-3. Where that first happens depends on the host's float
    rounding (PfbClockSync picks a discrete polyphase arm, and the FLL's
    small difference moves its first flip: symbol 2080 on one machine, 519
    on another), so it is reported, not bounded."""
    sps, alpha = 4, 0.35
    rng = np.random.default_rng(3)
    nsym = 16384
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym))
                  ).astype(np.complex64)
    ups = np.zeros(nsym * sps, complex)
    ups[::sps] = syms
    shaped = np.convolve(ups, tops.rrc_taps(sps, 11 * sps + 1, beta=alpha))[: nsym * sps]
    fr = np.fft.fftfreq(len(shaped))
    rx = np.fft.ifft(np.fft.fft(shaped) * np.exp(-2j * np.pi * fr * 0.6))
    t = np.arange(len(rx)) * (1.0 + 1.5e-5)
    rx = (np.interp(t, np.arange(len(rx)), rx.real)
          + 1j * np.interp(t, np.arange(len(rx)), rx.imag))
    rx = rx * np.exp(1j * 0.03 * np.arange(len(rx)))
    rx = (rx + (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))
          * np.sqrt(0.005)).astype(np.complex64)
    f, _, y = _impaired_qpsk_link(gt, rx)
    fj, sj, yj = _impaired_qpsk_link(gr, rx)
    assert f.shape == fj.shape == rx.shape and f.dtype == fj.dtype
    np.testing.assert_array_less(np.abs(f - fj), 2e-4 * np.maximum(1.0, np.abs(fj)))
    # the clock sync and the Costas loop, each on the JAX package's input
    sync = {pkg: _one_block(pkg, fj, 8192, "PfbClockSync", sps=4, rolloff=0.35)
            for pkg in (gt, gr)}
    assert sync[gt].shape == sync[gr].shape == sj.shape
    np.testing.assert_array_equal(sync[gr], sj)
    np.testing.assert_allclose(sync[gt][:1024], sj[:1024], rtol=0, atol=1e-3)
    costas = {pkg: _one_block(pkg, sj, 2048, "CostasLoop", order=4,
                              loop_bw=0.06) for pkg in (gt, gr)}
    np.testing.assert_array_equal(costas[gr], yj)
    np.testing.assert_allclose(costas[gt], yj, rtol=0, atol=1e-5)
    assert y.shape == yj.shape and y.dtype == yj.dtype
    apart = np.nonzero(np.abs(y - yj) > 1e-3)[0]
    first = apart[0] if len(apart) else len(y)

    def quad(z):
        return np.round(np.angle(z * np.exp(-1j * np.pi / 4)) / (np.pi / 2)) % 4
    lo = len(y) - 2000
    for got in (y, yj):
        w = got[lo:lo + 1024]
        best = max((abs(np.vdot(syms[k:k + 1024], w)), k)
                   for k in range(lo - 48, lo + 48))
        ref = syms[best[1]:best[1] + 1024]
        rot = np.vdot(ref, w)
        rot /= abs(rot)
        assert np.mean(quad(w * np.conj(rot)) == quad(ref)) > 0.999
    same = quad(y[first:]) == quad(yj[first:])
    assert same.all(), (f"decisions differ at {np.count_nonzero(~same)} of "
                        f"{len(same)} symbols after the chains first part "
                        f"at symbol {first}")
