"""The port's GPS L1 C/A acquisition and tracking (``ops/gnss.py``,
``blocks/gnss.py``) against the JAX package's, on the CPU: every case of
``tests/test_gnss.py`` runs the same seeded input through both packages, and
the JAX test's assertions hold on the port's result; the search surface,
``acquire_all`` and the tracking bank against the JAX package's; the
GnssAcquisition sink keeps its IQ on the graph's device; the entry points
need ``device="cpu"`` where there is no card.

Tolerances: the code tables, the stimulus, detections (PRN, code phase,
Doppler bin) and nav bits are exact. The search surface is float32 FFTs and
products in each package: within 1e-4 of its peak; the metric, a ratio of
two surface values, within 1e-4 relative. Tracking: prompts within 1e-3 of
max|p|, code phase within 1e-3 chip, frequency within 0.5 Hz (float32 loops
that round differently settle to the same lock)."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import gnss as jgnss
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import gnss

torch.set_num_threads(2)

FS = 2.046e6
SURF_RTOL = 1e-4
METRIC_RTOL = 1e-4
PROMPT_RTOL = 1e-3
CHIP_ATOL = 1e-3
FREQ_ATOL = 0.5
NAV1 = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int8)
NAV2 = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int8)
CPU = {"device": "cpu"}


def _same_detection(a, b):
    """One acquisition result of each package: exact but for the metric."""
    if b is None:
        assert a is None
        return
    assert a is not None and sorted(a) == sorted(b)
    assert (a["prn"], a["code_phase"], a["doppler"]) == \
        (b["prn"], b["code_phase"], b["doppler"])
    assert type(a["code_phase"]) is int and type(a["doppler"]) is float
    assert abs(a["metric"] - b["metric"]) <= METRIC_RTOL * b["metric"]


def _acquire(sig, prn, **kw):
    r = gnss.acquire(sig, prn, fs=FS, **kw, **CPU)
    _same_detection(r, jgnss.acquire(sig, prn, fs=FS, **kw))
    return r


def _same_track(a, b):
    assert sorted(a) == sorted(b)
    if "prn" in b:
        assert a["prn"] == b["prn"]
    np.testing.assert_array_equal(a["bits"], b["bits"])
    assert a["bit_boundary"] == b["bit_boundary"]
    p, q = a["prompts"], b["prompts"]
    assert p.dtype == q.dtype == np.complex64 and p.shape == q.shape
    assert np.max(np.abs(p - q)) <= PROMPT_RTOL * np.max(np.abs(q))
    d = np.abs(a["code_chips"] - b["code_chips"])
    assert np.max(np.minimum(d, gnss.CODE_LEN - d)) <= CHIP_ATOL
    assert np.max(np.abs(a["doppler"] - b["doppler"])) <= FREQ_ATOL


def _bits_match_cycle(bits, nav):
    # recovered bits = (1 − nav) up to cycle offset and polarity
    exp = np.tile(nav, 30)
    for off in range(len(nav)):
        for pol in (0, 1):
            if np.array_equal(exp[off:off + len(bits)] ^ pol, 1 - bits):
                return True
    return False


# -- host tables and the stimulus: exact ---------------------------------------------

def test_codes_and_stimulus_equal():
    for prn in range(1, 33):
        np.testing.assert_array_equal(gnss.ca_code(prn), jgnss.ca_code(prn))
        assert gnss.ca_code_first_octal(prn) == jgnss.ca_code_first_octal(prn)
    np.testing.assert_array_equal(gnss.sampled_code(5, 4.092e6, 9000),
                                  jgnss.sampled_code(5, 4.092e6, 9000))
    sats = [(7, 1800.0, 300, NAV1), (22, -3250.0, 1501)]
    for kw in ({}, {"noise_std": 1.0, "rng": np.random.default_rng(3)}):
        a = gnss.synthesize(sats, fs=FS, n_ms=25, **kw)
        kw = {**kw, "rng": np.random.default_rng(3)} if kw else kw
        np.testing.assert_array_equal(a, jgnss.synthesize(sats, fs=FS, n_ms=25, **kw))
    with pytest.raises(ValueError):
        gnss.ca_code(33)


@pytest.mark.parametrize("dmax, dstep", [(5000.0, 250.0), (5000.0, 333.3),
                                         (2000.0, 125.0)])
def test_doppler_grid_equal(dmax, dstep):
    import jax.numpy as jnp
    want = np.asarray(jnp.arange(-dmax, dmax + dstep / 2, dstep, dtype=jnp.float32))
    got = gnss.doppler_grid(dmax, dstep)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_coherent", [1, 2, 4])
def test_search_surface_equal(n_coherent):
    import jax.numpy as jnp
    sig = gnss.synthesize([(7, 1800.0, 300), (22, -3250.0, 1501)], fs=FS,
                          n_ms=4, noise_std=2.0, rng=np.random.default_rng(1))
    code = gnss.sampled_code(7, FS, 2046)
    dop = gnss.doppler_grid(5000.0, 250.0)
    want = np.asarray(jgnss.acquire_metric(jnp.asarray(sig), jnp.asarray(code),
                                           jnp.asarray(dop), fs=FS,
                                           n_coherent=n_coherent))
    got = gnss.acquire_metric(torch.from_numpy(sig), torch.from_numpy(code),
                              torch.from_numpy(dop), fs=FS,
                              n_coherent=n_coherent).numpy()
    assert got.shape == want.shape == (41, 2046) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= SURF_RTOL * want.max()
    # the batched form: [P, D, N], each PRN's surface as the single search's
    codes = np.stack([gnss.sampled_code(p, FS, 2046) for p in (7, 22, 3)])
    batch = gnss.acquire_metric(torch.from_numpy(sig), torch.from_numpy(codes),
                                torch.from_numpy(dop), fs=FS,
                                n_coherent=n_coherent).numpy()
    assert batch.shape == (3, 41, 2046)
    assert np.max(np.abs(batch[0] - got)) <= SURF_RTOL * got.max()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_acquire_all_equal(seed):
    sig = gnss.synthesize([(7, 1800.0, 300), (22, -3250.0, 1501),
                           (31, 4100.0, 888)], fs=FS, n_ms=4, noise_std=2.0,
                          rng=np.random.default_rng(seed))
    got = gnss.acquire_all(sig, fs=FS, **CPU)
    want = jgnss.acquire_all(sig, fs=FS)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_detection(a, b)
    # each PRN as the single-PRN search finds it
    for a in got:
        _same_detection(gnss.acquire(sig, a["prn"], fs=FS, **CPU), a)


def test_acquire_all_peak_wraps_the_code_phase():
    """A code phase within one chip of 0: the second peak is sought outside
    ±1 chip circularly, on the device as the JAX package does on the host."""
    sig = gnss.synthesize([(9, 750.0, 1), (14, -1250.0, 2045)], fs=FS, n_ms=4,
                          noise_std=1.0, rng=np.random.default_rng(7))
    got = gnss.acquire_all(sig, fs=FS, prns=(9, 14, 20), **CPU)
    want = jgnss.acquire_all(sig, fs=FS, prns=(9, 14, 20))
    assert [d["code_phase"] for d in got] == [1, 2045]
    for a, b in zip(got, want):
        _same_detection(a, b)


def test_acquire_all_with_a_mesh_raises():
    """A mesh splits the PRN axis over its devices (tests/test_torch_parallel.py
    holds it to the plain search); one that is not a Mesh, or a mesh beside a
    device, raises."""
    from gnuradio4_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(GrError, match="a mesh"):
        gnss.acquire_all(np.zeros(4092, np.complex64), fs=FS, mesh=object())
    mesh = make_mesh((2,), ("ep",), devices=["cpu", "cpu"])
    with pytest.raises(GrError, match="not both"):
        gnss.acquire_all(np.zeros(4092, np.complex64), fs=FS, mesh=mesh, **CPU)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    sig = np.zeros(4092, np.complex64)
    for fn in (lambda: gnss.acquire(sig, 1, fs=FS),
               lambda: gnss.acquire_all(sig, fs=FS),
               lambda: gnss.track(sig, 1, fs=FS, code_phase=0, doppler=0.0),
               lambda: gnss.track_channels(
                   sig, [{"prn": 1, "code_phase": 0, "doppler": 0.0}], fs=FS)):
        with pytest.raises(GrError, match='device="cpu"'):
            fn()


# -- tests/test_gnss.py on both packages ---------------------------------------------

class TestCaCodes:
    def test_published_octal_check_values(self):
        known = {1: 0o1440, 2: 0o1620, 3: 0o1710, 4: 0o1744, 5: 0o1133,
                 19: 0o1633}
        for prn, want in known.items():
            assert gnss.ca_code_first_octal(prn) == jgnss.ca_code_first_octal(prn) == want

    def test_gold_code_properties(self):
        for prn in (1, 9, 17, 32):
            chips = gnss.ca_code(prn)
            np.testing.assert_array_equal(chips, jgnss.ca_code(prn))
            assert np.sum(chips < 0) == 512 and np.sum(chips > 0) == 511
        c = gnss.ca_code(5)
        ac = np.array([np.dot(c, np.roll(c, k)) for k in range(1023)])
        assert ac[0] == 1023
        assert set(np.unique(np.round(ac[1:]))) <= {-65.0, -1.0, 63.0}
        c2 = gnss.ca_code(6)
        cc = np.array([np.dot(c, np.roll(c2, k)) for k in range(1023)])
        assert set(np.unique(np.round(cc))) <= {-65.0, -1.0, 63.0}

    def test_all_prns_distinct(self):
        codes = {prn: tuple(gnss.ca_code(prn)) for prn in range(1, 33)}
        assert len(set(codes.values())) == 32
        assert all(codes[p] == tuple(jgnss.ca_code(p)) for p in codes)


class TestAcquisition:
    def test_two_satellites_acquired_exactly(self):
        sig = gnss.synthesize([(7, 1800.0, 300), (22, -3250.0, 1501)],
                              fs=FS, n_ms=4, noise_std=2.0,
                              rng=np.random.default_rng(1))
        r7, r22 = _acquire(sig, 7), _acquire(sig, 22)
        assert r7 is not None and r7["code_phase"] == 300
        assert abs(r7["doppler"] - 1800.0) <= 250.0
        assert r22 is not None and r22["code_phase"] == 1501
        assert abs(r22["doppler"] - (-3250.0)) <= 250.0

    def test_absent_prn_rejected(self):
        sig = gnss.synthesize([(7, 1800.0, 300)], fs=FS, n_ms=4,
                              noise_std=2.0, rng=np.random.default_rng(2))
        assert _acquire(sig, 13) is None

    def test_weak_signal_with_noncoherent_gain(self):
        sig = gnss.synthesize([(3, 900.0, 777)], fs=FS, n_ms=8,
                              amplitude=0.5, noise_std=2.0,
                              rng=np.random.default_rng(3))
        strong = _acquire(sig, 3, n_coherent=8)
        assert strong is not None and strong["code_phase"] == 777


def _acq_graph(pkg, sig, block_len, **settings):
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=sig)
    acq = g.emplace("GnssAcquisition", **settings)
    g.connect(src, acq)
    kw = CPU if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=FS, **kw).run_and_wait()
    return acq


class TestGnssBlock:
    def test_graph_acquisition_sink(self):
        sig = gnss.synthesize([(11, 2400.0, 42), (29, -1000.0, 1999)],
                              fs=FS, n_ms=6, noise_std=1.5,
                              rng=np.random.default_rng(4))
        kw = dict(prns=(11, 29, 31), sample_rate_in=FS, n_coherent=4)
        acq = _acq_graph(gt, sig, 4092, **kw)
        want = _acq_graph(gr, sig, 4092, **kw).detections
        assert len(acq.detections) == len(want)
        for a, b in zip(acq.detections, want):
            _same_detection(a, b)
        found = {d["prn"]: d for d in acq.detections}
        assert set(found) == {11, 29}
        assert found[11]["code_phase"] == 42
        assert found[29]["code_phase"] == 1999


class TestTracking:
    def test_single_channel_converges_and_recovers_bits(self):
        sig = gnss.synthesize([(7, 1800.0, 300, NAV1)], fs=FS, n_ms=170,
                              noise_std=1.0, rng=np.random.default_rng(1))
        acq = _acquire(sig, 7)
        tr = gnss.track(sig, 7, fs=FS, code_phase=acq["code_phase"],
                        doppler=acq["doppler"], **CPU)
        _same_track(tr, jgnss.track(sig, 7, fs=FS, code_phase=acq["code_phase"],
                                    doppler=acq["doppler"]))
        assert abs(np.mean(tr["doppler"][-10:]) - 1800.0) < 2.0
        assert len(tr["bits"]) >= 5
        assert _bits_match_cycle(tr["bits"], NAV1)

    def test_vmapped_channel_bank(self):
        sig = gnss.synthesize(
            [(7, 1800.0, 300, NAV1), (22, -3250.0, 1501, NAV2)],
            fs=FS, n_ms=170, noise_std=1.0, rng=np.random.default_rng(1))
        acqs = [_acquire(sig, p) for p in (7, 22)]
        chans = gnss.track_channels(sig, acqs, fs=FS, **CPU)
        for a, b in zip(chans, jgnss.track_channels(sig, acqs, fs=FS)):
            _same_track(a, b)
        assert [c["prn"] for c in chans] == [7, 22]
        assert abs(np.mean(chans[0]["doppler"][-10:]) - 1800.0) < 2.0
        assert abs(np.mean(chans[1]["doppler"][-10:]) + 3250.0) < 2.0
        assert _bits_match_cycle(chans[0]["bits"], NAV1)
        assert _bits_match_cycle(chans[1]["bits"], NAV2)

    def test_costas_survives_data_flips(self):
        sig = gnss.synthesize([(3, 500.0, 100, NAV1)], fs=FS, n_ms=120,
                              noise_std=0.0)
        tr = gnss.track(sig, 3, fs=FS, code_phase=100, doppler=400.0, **CPU)
        _same_track(tr, jgnss.track(sig, 3, fs=FS, code_phase=100, doppler=400.0))
        mags = np.abs(tr["prompts"][40:])
        assert mags.min() > 0.9 * mags.max()


class TestSkySearch:
    def test_acquire_all_sharded_equals_unsharded(self):
        """The JAX package's PRN axis sharded over its mesh equals its plain
        search; the port's search (no mesh) equals both."""
        import jax
        from gnuradio4_tpu.parallel.mesh import make_mesh
        sig = gnss.synthesize(
            [(7, 1800.0, 300), (22, -3250.0, 1501), (31, 4100.0, 888)],
            fs=FS, n_ms=4, noise_std=2.0, rng=np.random.default_rng(1))
        mesh = make_mesh((len(jax.devices()),), axes=("ep",))
        sharded = jgnss.acquire_all(sig, fs=FS, mesh=mesh)
        got = gnss.acquire_all(sig, fs=FS, **CPU)
        assert [(d["prn"], d["code_phase"]) for d in got] == \
            [(7, 300), (22, 1501), (31, 888)]
        for a, b in zip(got, sharded):
            _same_detection(a, b)


class TestShortBuffer:
    def test_sub_millisecond_stream_does_not_crash(self):
        kw = dict(prns=(1,), sample_rate_in=FS)
        data = np.zeros(1024, np.complex64)                 # < 1 ms at 2.046M
        assert _acq_graph(gt, data, 512, **kw).detections == []
        assert _acq_graph(gr, data, 512, **kw).detections == []


# -- the port's own ------------------------------------------------------------------

def test_tracking_bank_of_six_equal():
    """Six satellites with nav bits over 300 ms (chip_smoke.py phase 27(b)'s
    input at a CPU size): the bank's bits, prompts, code phases and
    frequencies against the JAX package's vmapped scan."""
    sats = [(3, -3750.0, 100, NAV1), (7, 1800.0, 300, NAV2),
            (11, 2400.0, 42, NAV1), (22, -3250.0, 1501, NAV2),
            (29, -1000.0, 1999, NAV1), (31, 4250.0, 777, NAV2)]
    sig = gnss.synthesize(sats, fs=FS, n_ms=300, noise_std=1.0,
                          rng=np.random.default_rng(27))
    acqs = gnss.acquire_all(sig[:4 * 2046], fs=FS, **CPU)
    assert [a["prn"] for a in acqs] == [3, 7, 11, 22, 29, 31]
    chans = gnss.track_channels(sig, acqs, fs=FS, **CPU)
    for a, b, sat in zip(chans, jgnss.track_channels(sig, acqs, fs=FS), sats):
        _same_track(a, b)
        assert _bits_match_cycle(a["bits"], sat[3])


def test_block_keeps_the_iq_on_the_graph_device():
    """GnssAcquisition receives tensors (no copy to the host) and searches
    them where they lie."""
    from gnuradio4_tpu_torch.blocks.gnss import GnssAcquisition
    assert GnssAcquisition.WANTS_HOST_DATA is False
    seen = []

    class Spy(GnssAcquisition):
        def consume(self, arrays, tags, n_valid, abs_index):
            seen.append(type(arrays["in"]))
            super().consume(arrays, tags, n_valid, abs_index)

    sig = gnss.synthesize([(11, 2400.0, 42)], fs=FS, n_ms=2, noise_std=0.5,
                          rng=np.random.default_rng(5))
    g = gt.Graph()
    acq = Spy(prns=(11, 12), sample_rate_in=FS)
    g.connect(g.emplace("VectorSource", data=sig), acq)
    gt.Scheduler(g, block_len=1023, sample_rate=FS, **CPU).run_and_wait()
    assert seen and all(t is torch.Tensor for t in seen)
    assert [(d["prn"], d["code_phase"]) for d in acq.detections] == [(11, 42)]
