"""The port's ``blocks/misc.py`` (the nine types beside the Expression blocks),
``ops/estimators.py``, ``ops/savgol.py`` and ``ops/svd.py`` against the JAX
package's, on the CPU: the cases of ``tests/test_misc_blocks.py`` and
``tests/test_frequency_estimator_golden.py``, run through both packages from
the same seeded NumPy inputs; the registry names and settings of every type
this slice added; and the port's alias set against the JAX package's.

Tolerances:
- ``schmitt_device``, the gates (SchmittTrigger, StreamFilter, SyncBlock),
  ClockSource's tags, the ramps of FunctionGenerator (its ``t`` is computed
  as XLA computes it) and its uniform and triangular noise: bit for bit;
- ``F32_ATOL`` = 1e-5 · max(1, |y|) for the other float32 blocks (the
  Gaussian noise's ``erfinv``, the FFTs, the S-G FIR); the tones add their
  amplitude times one ulp of their float32 phase (``tone_atol``: XLA's and
  torch's sine reduce a large argument differently; 6.1e-5 measured at
  θ ≈ 1395 rad, where the ulp is 1.2e-4);
- ``SVD_ATOL`` = 1e-4 of the signal's peak for the SVD reconstructions: the
  two SVD libraries and the Jacobi sweeps' summation orders differ in the
  last bits of each singular vector.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import estimators as jest
from gnuradio4_tpu.ops import svd as jsvd
from gnuradio4_tpu_torch.ops import estimators as test_
from gnuradio4_tpu_torch.ops import svd as tsvd

torch.set_num_threads(2)

SEED = 20261018
F32_ATOL = 1e-5
SVD_ATOL = 1e-4


def tone_atol(amplitude, theta_max):
    """A tone's float32 phase θ = 2πf·t + φ reaches ``theta_max``; the two
    sines' argument reductions may differ by one ulp of θ, which moves the
    output by up to the amplitude times that ulp, on top of ``F32_ATOL``."""
    return F32_ATOL + abs(amplitude) * float(np.spacing(np.float32(theta_max)))


NEW_TYPES = {
    "misc": ("FunctionGenerator", "ClockSource", "SchmittTrigger",
             "FrequencyEstimator", "SavitzkyGolayFilter", "SvdDenoiser",
             "BurstTaper", "StreamFilter", "SyncBlock"),
    "acquisition": ("StreamToDataSet", "SyncSink", "StreamFilterSink",
                    "TriggerGate", "DataSetSink", "SavitzkyGolayDataSetFilter"),
    "uncertain": ("ToUncertain", "FromUncertain"),
    "electrical": ("PowerMetrics", "PowerFactor", "SystemUnbalance"),
}
NEW_ALIASES = ("SinglePhasePowerMetrics", "ThreePhasePowerMetrics",
               "SinglePhasePowerFactorCalculator",
               "ThreePhasePowerFactorCalculator",
               "TwoPhaseSystemUnbalanceCalculator",
               "ThreePhaseSystemUnbalanceCalculator",
               "FrequencyEstimatorTimeDomain",
               "FrequencyEstimatorTimeDomainDecimating",
               "FrequencyEstimatorFrequencyDomain",
               "FrequencyEstimatorFrequencyDomainDecimating",
               "SchmittTriggerBasic", "SchmittTriggerNoInterpolation",
               "SchmittTriggerPolynomial")


def _tag(pkg, index, name, **extra):
    return import_module(pkg.__name__ + ".core.tags").Tag(
        index, {"trigger_name": name, **extra})


def _run(pkg, btype, settings, x=None, *, block_len, fs=1.0, tags=(),
         n_steps=None, out_port=None):
    """[VectorSource(x, tags) →] btype → VectorSink; returns (sink data, sink
    tags as (index, map) pairs, the block's final state)."""
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(btype, **settings)
    snk = reg.create("VectorSink")
    if x is None:
        g.connect(blk if out_port is None else blk[out_port], snk)
    else:
        src = reg.create("VectorSource", data=x,
                         tags=[_tag(pkg, i, n) for i, n in tags])
        g.connect_chain(src, blk, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw)
    s.run_and_wait(n_steps)
    return (np.asarray(snk.data()), [(t.index, dict(t.map)) for t in snk.tags],
            s._states.get(blk.unique_name))


def _both(btype, settings, x=None, **kw):
    return (_run(gt, btype, settings, x, **kw)[0],
            _run(gr, btype, settings, x, **kw)[0])


def _close(yt, yj, atol=F32_ATOL):
    assert yt.shape == yj.shape and yt.dtype == yj.dtype
    d = np.abs(yt.astype(np.complex128) - yj)
    assert np.all(d <= atol * np.maximum(1.0, np.abs(yj))), float(d.max())


# -- registry ---------------------------------------------------------------------

def _spec(blk):
    return {k: (s.kind, s.choices, s.unit, repr(s.default))
            for k, s in blk.settings.spec.items()}


def test_new_types_and_aliases_carry_the_jax_names_and_settings():
    """The 20 block types and 13 aliases of this slice: registered in both
    packages, built into the same type with the same settings (kind, choices,
    unit, default), current values, ports, ratio and alignment."""
    names = [n for group in NEW_TYPES.values() for n in group]
    assert len(names) == 20 and len(NEW_ALIASES) == 13
    for name in names + list(NEW_ALIASES):
        bj = gr.global_registry.create(name)
        bt = gt.global_registry.create(name)
        assert type(bt).__name__ == type(bj).__name__, name
        assert _spec(bt) == _spec(bj), name
        assert {k: repr(bt.settings.get(k)) for k in bt.settings.spec} \
            == {k: repr(bj.settings.get(k)) for k in bj.settings.spec}, name
        assert [p.name for p in bt.in_ports] == [p.name for p in bj.in_ports]
        assert [p.name for p in bt.out_ports] == [p.name for p in bj.out_ports]
        assert (bt.ratio, bt.alignment) == (bj.ratio, bj.alignment), name
        for flag in ("WANTS_TAG_ARRAYS", "HOST_TAP", "EMITS_HOST_TAGS",
                     "PER_PORT_VALID", "FEED"):
            assert getattr(bt, flag, False) == getattr(bj, flag, False), \
                (name, flag)
    for module, group in NEW_TYPES.items():
        mod = import_module(f"gnuradio4_tpu_torch.blocks.{module}")
        for name in group:
            assert gt.global_registry.get(name) is getattr(mod, name)
    for name, kw in (("SchmittTriggerNoInterpolation", "none"),
                     ("SchmittTriggerPolynomial", "polynomial")):
        assert gt.global_registry.create(name).settings.get(
            "interpolation") == kw
    assert gt.global_registry.create(
        "FrequencyEstimatorTimeDomain").settings.get("method") == "zero_crossing"


def test_alias_set_equals_the_jax_packages():
    """Every alias of the JAX package's ``blocks/ref_aliases.py`` is in the
    port's, and no other: read from both modules' registrations."""
    import re
    from gnuradio4_tpu.blocks import ref_aliases as jal
    from gnuradio4_tpu_torch.blocks import ref_aliases as tal

    def aliases(mod):
        src = open(mod.__file__).read()
        return set(re.findall(r'^_alias(?:_map)?\("(\w+)"', src, re.M))
    assert aliases(tal) == aliases(jal)
    assert set(NEW_ALIASES) <= aliases(tal)
    for name in aliases(jal):
        assert gt.global_registry.contains(name), name


def test_slice_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys, gnuradio4_tpu_torch.blocks.acquisition, "
            "gnuradio4_tpu_torch.blocks.electrical, "
            "gnuradio4_tpu_torch.blocks.uncertain, "
            "gnuradio4_tpu_torch.ops.svd, gnuradio4_tpu_torch.ops.dataset_math, "
            "gnuradio4_tpu_torch.core.stream_capture, "
            "gnuradio4_tpu_torch.core.sync_engine; "
            "assert 'jax' not in sys.modules and 'gnuradio4_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


# -- FunctionGenerator -------------------------------------------------------------

FG_CASES = {
    "Const": dict(start_value=2.0, final_value=5.0, duration=1.0),
    "LinearRamp": dict(start_value=2.0, final_value=5.0, duration=1.0),
    "CubicSpline": dict(start_value=2.0, final_value=5.0, duration=1.0),
    "ParabolicRamp": dict(start_value=0.0, final_value=1.0, duration=1.0,
                          round_off_time=0.2),
    "ImpulseResponse": dict(start_value=1.0, final_value=7.0,
                            impulse_time0=0.2, impulse_time1=0.3),
    "Sin": dict(start_value=2.0, final_value=0.5, frequency=50.0, duration=0.5),
    "Cos": dict(start_value=-1.0, final_value=0.7, frequency=13.0, phase=0.4,
                duration=0.0),
    "FastSin": dict(start_value=0.0, final_value=1.0, frequency=111.0),
    "FastCos": dict(start_value=0.0, final_value=1.0, frequency=77.0),
    "UniformNoise": dict(start_value=2.0, seed=1),
    "TriangularNoise": dict(start_value=2.0, seed=1),
    "GaussianNoise": dict(start_value=2.0, seed=1),
}
FG_EXACT = ("Const", "LinearRamp", "CubicSpline", "ParabolicRamp",
            "ImpulseResponse", "UniformNoise", "TriangularNoise")


@pytest.mark.parametrize("mode", sorted(FG_CASES))
def test_function_generator_modes(mode):
    """Every mode over 2000 samples in steps of 500 at 1 kHz (the ramps pass
    their end, the tone its expiry): the ramps and the uniform and
    triangular noise bit for bit, tones and Gaussian noise within
    ``F32_ATOL``; the JAX test's own checks on the port's output."""
    settings = dict(signal_type=mode, n_samples=2000, sample_rate=1000.0,
                    **FG_CASES[mode])
    yt, yj = _both("FunctionGenerator", settings, block_len=500, fs=1000.0)
    assert yt.shape == (2000,) and yt.dtype == np.float32
    if mode in FG_EXACT:
        np.testing.assert_array_equal(yt, yj)
    elif mode == "GaussianNoise":
        _close(yt, yj)
    else:
        c = FG_CASES[mode]
        theta = 2 * np.pi * c["frequency"] * 2.0 + c.get("phase", 0.0)
        d = np.abs(yt - yj)
        assert np.all(d <= tone_atol(c["final_value"], theta)), float(d.max())
    t = np.arange(2000) / 1000.0
    if mode == "LinearRamp":
        np.testing.assert_allclose(yt, 2.0 + 3.0 * np.minimum(t, 1.0), atol=1e-4)
    elif mode == "ImpulseResponse":
        np.testing.assert_allclose(yt, np.where((t < 0.2) | (t > 0.5), 1.0, 7.0))
    elif mode == "Sin":
        live = t <= 0.5
        np.testing.assert_allclose(
            yt[live], 0.5 * np.sin(2 * np.pi * 50.0 * t[live]) + 2.0, atol=1e-4)
        np.testing.assert_allclose(yt[t > 0.5], 2.0)
    elif mode == "UniformNoise":
        assert np.all(np.abs(yt) <= 2.0) and abs(yt.var() - 4.0 / 3.0) < 0.2


def test_function_generator_state_is_a_uint32_counter_and_restarts():
    """The segment counter advances by n per step in both packages, and a
    settings change restarts the segment (the JAX test's pump sequence)."""
    out = []
    for pkg in (gt, gr):
        reg = pkg.global_registry
        g = pkg.Graph()
        fg = reg.create("FunctionGenerator", signal_type="LinearRamp",
                        start_value=0.0, final_value=1.0, duration=0.5,
                        sample_rate=1000.0)
        snk = reg.create("VectorSink")
        g.connect_chain(fg, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = pkg.Scheduler(g, block_len=250, sample_rate=1000.0, **kw)
        s.init()
        s._pump_once()
        s._pump_once()
        assert int(np.asarray(s._states[fg.unique_name])) == 500
        fg.settings.set({"start_value": 10.0, "final_value": 20.0})
        s._pump_once()
        s._pump_once()
        s.request_stop()
        s._drain()
        out.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(out[0], out[1])
    y = out[0]
    assert abs(y[499] - 1.0) < 0.01 and abs(y[500] - 10.0) < 0.1 \
        and abs(y[999] - 20.0) < 0.1


# -- ClockSource and SchmittTrigger -------------------------------------------------

def test_clock_source_tags_at_scheduled_times():
    res = []
    for pkg in (gt, gr):
        Keys = import_module(pkg.__name__ + ".core.tags").Keys
        misc = import_module(pkg.__name__ + ".blocks.misc")
        g = pkg.Graph()
        cs = misc.ClockSource(sample_rate=1000.0, n_samples=1000,
                              tag_times=[0.1, 0.25, 0.9],
                              tag_values=[{Keys.TRIGGER_NAME: "a"},
                                          {Keys.TRIGGER_NAME: "b"},
                                          {Keys.TRIGGER_NAME: "c"}])
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(cs, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=256, sample_rate=1000.0, **kw).run_and_wait()
        res.append(([(t.index, dict(t.map)) for t in snk.tags],
                    np.asarray(snk.data())))
    assert res[0][0] == res[1][0]
    np.testing.assert_array_equal(res[0][1], res[1][1])
    assert {m["trigger_name"]: i for i, m in res[0][0]
            if "trigger_name" in m} == {"a": 100, "b": 250, "c": 900}


@pytest.mark.parametrize("shape", [(4099,), (3, 1000)])
@pytest.mark.parametrize("band", [(-0.3, 0.3), (0.2, 0.2), (0.5, -0.5)])
def test_schmitt_device_bit_for_bit(shape, band):
    """The running-maximum form against the JAX package's associative scan,
    on noisy sines with a carried state of each value: a band, an empty
    band (low == high) and an inverted one (both thresholds hold)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED)
    x = (np.sin(np.linspace(0, 40, shape[-1])) * np.ones(shape)
         + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    x[..., 7] = band[0]
    x[..., 11] = band[1]
    for carry in (False, True):
        init = np.full(shape[:-1], carry)
        sj, cj = jest.schmitt_device(jnp.asarray(x), jnp.asarray(init),
                                     low=band[0], high=band[1])
        st, ct = test_.schmitt_device(torch.from_numpy(x), torch.from_numpy(init),
                                      low=band[0], high=band[1])
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("output", ["gate", "pass"])
def test_schmitt_trigger_block(output):
    """tests/test_misc_blocks.py's noisy 5 Hz sine through SchmittTrigger in
    steps of 500: the gate bit for bit, one flip per host edge."""
    rng = np.random.default_rng(0xC0FFEE)
    x = (np.sin(2 * np.pi * 5 * np.arange(2000) / 1000.0)
         + 0.05 * rng.standard_normal(2000)).astype(np.float32)
    settings = dict(low=-0.3, high=0.3, output=output)
    (yt, _, st), (yj, _, sj) = (_run(p, "SchmittTrigger", settings, x,
                                     block_len=500) for p in (gt, gr))
    np.testing.assert_array_equal(yt, yj)
    assert bool(st) == bool(np.asarray(sj))
    if output == "gate":
        edges, _ = test_.schmitt_edges(x, low=-0.3, high=0.3)
        assert np.sum(yt[1:] != yt[:-1]) == len(edges) and 18 <= len(edges) <= 22


@pytest.mark.parametrize("method", ["none", "basic_linear", "regression",
                                    "polynomial"])
@pytest.mark.parametrize("kind", ["walk", "sine", "levels", "steps"])
def test_schmitt_edges_host_equal(method, kind):
    """The port's array form of the host edge detector against the JAX
    package's sample loop: random walks, noisy sines, signals that sit on
    the thresholds and quantised steps, cut into random chunks (the zone and
    the bracketing sample carried across the seams), 25 cases each, with
    bands of either order (low ≥ high takes the loop): equal edges and
    state."""
    rng = np.random.default_rng(SEED + len(method) + 7 * len(kind))
    for _ in range(25):
        n = int(rng.integers(1, 400))
        x = {"walk": lambda: np.cumsum(rng.standard_normal(n)) * 0.3,
             "sine": lambda: np.sin(np.linspace(0, rng.uniform(1, 40), n))
             + 0.1 * rng.standard_normal(n),
             "levels": lambda: rng.choice([-1.0, -0.2, 0.0, 0.2, 1.0], n),
             "steps": lambda: np.round(np.sin(np.linspace(0, 20, n)) * 4) / 4}[kind]()
        low, high = sorted(rng.choice([-0.5, -0.2, 0.0, 0.2, 0.5], 2,
                                      replace=False))
        if rng.random() < 0.1:
            low, high = high, low
        cuts = sorted(set(rng.integers(0, n, size=3).tolist()) | {0, n})
        sj = st = None
        for a, b in zip(cuts[:-1], cuts[1:]):
            ej, sj = jest.schmitt_edges(x[a:b], low=low, high=high, state=sj,
                                        method=method)
            et, st = test_.schmitt_edges(x[a:b], low=low, high=high, state=st,
                                         method=method)
            assert et == ej
            assert (st.above, st.last) == (sj.above, sj.last)
            np.testing.assert_array_equal(np.asarray(st.zone), np.asarray(sj.zone))
            if sj.zone:      # an empty zone's start is never read
                assert st.zone_start == sj.zone_start


# -- FrequencyEstimator ------------------------------------------------------------

def _tone(f0, n, fs, cplx=False, noise=0.0, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if cplx:
        x = np.exp(2j * np.pi * f0 * t / fs)
        x += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        return x.astype(np.complex64)
    return (np.sin(2 * np.pi * f0 * t / fs)
            + noise * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("method, f0, cplx, tol", [
    ("fft", 1234.0, False, 0.5), ("zero_crossing", 1234.0, False, 2.0),
    ("period", 1234.0, False, 2.0), ("fft", 1234.0, True, 0.5),
    ("fft", -1234.0, True, 0.5), ("fft", 3777.5, True, 0.5),
    ("zero_crossing", 250.0, True, None), ("zero_crossing", -1875.25, True, None),
    ("period", -1875.25, True, None),
])
def test_frequency_estimator_methods(method, f0, cplx, tol):
    """The three methods on real and complex tones (tests/test_misc_blocks.py's
    cases), 8 chunks of 1024 at 10 kHz: within ``F32_ATOL``; the JAX test's
    accuracy bound held on the port's estimates."""
    fs = 10000.0
    x = _tone(f0, 8192, fs, cplx=cplx, noise=0.01 if method == "zero_crossing"
              and cplx else 0.0)
    yt, yj = _both("FrequencyEstimator", dict(chunk=1024, method=method), x,
                   block_len=2048, fs=fs)
    assert yt.shape == (8,)
    _close(yt, yj)
    if tol is not None:
        np.testing.assert_allclose(yt, f0, atol=tol * fs / 1024)
    elif method == "zero_crossing":
        np.testing.assert_allclose(yt, f0, atol=1.0)


GRID_CASES = ([("period", 128, 128, f, 0.03)
               for f in (49.9, 50.0, 50.003, 50.05, 50.4, 51.0)]
              + [("fft", 4096, 4096, f, 1.0) for f in (49.9, 50.05, 51.0)]
              + [("period", 128, 1280, 50.05, 0.03),
                 ("fft", 4096, 40960, 50.5, 0.1)])


@pytest.mark.parametrize("method, chunk, n, freq, tol", GRID_CASES)
def test_frequency_estimator_grid_sweep(method, chunk, n, freq, tol):
    """qa_FrequencyEstimator's grid sweep (tests/test_frequency_estimator_
    golden.py) at 1 kHz with 1% noise: the period regression with its band
    (45–55 Hz, else 50) and the 4096-point FFT, one chunk and decimating,
    with the JAX test's accuracy bounds."""
    fs = 1000.0
    rng = np.random.default_rng(1)
    x = (np.sin(2 * np.pi * freq / fs * np.arange(1, n + 1))
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
    settings = dict(method=method, chunk=chunk)
    if method == "period":
        settings.update(f_min=45.0, f_max=55.0, f_expected=50.0)
    yt, yj = _both("FrequencyEstimator", settings, x, block_len=n, fs=fs)
    assert yt.shape == (n // chunk,)
    _close(yt, yj)
    np.testing.assert_allclose(yt, freq, atol=tol)


def test_frequency_estimator_out_of_band_falls_back():
    settings = dict(method="period", chunk=128, f_min=45.0, f_max=55.0,
                    f_expected=50.0)
    yt, yj = _both("FrequencyEstimator", settings, np.zeros(256, np.float32),
                   block_len=128, fs=1000.0)
    np.testing.assert_array_equal(yt, yj)
    assert np.all(yt == 50.0)


# -- Savitzky-Golay, SVD ----------------------------------------------------------

@pytest.mark.parametrize("window, order, deriv", [(11, 3, 0), (31, 3, 0),
                                                  (15, 4, 1)])
def test_savgol_design_and_block(window, order, deriv):
    """The design is the JAX package's code (equal taps); the block filters a
    noisy sine in steps of 512 within ``F32_ATOL``, smoothing as the JAX test
    asks."""
    from gnuradio4_tpu.ops.savgol import design_savgol as jd
    from gnuradio4_tpu_torch.ops.savgol import design_savgol as td
    np.testing.assert_array_equal(td(window, order, deriv=deriv),
                                  jd(window, order, deriv=deriv))
    rng = np.random.default_rng(0xC0FFEE)
    clean = np.sin(2 * np.pi * np.arange(2048) / 512.0)
    noisy = (clean + 0.3 * rng.standard_normal(2048)).astype(np.float32)
    settings = dict(window=window, poly_order=order, deriv=deriv)
    (yt, _, st), (yj, _, sj) = (_run(p, "SavitzkyGolayFilter", settings, noisy,
                                     block_len=512) for p in (gt, gr))
    _close(yt, yj)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if (window, deriv) == (31, 0):
        err_out = np.std(yt[100:1900] - clean[85:1885])
        assert err_out < 0.4 * np.std(noisy[100:1900] - clean[100:1900])


def test_savgol_dataset_equal():
    from gnuradio4_tpu.core.dataset import DataSet as JDS
    from gnuradio4_tpu.ops.savgol import savgol_dataset as jsd
    from gnuradio4_tpu_torch.core.dataset import DataSet as TDS
    from gnuradio4_tpu_torch.ops.savgol import savgol_dataset as tsd
    rng = np.random.default_rng(SEED)
    noisy = rng.standard_normal((2, 1024)).astype(np.float32)
    oj = jsd(JDS(values=noisy.copy()), window=31, poly_order=3)
    ot = tsd(TDS(values=noisy.copy()), window=31, poly_order=3)
    np.testing.assert_array_equal(ot.values, oj.values)
    assert [(s.range_min, s.range_max) for s in ot.signals] == \
        [(s.range_min, s.range_max) for s in oj.signals]


def test_svd_ops_against_jax():
    """hankel and rank_mask equal; jacobi_svd's singular values and
    reconstruction within ``SVD_ATOL`` of the JAX package's (real and
    complex, odd width, wide input through ``svd``)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(tsvd.hankel(torch.from_numpy(x), 9).numpy(),
                                  np.asarray(jsvd.hankel(jnp.asarray(x), 9)))
    s = np.sort(rng.random((4, 12)).astype(np.float32))[:, ::-1].copy()
    for kw in (dict(max_rank=3), dict(energy_fraction=0.6),
               dict(rel_threshold=0.5), dict(abs_threshold=0.7)):
        np.testing.assert_array_equal(
            tsvd.rank_mask(torch.from_numpy(s), **kw).numpy(),
            np.asarray(jsvd.rank_mask(jnp.asarray(s), **kw)))
    for shape, cplx in (((40, 7), False), ((40, 8), True), ((6, 30), False)):
        a = rng.standard_normal(shape).astype(np.float32)
        if cplx:
            a = (a + 1j * rng.standard_normal(shape)).astype(np.complex64)
        ut, st, vt = tsvd.svd(torch.from_numpy(a), method="jacobi")
        uj, sj, vj = jsvd.svd(jnp.asarray(a), method="jacobi")
        np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                                   atol=SVD_ATOL * np.abs(a).max())
        rec = (ut * st[None, :].to(ut.dtype)) @ vt
        np.testing.assert_allclose(rec.numpy(), a, atol=SVD_ATOL * np.abs(a).max())


@pytest.mark.parametrize("engine", ["auto", "xla", "jacobi"])
@pytest.mark.parametrize("cplx", [False, True])
def test_svd_denoiser(engine, cplx):
    """tests/test_misc_blocks.py's denoiser cases (a tone in noise, chunk
    256, window 24, rank 2), both engines, real and complex, in steps of 512:
    within ``SVD_ATOL`` of the peak; the noise halves, as the JAX test asks."""
    rng = np.random.default_rng(0xC0FFEE)
    t = np.arange(1024)
    if cplx:
        clean = np.exp(2j * np.pi * 0.02 * t).astype(np.complex64)
        noisy = (clean + 0.25 * (rng.standard_normal(1024)
                                 + 1j * rng.standard_normal(1024))
                 ).astype(np.complex64)
    else:
        clean = np.sin(2 * np.pi * 4 * t / 256.0)
        noisy = (clean + 0.2 * rng.standard_normal(1024)).astype(np.float32)
    yt, yj = _both("SvdDenoiser", dict(chunk=256, window=24, rank=2,
                                       engine=engine), noisy, block_len=512)
    assert yt.dtype == noisy.dtype and yt.shape == (1024,)
    np.testing.assert_allclose(yt, yj, atol=SVD_ATOL * np.abs(noisy).max())
    assert np.std(yt - clean) < 0.5 * np.std(noisy - clean)


def test_svd_denoiser_auto_engine_by_device():
    from gnuradio4_tpu_torch.blocks.misc import SvdDenoiser
    b = SvdDenoiser()
    assert b._engine(torch.device("cpu")) == "xla"
    assert b._engine(torch.device("cuda")) in ("xla", "jacobi")
    assert SvdDenoiser(engine="jacobi")._engine(torch.device("cpu")) == "jacobi"


# -- BurstTaper, StreamFilter, SyncBlock --------------------------------------------

@pytest.mark.parametrize("shape", ["raised_cosine", "linear", "tukey",
                                   "gaussian", "mushroom", "mushroom_sine",
                                   "none"])
def test_burst_taper(shape):
    """burst_start / burst_stop tags in two steps (one burst across the step
    boundary, one pair with a stop before its start) on a complex stream:
    within ``F32_ATOL``; the JAX test's envelope checks at raised_cosine."""
    x = np.ones(2048, np.complex64) * (1 + 0.5j)
    tags = [(100, "burst_start"), (500, "burst_stop"), (1000, "burst_start"),
            (1030, "burst_stop"), (1500, "burst_stop"), (1700, "burst_start")]
    settings = dict(ramp_len=32, shape=shape)
    yt, yj = _both("BurstTaper", settings, x, block_len=1024, tags=tags)
    _close(yt, yj)
    if shape == "raised_cosine":
        y = np.abs(yt) / abs(1 + 0.5j)
        assert y[100] < 0.05 and abs(y[131] - 1.0) < 0.05 and y[499] < 0.1
        np.testing.assert_allclose(y[200:460], 1.0, rtol=1e-6)


def test_burst_taper_op():
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    ramp = jest.taper_edge("tukey", 40, rising=True)
    for up in (True, False):
        np.testing.assert_array_equal(
            test_.burst_taper(torch.from_numpy(x), ramp=ramp, up=up).numpy(),
            np.asarray(jest.burst_taper(jnp.asarray(x), ramp=ramp, up=up)))


@pytest.mark.parametrize("settings, tags", [
    (dict(filter="A", filter_stop="B"),
     [(10, "A"), (300, "B"), (900, "A"), (1100, "X"), (1800, "B"),
      (2100, "A"), (2100, "B")]),
    (dict(filter="A"),     # toggles: start, stop, start (held open), stop
     [(10, "A"), (300, "A"), (900, "A"), (1900, "A"), (2047, "A")]),
    (dict(filter="A", filter_stop="B", max_events_per_step=2),
     [(1, "A"), (2, "A"), (3, "A"), (100, "B"), (200, "B")]),
])
def test_stream_filter(settings, tags):
    """Windows opened and closed by tags across three steps of 1024, the
    carried state too, on a complex stream: bit for bit."""
    rng = np.random.default_rng(SEED)
    x = (rng.standard_normal(3072) + 1j * rng.standard_normal(3072)
         ).astype(np.complex64)
    (yt, _, st), (yj, _, sj) = (_run(p, "StreamFilter", settings, x,
                                     block_len=1024, tags=tags)
                                for p in (gt, gr))
    np.testing.assert_array_equal(yt, yj)
    assert bool(st) == bool(np.asarray(sj))
    assert np.count_nonzero(yt) > 0


@pytest.mark.parametrize("lag", [7, 0, 64, 100])
def test_sync_block_aligns(lag):
    """tests/test_misc_blocks.py's aligner: stream B lags A; both outputs
    equal the JAX package's (and each other after alignment); a lag above
    max_skew clamps."""
    n = 2048
    base = np.arange(n, dtype=np.float32)
    lagged = np.concatenate([np.zeros(lag, np.float32), base[:n - lag]])
    outs = []
    for pkg in (gt, gr):
        reg = pkg.global_registry
        g = pkg.Graph()
        a = reg.create("VectorSource", data=base, tags=[_tag(pkg, 100, "sync")])
        b = reg.create("VectorSource", data=lagged,
                       tags=[_tag(pkg, 100 + lag, "sync")])
        sync = reg.create("SyncBlock", n_inputs=2, max_skew=64)
        s0, s1 = reg.create("VectorSink"), reg.create("VectorSink")
        g.connect(a, sync["in0"])
        g.connect(b, sync["in1"])
        g.connect(sync["out0"], s0)
        g.connect(sync["out1"], s1)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=512, **kw).run_and_wait()
        outs.append((np.asarray(s0.data()), np.asarray(s1.data()),
                     [(t.index, dict(t.map)) for t in s0.tags]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]
    if lag <= 64:
        np.testing.assert_array_equal(outs[0][0][600:1500], outs[0][1][600:1500])


# -- host estimators ---------------------------------------------------------------

def test_host_estimators_equal():
    """The numpy estimators are the JAX package's code: equal results."""
    rng = np.random.default_rng(SEED)
    x = np.exp(-0.5 * ((np.arange(200.0) - 91.3) / 5.0) ** 2) \
        + 0.01 * rng.standard_normal(200)
    for fn in ("minimum", "maximum", "mean", "rms", "std", "peak_to_peak",
               "peak_index", "interpolated_peak", "median", "integral",
               "centre_of_mass", "duty_cycle", "frequency_estimate",
               "gauss_interpolated_peak", "fwhm", "step_start"):
        a, b = getattr(test_, fn)(x), getattr(jest, fn)(x)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=fn)
    assert test_.edge_detect(x, threshold=0.5) == jest.edge_detect(x, threshold=0.5)
    for kind in test_.TAPER_SHAPES:
        np.testing.assert_array_equal(test_.taper(kind, 9, 5, 7),
                                      jest.taper(kind, 9, 5, 7))
    rt, rj = test_.SampleRateDll(), jest.SampleRateDll()
    for e in (rt, rj):
        e.reset(1000.0)
        for k in range(20):
            e.update(k * 0.1 + 1e-5 * k * k, 100)
    assert rt.estimated_rate() == rj.estimated_rate()
