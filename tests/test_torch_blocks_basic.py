"""The port's basic blocks (``blocks/basic.py``: Selector, Interleave,
Deinterleave, the converters, SignalGenerator's noise types) and host noise
generators (``ops/noise.py``: Xoshiro256pp, GaussianNoise, NoiseGenerator)
against the JAX package's, on the CPU, from the same seeded inputs.

Tolerances: exact for the data movements, casts, component splits and
scalings (bit for bit); |x|, arg(x) and mag·e^{jφ} within 2 float32 ulps of
their size (each library's own f32 abs/atan2/sincos); the uniform and
triangular noise types bit for bit; the Gaussian noise type within 1e-5 of
max(1, |x|) (torch's erfinv against XLA's float32 polynomial, as for
NoiseSource); the Xoshiro256pp and NoiseGenerator streams bit for bit."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.ops import noise as jnz
from gnuradio4_tpu_torch.ops import noise as tnz

torch.set_num_threads(2)

N = 1024          # samples per step
STEPS = 3
SEED = 20261017
ULP_RTOL = 2 * float(np.finfo(np.float32).eps)
NORMAL_RTOL = 1e-5


def _inputs():
    rng = np.random.default_rng(SEED)
    n = N * STEPS
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return {
        "c": z,
        "f": rng.standard_normal(n).astype(np.float32),
        "g": (rng.standard_normal(n) * 3).astype(np.float32),
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "sel": rng.integers(0, 3, n).astype(np.uint32),
    }


def _run(pkg, block_type, settings, ins, outs, in_port_of=None):
    """``ins``: {input port: input key}; ``outs``: output ports. Each input
    comes from a VectorSource of the seeded data, each output goes to a
    VectorSink; returns {output port: data}."""
    data = _inputs()
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(block_type, name="dut", **settings)
    g.add(blk)
    for port, key in ins.items():
        src = reg.create("VectorSource", data=data[key], name=f"src_{port}")
        g.connect(src, blk[port])
    sinks = {}
    for port in outs:
        sinks[port] = reg.create("VectorSink", name=f"snk_{port}")
        g.connect(blk[port], sinks[port])
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=N, sample_rate=48e3, **kw).run_and_wait(STEPS)
    return {p: s.data() for p, s in sinks.items()}


CASES = {
    # name: (type, settings, inputs, outputs, exact)
    "Selector": ("Selector", {"n_inputs": 3, "n_outputs": 2, "map_in": (0, 1, 2),
                              "map_out": (1, 0, 0), "selected_src": 2},
                 {"in0": "f", "in1": "g", "in2": "f"}, ["out0", "out1", "monitor"], True),
    "Selector_select": ("Selector", {"n_inputs": 3, "n_outputs": 1},
                        {"in0": "f", "in1": "g", "in2": "f", "select": "sel"},
                        ["out0", "monitor"], True),
    "Interleave": ("Interleave", {"n_inputs": 3, "chunk_size": 4},
                   {"in0": "f", "in1": "g", "in2": "i"}, ["out"], True),
    "Deinterleave": ("Deinterleave", {"n_outputs": 4, "chunk_size": 2},
                     {"in": "c"}, ["out0", "out1", "out2", "out3"], True),
    "Convert_int": ("Convert", {"to": "int16"}, {"in": "g"}, ["out"], True),
    "Convert_complex": ("Convert", {"to": "complex64"}, {"in": "i"}, ["out"], True),
    "Convert_real": ("Convert", {"to": "float32"}, {"in": "c"}, ["out"], True),
    "ScalingConvert": ("ScalingConvert", {"to": "int32", "scale": 100.0},
                       {"in": "g"}, ["out"], True),
    "ScalingConvert_int": ("ScalingConvert", {"to": "float32", "scale": 2.7},
                           {"in": "i"}, ["out"], True),
    "ComplexToReal": ("ComplexToReal", {}, {"in": "c"}, ["out"], True),
    "ComplexToImag": ("ComplexToImag", {}, {"in": "c"}, ["out"], True),
    "ToRealImag": ("ToRealImag", {}, {"in": "c"}, ["real", "imag"], True),
    "ComplexToMagPhase": ("ComplexToMagPhase", {}, {"in": "c"}, ["mag", "phase"], False),
    "Arg": ("Arg", {}, {"in": "c"}, ["out"], False),
    "MagPhaseToComplex": ("MagPhaseToComplex", {}, {"mag": "g", "phase": "f"},
                          ["out"], False),
    "RealImagToComplex": ("RealImagToComplex", {}, {"real": "f", "imag": "g"},
                          ["out"], True),
    "ComplexToInterleaved": ("ComplexToInterleaved", {}, {"in": "c"}, ["out"], True),
    "InterleavedToComplex": ("InterleavedToComplex", {}, {"in": "f"}, ["out"], True),
    "DegToRad": ("DegToRad", {}, {"in": "g"}, ["out"], True),
    "RadToDeg": ("RadToDeg", {}, {"in": "g"}, ["out"], True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_jax(case):
    btype, settings, ins, outs, exact = CASES[case]
    want = _run(gr, btype, settings, ins, outs)
    got = _run(gt, btype, settings, ins, outs)
    for port in outs:
        w, g_ = want[port], got[port]
        assert g_.dtype == w.dtype and g_.shape == w.shape, (port, g_.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g_, w, err_msg=port)
        else:
            if port == "phase" or btype == "Arg":    # wrap ±π
                d = np.abs(np.angle(np.exp(1j * (g_.astype(np.float64) - w))))
            else:
                d = np.abs(g_.astype(np.complex128) - w)
            assert np.all(d <= ULP_RTOL * np.maximum(1.0, np.abs(w)) * 4), port


def test_every_ported_basic_block_has_the_jax_settings_and_ports():
    for name in sorted({c[0] for c in CASES.values()}):
        cj = gr.global_registry.get(name)
        ct = gt.global_registry.get(name)
        assert sorted(cj._settings_spec) == sorted(ct._settings_spec), name
        assert [p.name for p in cj.IN] == [p.name for p in ct.IN], name
        assert [p.name for p in cj.OUT] == [p.name for p in ct.OUT], name


@pytest.mark.parametrize("signal", ["UniformNoise", "TriangularNoise", "GaussianNoise"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_signal_generator_noise(signal, dtype):
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", signal=signal, seed=11, amplitude=50.0,
                        offset=3.0, dtype=dtype, channels=2)
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=N, sample_rate=48e3, **kw).run_and_wait(STEPS)
        out.append(snk.data())
    want, got = out
    assert got.dtype == want.dtype and got.shape == want.shape == (2, N * STEPS)
    if signal == "GaussianNoise" and dtype == "float32":
        err = np.abs(got - want) / np.maximum(50.0, np.abs(want))
        assert err.max() <= NORMAL_RTOL
    elif signal == "GaussianNoise":
        # rounding to int16 may flip where the draws differ by an ulp
        assert np.abs(got.astype(int) - want).max() <= 1
        assert np.mean(got == want) > 0.999
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**63 + 5])
def test_xoshiro256pp_streams_are_equal(seed):
    a, b = jnz.Xoshiro256pp(seed), tnz.Xoshiro256pp(seed)
    assert [a() for _ in range(64)] == [b() for _ in range(64)]
    for kind in ("uniform01", "uniformM11", "triangularM11", "raw"):
        np.testing.assert_array_equal(a.array(100, kind=kind), b.array(100, kind=kind))


@pytest.mark.parametrize("kind", ["uniform", "triangular", "gaussian"])
def test_noise_generator_streams_are_equal(kind):
    a = jnz.NoiseGenerator(kind, amplitude=0.5, offset=0.1, seed=9)
    b = tnz.NoiseGenerator(kind, amplitude=0.5, offset=0.1, seed=9)
    np.testing.assert_array_equal(a.fill(257), b.fill(257))
    np.testing.assert_array_equal(a.fill_complex(65, np.float32),
                                  b.fill_complex(65, np.float32))
    ga = jnz.GaussianNoise(jnz.Xoshiro256pp(3))
    gb = tnz.GaussianNoise(tnz.Xoshiro256pp(3))
    np.testing.assert_array_equal(ga.fill(101, amplitude=2.0), gb.fill(101, amplitude=2.0))
