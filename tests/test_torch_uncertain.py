"""The port's uncertain streams (``utils/uncertain.py``, ``blocks/uncertain.py``
and the ``uncertain=True`` modes of FirFilter, IirFilter and the math blocks),
the YAML mapping of a reference ``UncertainValue`` type onto them, and
``blocks/electrical.py`` against the JAX package's, on the CPU: the cases of
``tests/test_uncertain_stream.py`` and of ``tests/test_misc_blocks.py``'s
``TestElectrical``, run through both packages from the same seeded inputs,
with the JAX tests' own checks held on the port's output.

Tolerances: the converters and the plane-agnostic Decimator are exact; the
elementwise algebra (Add, Multiply, Divide, MultiplyConst) within
``ALGEBRA_RTOL`` = 1e-6 of max(1, |y|) (float32 hypot and quotients); the
FIR's value and sigma planes within ``FIR_ATOL`` = 1e-5 · max(1, |y|)
(float32 sums in another order); the IIR's planes within ``IIR_ATOL`` =
1e-5 · max(1, |y|) (the same loop, float32 FMA contraction differs); the
electrical blocks within ``F32_ATOL`` = 1e-5 · max(1, |y|) of their
outputs (float32 means over the windows), SystemUnbalance's percentages
within ``UNBALANCE_ATOL`` = 100·4·2⁻²³ (a deviation from the mean is a few
of the mean's ulps, in percent of the mean)."""


import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

PKGS = (gt, gr)
ALGEBRA_RTOL = 1e-6
FIR_ATOL = 1e-5
IIR_ATOL = 1e-5
F32_ATOL = 1e-5
UNBALANCE_ATOL = 100 * 4 * 2.0 ** -23


def _close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    d = np.abs(a.astype(np.float64) - b)
    assert np.all(d <= atol * np.maximum(1.0, np.abs(b))), float(d.max())


def _run(pkg, g, block_len):
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=48000.0, **kw).run_and_wait()


def _uncertain_chain(pkg, streams, op, op_settings, *, block_len, binary=False):
    """VectorSource pairs → ToUncertain (×1 or ×2) → op → FromUncertain →
    value and sigma VectorSinks; returns (value, sigma, op block)."""
    g = pkg.Graph()
    tus = []
    for v, s in streams:
        sv = g.emplace("VectorSource", data=np.asarray(v, np.float32))
        tu = g.emplace("ToUncertain")
        g.connect(sv, tu, dst_port="in")
        if s is not None:
            ss = g.emplace("VectorSource", data=np.asarray(s, np.float32))
            g.connect(ss, tu, dst_port="sigma")
        tus.append(tu)
    blk = g.emplace(op, **op_settings)
    if binary:
        g.connect(tus[0], blk, dst_port="in0")
        g.connect(tus[1], blk, dst_port="in1")
    else:
        g.connect(tus[0], blk)
    fu = g.emplace("FromUncertain")
    kv, ks = g.emplace("VectorSink"), g.emplace("VectorSink")
    g.connect(blk, fu)
    g.connect(fu["value"], kv)
    g.connect(fu["sigma"], ks)
    _run(pkg, g, block_len)
    return np.asarray(kv.data()), np.asarray(ks.data()), blk


def _both(*args, **kw):
    return [_uncertain_chain(pkg, *args, **kw) for pkg in PKGS]


# -- converters ---------------------------------------------------------------------

def test_roundtrip_and_sigma_const():
    rng = np.random.default_rng(0)
    v, s = rng.standard_normal(4096), np.abs(rng.standard_normal(4096))
    for pkg in PKGS:
        kv, ks, _ = _uncertain_chain(pkg, [(v, s)], "Decimator", {"decim": 1},
                                     block_len=1024)
        np.testing.assert_array_equal(kv, v.astype(np.float32))
        np.testing.assert_array_equal(ks, s.astype(np.float32))
    (vt, st, _), (vj, sj, _) = _both([(np.ones(2048), None)], "Decimator",
                                     {"decim": 1}, block_len=512)
    # no sigma port: ToUncertain's sigma_const (0 here) fills the plane
    np.testing.assert_array_equal(st, sj)
    g = gt.Graph()
    src = g.emplace("VectorSource", data=np.ones(512, np.float32))
    tu = g.emplace("ToUncertain", sigma_const=0.25)
    fu = g.emplace("FromUncertain")
    ks = g.emplace("VectorSink")
    g.connect(src, tu, dst_port="in")
    g.connect(tu, fu)
    g.connect(fu["sigma"], ks)
    _run(gt, g, 512)
    np.testing.assert_array_equal(ks.data(), np.full(512, 0.25, np.float32))


def test_channelled_input_rejected():
    g = gt.Graph()
    src = g.emplace("VectorSource", data=np.ones((3, 512), np.float32))
    tu = g.emplace("ToUncertain")
    g.connect(src, tu, dst_port="in")
    with pytest.raises(Exception, match="scalar"):
        _run(gt, g, 512)


def test_uncertain_mode_refuses_plain_streams():
    g = gt.Graph()
    src = g.emplace("VectorSource", data=np.ones(512, np.float32))
    g.connect_chain(src, g.emplace("MultiplyConst", uncertain=True),
                    g.emplace("VectorSink"))
    with pytest.raises(Exception, match="2-plane"):
        _run(gt, g, 512)


# -- math ----------------------------------------------------------------------------

@pytest.mark.parametrize("op, rule", [
    ("Add", lambda v1, s1, v2, s2: (v1 + v2, np.hypot(s1, s2))),
    ("Subtract", lambda v1, s1, v2, s2: (v1 - v2, np.hypot(s1, s2))),
    ("Multiply", lambda v1, s1, v2, s2: (v1 * v2, np.hypot(s1 * v2, s2 * v1))),
    ("Divide", lambda v1, s1, v2, s2: (v1 / v2, np.hypot(s1 / v2, s2 * v1 / v2**2))),
])
def test_uncertain_binary_ops(op, rule):
    rng = np.random.default_rng(len(op))
    v1, v2 = rng.uniform(1, 2, 2048), rng.uniform(1, 2, 2048)
    s1, s2 = rng.uniform(0, 0.1, 2048), rng.uniform(0, 0.1, 2048)
    (vt, st, _), (vj, sj, _) = _both([(v1, s1), (v2, s2)], op,
                                     {"uncertain": True}, block_len=1024,
                                     binary=True)
    _close(vt, vj, ALGEBRA_RTOL)
    _close(st, sj, ALGEBRA_RTOL)
    want_v, want_s = rule(v1, s1, v2, s2)
    np.testing.assert_allclose(vt, want_v, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st, want_s, rtol=1e-4)


@pytest.mark.parametrize("op", ["AddConst", "SubtractConst", "MultiplyConst",
                                "DivideConst"])
def test_uncertain_const_ops(op):
    """The constant carries its own sigma (value 3 ± 0.5)."""
    rng = np.random.default_rng(4)
    v, s = rng.uniform(1, 2, 2048), rng.uniform(0, 0.1, 2048)
    (vt, st, _), (vj, sj, _) = _both(
        [(v, s)], op, {"uncertain": True, "value": 3.0, "value_sigma": 0.5},
        block_len=1024)
    _close(vt, vj, ALGEBRA_RTOL)
    _close(st, sj, ALGEBRA_RTOL)
    if op == "MultiplyConst":
        np.testing.assert_allclose(vt, 3.0 * v, rtol=1e-5)
        np.testing.assert_allclose(st, np.hypot(3.0 * s, 0.5 * v), rtol=1e-4)


def test_plain_mode_unchanged():
    """uncertain defaults off: plain 2-channel streams add planewise."""
    x = np.stack([np.ones(512), 2 * np.ones(512)]).astype(np.float32)
    for pkg in PKGS:
        g = pkg.Graph()
        a, b = g.emplace("VectorSource", data=x), g.emplace("VectorSource", data=x)
        op, k = g.emplace("Add"), g.emplace("VectorSink")
        g.connect(a, op, dst_port="in0")
        g.connect(b, op, dst_port="in1")
        g.connect(op, k)
        _run(pkg, g, 512)
        np.testing.assert_array_equal(np.asarray(k.data()), 2 * x)


def test_uncertain_value_algebra():
    """The UncertainValue class on tensors against the JAX package's on
    arrays: every operator, sqrt, relative, with host-number operands."""
    import jax.numpy as jnp
    from gnuradio4_tpu.utils.uncertain import UncertainValue as JU
    from gnuradio4_tpu_torch.utils.uncertain import UncertainValue as TU
    rng = np.random.default_rng(11)
    a, sa, b, sb = (rng.uniform(1, 2, 64).astype(np.float32) for _ in range(4))
    ju, jv = JU(jnp.asarray(a), jnp.asarray(sa)), JU(jnp.asarray(b), jnp.asarray(sb))
    tu, tv = (TU(torch.from_numpy(a), torch.from_numpy(sa)),
              TU(torch.from_numpy(b), torch.from_numpy(sb)))
    for f in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
              lambda x, y: x / y, lambda x, y: 2.5 - x, lambda x, y: 3.0 / y,
              lambda x, y: -x * 0.5, lambda x, y: x.sqrt()):
        rt, rj = f(tu, tv), f(ju, jv)
        _close(rt.value.numpy(), np.asarray(rj.value), ALGEBRA_RTOL)
        _close(np.broadcast_to(rt.uncertainty.numpy(), (64,)),
               np.broadcast_to(np.asarray(rj.uncertainty), (64,)), ALGEBRA_RTOL)
    _close(tu.relative().numpy(), np.asarray(ju.relative()), ALGEBRA_RTOL)


# -- filters -------------------------------------------------------------------------

@pytest.mark.parametrize("taps, decim, block_len", [
    (np.hanning(31) / np.hanning(31).sum(), 1, 1000),
    (np.array([0.5, 0.3, 0.2]), 1, 1024),
    (np.ones(8) / 8, 4, 1024),
])
def test_uncertain_fir(taps, decim, block_len):
    """sigma_out = sqrt(fir(sigma², h²)), across chunk seams, decimating:
    against the JAX package and a float64 convolution."""
    rng = np.random.default_rng(5)
    n = 8192
    v, s = rng.standard_normal(n), rng.uniform(0.1, 1.0, n)
    settings = {"taps": tuple(taps), "decim": decim, "uncertain": True}
    (vt, st, bt), (vj, sj, _) = _both([(v, s)], "FirFilter", settings,
                                      block_len=block_len)
    _close(vt, vj, FIR_ATOL)
    _close(st, sj, FIR_ATOL)
    ref_v = np.convolve(v.astype(np.float32), taps)[:n:decim]
    ref_s = np.sqrt(np.convolve(s.astype(np.float32) ** 2, taps ** 2)[:n:decim])
    np.testing.assert_allclose(vt, ref_v, atol=1e-5)
    np.testing.assert_allclose(st, ref_s, atol=1e-5)


def test_uncertain_fir_refuses_complex_taps():
    g = gt.Graph()
    src = g.emplace("VectorSource", data=np.ones(256, np.float32))
    tu = g.emplace("ToUncertain")
    g.connect(src, tu, dst_port="in")
    g.connect_chain(tu, g.emplace("FirFilter", taps=(1.0, 0.5j), uncertain=True),
                    g.emplace("VectorSink"))
    with pytest.raises(Exception, match="real taps"):
        _run(gt, g, 256)


@pytest.mark.parametrize("b, a", [((0.2,), (1.0, -0.8)),
                                  ((0.1, 0.2, 0.1), (1.0, -0.9, 0.3))])
def test_uncertain_iir(b, a):
    """The per-op variance recursion sy2[n] = Σb²·sx2[n−k] + Σa²·sy2[n−j],
    carried across steps, against the JAX package; the one-pole case against
    its float64 recursion."""
    rng = np.random.default_rng(8)
    n = 2048
    v, s = rng.standard_normal(n), rng.uniform(0.1, 1, n)
    (vt, st, _), (vj, sj, _) = _both([(v, s)], "IirFilter",
                                     {"b": b, "a": a, "uncertain": True},
                                     block_len=500)
    _close(vt, vj, IIR_ATOL)
    _close(st, sj, IIR_ATOL)
    if len(b) == 1:
        ref_v, ref_s2 = np.zeros(n), np.zeros(n)
        for i in range(n):
            ref_v[i] = 0.2 * v[i] + 0.8 * (ref_v[i - 1] if i else 0.0)
            ref_s2[i] = 0.04 * s[i] ** 2 + 0.64 * (ref_s2[i - 1] if i else 0.0)
        np.testing.assert_allclose(vt, ref_v, atol=1e-4)
        np.testing.assert_allclose(st, np.sqrt(ref_s2), atol=1e-4)


def test_decimator_is_plane_agnostic():
    rng = np.random.default_rng(9)
    v, s = rng.standard_normal(4096), rng.uniform(0, 1, 4096)
    (vt, st, _), (vj, sj, _) = _both([(v, s)], "Decimator", {"decim": 8},
                                     block_len=1024)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(vt, v[::8].astype(np.float32))


def test_uncertain_chain():
    """ToUncertain → FirFilter(uncertain) → MultiplyConst(uncertain) →
    FromUncertain, chip_smoke.py phase 25(b)'s chain, in both packages."""
    rng = np.random.default_rng(12)
    n = 4096
    v, s = rng.standard_normal(n), rng.uniform(0.1, 1, n)
    out = []
    for pkg in PKGS:
        g = pkg.Graph()
        sv = g.emplace("VectorSource", data=v.astype(np.float32))
        ss = g.emplace("VectorSource", data=s.astype(np.float32))
        tu = g.emplace("ToUncertain")
        g.connect(sv, tu, dst_port="in")
        g.connect(ss, tu, dst_port="sigma")
        fir = g.emplace("FirFilter", taps=tuple(np.hanning(15) / 7.0),
                        uncertain=True)
        mul = g.emplace("MultiplyConst", value=2.0, value_sigma=0.1, uncertain=True)
        fu = g.emplace("FromUncertain")
        kv, ks = g.emplace("VectorSink"), g.emplace("VectorSink")
        g.connect_chain(tu, fir, mul, fu)
        g.connect(fu["value"], kv)
        g.connect(fu["sigma"], ks)
        _run(pkg, g, 1024)
        out.append((np.asarray(kv.data()), np.asarray(ks.data())))
    _close(out[0][0], out[1][0], FIR_ATOL)
    _close(out[0][1], out[1][1], FIR_ATOL)


# -- YAML ------------------------------------------------------------------------------

@pytest.mark.parametrize("type_id, uncertain", [
    ("gr::blocks::math::Add<gr::UncertainValue<float>>", True),
    ("gr::blocks::math::Add<float>", False),
    ("gr::blocks::filter::FirFilter<gr::UncertainValue<float>>", True),
    # an alias is a factory, not a block type: neither package maps it
    ("gr::blocks::filter::fir_filter<gr::UncertainValue<float>>", False),
])
def test_reference_templated_id(type_id, uncertain):
    """A reference GRC whose type parameter is UncertainValue loads into
    uncertain mode where the id names a block type, as in the JAX package."""
    yml = f"""
blocks:
  - id: {type_id}
    parameters: {{name: blk}}
"""
    for pkg in PKGS:
        g = pkg.load_grc(yml)
        blk = next(b for b in g.blocks if b.name == "blk")
        assert bool(blk.settings.get("uncertain")) is uncertain


# -- electrical ------------------------------------------------------------------------

def _power_graph(pkg, u, i, su=None, si=None, *, decim, outs, pf=False):
    g = pkg.Graph()
    srcs = {"u": u, "i": i, "u_sigma": su, "i_sigma": si}
    pm = g.emplace("PowerMetrics", decim=decim)
    for port, data in srcs.items():
        if data is not None:
            g.connect(g.emplace("VectorSource", data=np.asarray(data, np.float32)),
                      pm[port])
    sinks = {}
    tail = pm
    if pf:
        tail = g.emplace("PowerFactor")
        for port in ("p", "s", "p_sigma", "s_sigma"):
            g.connect(pm[port], tail[port])
    for port in outs:
        sinks[port] = g.emplace("VectorSink")
        g.connect(tail[port], sinks[port])
    _run(pkg, g, 2 * decim)
    return {p: np.asarray(k.data()) for p, k in sinks.items()}


@pytest.mark.parametrize("with_sigma, pf", [(False, False), (True, False),
                                            (True, True)])
def test_power_metrics_and_factor(with_sigma, pf):
    """tests/test_misc_blocks.py's PowerMetrics and PowerFactor cases (a
    0.2 rad lag at 50 Hz, 1% sigma inputs): every output within
    ``F32_ATOL`` of the JAX package's, and the JAX tests' expectations."""
    fs, n, d = 10000.0, 20000, 2000
    t = np.arange(n) / fs
    u = 325.0 * np.sin(2 * np.pi * 50.0 * t)
    i = 14.1 * np.sin(2 * np.pi * 50.0 * t - 0.2)
    su = np.full(n, 3.25) if with_sigma else None
    si = np.full(n, 0.141) if with_sigma else None
    outs = (("power_factor", "phase", "power_factor_sigma") if pf else
            ("p", "q", "s", "u_rms", "i_rms", "p_sigma", "s_sigma",
             "u_rms_sigma", "i_rms_sigma"))
    rt, rj = (_power_graph(pkg, u, i, su, si, decim=d, outs=outs, pf=pf)
              for pkg in PKGS)
    for k in outs:
        _close(rt[k], rj[k], F32_ATOL)
    if pf:
        np.testing.assert_allclose(rt["power_factor"], np.cos(0.2), atol=1e-3)
        assert np.all(rt["power_factor_sigma"] > 0)
        assert np.all(rt["power_factor_sigma"] < 0.01)
    else:
        np.testing.assert_allclose(rt["p"], 0.5 * 325 * 14.1 * np.cos(0.2),
                                   rtol=1e-2)


def test_power_factor_zero_active_power_finite_sigma():
    out = []
    for pkg in PKGS:
        g = pkg.Graph()
        pf = g.emplace("PowerFactor")
        for port, val in (("p", 0.0), ("s", 100.0), ("p_sigma", 5.0),
                          ("s_sigma", 1.0)):
            g.connect(g.emplace("VectorSource", data=np.full(8, val, np.float32)),
                      pf[port])
        k = g.emplace("VectorSink")
        g.connect(pf["power_factor_sigma"], k)
        _run(pkg, g, 8)
        out.append(np.asarray(k.data()))
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out[0], 0.05, rtol=1e-5)


def test_system_unbalance():
    """Three phases with unequal RMS values: the unbalance percentages and
    the total power within ``F32_ATOL`` of the JAX package's."""
    rng = np.random.default_rng(13)
    u = (230.0 + rng.uniform(-5, 5, (3, 64))).astype(np.float32)
    i = (10.0 + rng.uniform(-1, 1, (3, 64))).astype(np.float32)
    p = (2300.0 + rng.uniform(-50, 50, (3, 64))).astype(np.float32)
    res = []
    for pkg in PKGS:
        g = pkg.Graph()
        su = g.emplace("SystemUnbalance")
        for port, data in (("u_rms", u), ("i_rms", i), ("p", p)):
            g.connect(g.emplace("VectorSource", data=data), su[port])
        sinks = {q: g.emplace("VectorSink")
                 for q in ("u_unbalance", "i_unbalance", "p_total")}
        for q, k in sinks.items():
            g.connect(su[q], k)
        _run(pkg, g, 32)
        res.append({q: np.asarray(k.data()) for q, k in sinks.items()})
    _close(res[0]["p_total"], res[1]["p_total"], F32_ATOL)
    # the deviation is a difference of float32 values near the mean: a few
    # ulps of the mean, 100·4·2⁻²³ ≈ 4.8e-5 once scaled to percent
    for q in ("u_unbalance", "i_unbalance"):
        d = np.abs(res[0][q].astype(np.float64) - res[1][q])
        assert np.all(d <= UNBALANCE_ATOL), float(d.max())
    want = 100 * np.max(np.abs(u - u.mean(0)), axis=0) / u.mean(0)
    np.testing.assert_allclose(res[0]["u_unbalance"], want, rtol=1e-4)
