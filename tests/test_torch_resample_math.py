"""Parity of the port's rational resampler, filter, math, Fourier and channel
blocks against the JAX package, on the CPU: each block applied in both
packages to the same seeded inputs over several chunks with its carried state;
the Rotator across 2³² phase wraps, with a constant and a tag-ramped
increment; and streams started in the JAX package and continued in the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.block import BlockCtx as JBlockCtx
from gnuradio4_tpu_torch.core.block import BlockCtx as TBlockCtx
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.interop import params_from_numpy, states_from_numpy
from gnuradio4_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

# f32 sums over ≤ 49 taps, two summation orders: max|Δ| relative to the RMS
RTOL = 1e-5
# per-sample NCO (the port: sincos of the f32 phase; the JAX package: its
# factored ramp), |x| ≲ 5, plus the f32 FFTs of the lock-in
NCO_ATOL = 1e-5
# spectra and inverse transforms, relative to the largest magnitude
SPEC_RTOL = 1e-5


def _rms_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.sqrt(np.mean(np.abs(want) ** 2))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, err


def _data(rng, shape, cx):
    x = rng.standard_normal(shape)
    if cx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if cx else np.float32)


def _ctx(pkg, n_in, n_out, ins_dt, fs=1e6, params=None, channels=0):
    kw = dict(in_len={p: n_in for p in ins_dt},
              out_len={"out": n_out}, sample_rate=fs, params=params or {},
              channels={**{p: channels for p in ins_dt}, "out": channels},
              dtypes={p: np.dtype(d) for p, d in ins_dt.items()})
    return (JBlockCtx if pkg is gr else TBlockCtx)(**kw)


def _run(pkg, blk, steps, n_out, fs=1e6, params_of=None, state0=None):
    """Apply ``blk`` over ``steps`` (a list of {port: ndarray}) in ``pkg``;
    returns every output port's concatenation and the final state."""
    first = steps[0]
    n_in = next(iter(first.values())).shape[-1]
    ch = next(iter(first.values())).shape[0] if next(iter(first.values())).ndim > 1 else 0
    dts = {p: a.dtype for p, a in first.items()}
    ctx = _ctx(pkg, n_in, n_out, dts, fs, channels=ch)
    st = blk.init_state(ctx) if state0 is None else state0
    outs: dict[str, list] = {}
    to = jnp.asarray if pkg is gr else torch.from_numpy
    for i, ins in enumerate(steps):
        params = blk.prepare_params(blk.settings.dynamic_params())
        if params_of is not None:
            params = {**params, **params_of(i)}
        ctx.params = params
        st, o = blk.apply(st, {p: to(a) for p, a in ins.items()}, ctx)
        for p, v in o.items():
            outs.setdefault(p, []).append(np.asarray(v))
    return {p: np.concatenate(v, -1) for p, v in outs.items()}, st


def _both(name, steps, n_out, fs=1e6, **settings):
    res = []
    for pkg in (gr, gt):
        blk = pkg.global_registry.create(name, **settings)
        res.append(_run(pkg, blk, steps, n_out, fs)[0])
    return res


# -- RationalResampler -----------------------------------------------------------

@pytest.mark.parametrize("form", ["interleave", "matmul"])
@pytest.mark.parametrize("interp,decim", [(3, 2), (2, 3), (1, 4)])
@pytest.mark.parametrize("cx", [False, True])
def test_resampler_forms_match_jax(rng, form, interp, decim, cx):
    from gnuradio4_tpu.ops.resample import RationalResamplerKernel as JK
    from gnuradio4_tpu_torch.ops.resample import RationalResamplerKernel as TK
    kj, kt = JK(interp, decim), TK(interp, decim)
    np.testing.assert_array_equal(kt.taps, kj.taps)
    t = 1200
    st_j = kj.init_state(0, jnp.complex64 if cx else jnp.float32)
    st_t = kt.init_state(0, np.complex64 if cx else np.float32)
    for _ in range(3):
        x = _data(rng, t, cx)
        yj, st_j = kj.apply(jnp.asarray(x), st_j, method=form)
        yt, st_t = kt.apply(torch.from_numpy(x), st_t, method=form)
        assert yt.shape == (t * interp // decim,)
        _rms_close(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


def test_resampler_auto_on_cpu_is_the_jax_cpu_choice(rng):
    from gnuradio4_tpu_torch.ops.resample import RationalResamplerKernel as TK
    k = TK(3, 2)
    x = torch.from_numpy(_data(rng, 1024, False))
    st = k.init_state(0, np.float32)
    a, _ = k.apply(x, st)
    b, _ = k.apply(x, st, method="interleave")
    assert torch.equal(a, b)


def test_rational_resampler_block_matches_jax(rng):
    steps = [{"in": _data(rng, 2048, True)} for _ in range(3)]
    a, b = _both("RationalResampler", steps, 3072, interp=3, decim=2)
    _rms_close(b["out"], a["out"])
    blk = gt.global_registry.create("RationalResampler", interp=3, decim=2)
    assert blk._kernel() is blk._kernel()           # built once


# -- filter blocks ------------------------------------------------------------------

@pytest.mark.parametrize("cx", [False, True])
def test_iq_demodulator_matches_jax(rng, cx):
    steps = [{"in": _data(rng, 4096, cx)} for _ in range(3)]
    a, b = _both("IQDemodulator", steps, 1024, fs=1e6, center_freq=123e3,
                 decim=4)
    assert b["out"].dtype == np.complex64
    _rms_close(b["out"], a["out"])


def test_lock_in_demodulator_matches_jax(rng):
    n, fs = 4 * 256, 48e3
    t = np.arange(3 * n) / fs
    ref = (np.sin(2 * np.pi * 1500 * t) + 0.01 * rng.standard_normal(3 * n))
    resp = 0.5 * np.sin(2 * np.pi * 1500 * t - 0.7) + 0.01 * rng.standard_normal(3 * n)
    steps = [{"ref": ref[i * n:(i + 1) * n].astype(np.float32),
              "resp": resp[i * n:(i + 1) * n].astype(np.float32)} for i in range(3)]
    for kw in ({}, {"phase_unit": "degrees", "invert_phase": True}):
        a, b = _both("LockInDemodulator", steps, 4, fs=fs, chunk=256, **kw)
        for p in ("amp", "phase", "freq"):
            np.testing.assert_allclose(b[p], a[p], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b["amp"], 0.5, rtol=0.02)


def test_decimator_basic_filters_match_jax(rng):
    steps = [{"in": _data(rng, 1024, cx)} for cx in (True, True)]
    a, b = _both("Decimator", steps, 256, decim=4)
    np.testing.assert_array_equal(b["out"], a["out"])
    steps = [{"in": _data(rng, 1024, False)} for _ in range(3)]
    for name, kw in (("BasicFilter", dict(f_low=100e3, ntaps=63)),
                     ("BasicFilter", dict(filter_type="bandpass", f_low=50e3,
                                          f_high=150e3, ntaps=49)),
                     ("BasicDecimatingFilter", dict(f_low=50e3, ntaps=31,
                                                    decim=4))):
        a, b = _both(name, steps, 1024 // kw.get("decim", 1), fs=1e6, **kw)
        _rms_close(b["out"], a["out"])


# -- math blocks --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Add", "Subtract", "Multiply", "Divide"])
@pytest.mark.parametrize("cx", [False, True])
def test_nary_blocks_match_jax(rng, name, cx):
    steps = [{f"in{i}": _data(rng, 512, cx) + (3 if i else 0) for i in range(3)}
             for _ in range(2)]
    a, b = _both(name, steps, 512, n_inputs=3)
    np.testing.assert_allclose(b["out"], a["out"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["AddConst", "SubtractConst", "MultiplyConst",
                                  "DivideConst"])
def test_const_blocks_match_jax_with_a_value_ramp(rng, name):
    x = _data(rng, 512, False)
    ramp = np.where(np.arange(512) < 200, 2.5, -1.25).astype(np.float32)
    out = []
    for pkg in (gr, gt):
        blk = pkg.global_registry.create(name, value=2.5)
        o, _ = _run(pkg, blk, [{"in": x}, {"in": x}], 512,
                    params_of=lambda i: {"value": ramp} if i else {})
        out.append(o["out"])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,cx", [("Abs", False), ("Abs", True),
                                     ("Conjugate", True), ("Log10", False),
                                     ("Log10", True)])
def test_unary_blocks_match_jax(rng, name, cx):
    x = _data(rng, 512, cx)
    x[:3] = 0
    a, b = _both(name, [{"in": x}], 512)
    assert a["out"].dtype == b["out"].dtype
    np.testing.assert_allclose(b["out"], a["out"], rtol=1e-6, atol=1e-5)


def test_uncertain_math_raises():
    for name in ("Add", "AddConst"):
        blk = gt.global_registry.create(name, uncertain=True)
        ins = {p.name: torch.zeros(8) for p in blk.in_ports}
        with pytest.raises(GrError, match="uncertain"):
            blk.apply(None, ins, _ctx(gt, 8, 8, {p: np.float32 for p in ins}))


# -- Rotator -------------------------------------------------------------------------

WRAP0 = (1 << 32) - 12345     # the start phase sits just below the 2³² wrap


def _rotator_run(pkg, settings, chunks, params_of=None):
    blk = pkg.global_registry.create("Rotator", **settings)
    st = jnp.uint32(WRAP0) if pkg is gr else torch.tensor(WRAP0)
    ctx = _ctx(pkg, 4096, 4096, {"in": np.complex64}, fs=1e6)
    blk.init_state(ctx)
    return _run(pkg, blk, [{"in": c} for c in chunks], 4096, fs=1e6,
                params_of=params_of, state0=st)


@pytest.mark.parametrize("settings", [
    dict(frequency_shift=-123456.7),
    dict(frequency_shift=400e3, initial_phase=0.4),
    dict(phase_increment=2.9, initial_phase=-1.1)])
def test_rotator_constant_matches_jax_across_the_wrap(rng, settings):
    chunks = [_data(rng, 4096, True) for _ in range(3)]
    (a, st_j), (b, st_t) = (_rotator_run(pkg, settings, chunks) for pkg in (gr, gt))
    np.testing.assert_allclose(b["out"], a["out"], atol=NCO_ATOL)
    assert int(st_t) == int(np.asarray(st_j))
    assert int(st_t) < WRAP0          # the phase wrapped past 2³²


def test_rotator_tag_ramp_matches_jax_across_the_wrap(rng):
    """A frequency_shift tag at sample 1000 of the second step: a per-sample
    uint32 increment array, continuous phase."""
    chunks = [_data(rng, 4096, True) for _ in range(3)]
    res = []
    for pkg in (gr, gt):
        blk = pkg.global_registry.create("Rotator", frequency_shift=-250e3)
        blk.init_state(_ctx(pkg, 4096, 4096, {"in": np.complex64}, fs=1e6))
        ramp = blk.tag_param_ramps([(1000, {"frequency_shift": 310e3})], 4096)
        res.append(_rotator_run(pkg, dict(frequency_shift=-250e3), chunks,
                                params_of=lambda i: ramp if i == 1 else {}))
    (a, st_j), (b, st_t) = res
    np.testing.assert_allclose(b["out"], a["out"], atol=NCO_ATOL)
    assert int(st_t) == int(np.asarray(st_j))


def test_rotator_xor_and_cpu_launch_count(rng):
    with pytest.raises(GrError, match="XOR"):
        gt.global_registry.create("Rotator", frequency_shift=1.0,
                                  phase_increment=0.1)
    ck.reset_launch_counts()
    _rotator_run(gt, dict(frequency_shift=1e3), [_data(rng, 4096, True)])
    assert ck.launch_counts()["nco_mix"] == 0      # the plain version on the CPU


# -- Fourier ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "xla", "matmul_exact"])
@pytest.mark.parametrize("n", [256, 4096, 32])
def test_ifft_matches_jax(rng, engine, n):
    x = _data(rng, 2 * 4096, True)
    a, b = _both("IFFT", [{"in": x}], x.size, fft_size=n, engine=engine)
    np.testing.assert_allclose(b["out"], a["out"],
                               atol=SPEC_RTOL * np.max(np.abs(a["out"])))
    np.testing.assert_allclose(b["out"].reshape(-1, n),
                               np.fft.ifft(x.reshape(-1, n)), atol=1e-5)


@pytest.mark.parametrize("output", ["complex", "magnitude"])
@pytest.mark.parametrize("cx", [False, True])
def test_fft_matmul_exact_matches_jax(rng, output, cx):
    x = _data(rng, 3 * 1024, cx)
    a, b = _both("FFT", [{"in": x}], x.size, fft_size=1024, window="Hann",
                 output=output, engine="matmul_exact")
    np.testing.assert_allclose(b["out"], a["out"],
                               atol=SPEC_RTOL * np.max(np.abs(a["out"])))


@pytest.mark.parametrize("name", ["FFT", "IFFT"])
@pytest.mark.parametrize("engine", ["matmul", "matmul_bf16"])
def test_fft_lower_rungs_raise(rng, name, engine):
    """The lower rungs of the matmul FFT are ported now: they no longer
    raise, and agree with the JAX package (tests/test_torch_precision.py
    holds them at other sizes and against float64)."""
    x = _data(rng, 2 * 256, True)
    kw = dict(window="none", output="complex") if name == "FFT" else {}
    a, b = _both(name, [{"in": x}], x.size, fft_size=256, engine=engine, **kw)
    np.testing.assert_allclose(b["out"], a["out"],
                               atol=1e-6 * np.max(np.abs(a["out"])))


# -- channel plumbing -------------------------------------------------------------------

def test_channel_blocks_match_jax(rng):
    x = _data(rng, (4, 256), True)
    for name, kw, ins, n_out in (
            ("ChannelSelect", dict(channel=2), x, 256),
            ("StreamToChannels", dict(n_channels=4), x.reshape(-1), 256),
            ("ChannelsToStream", dict(n_channels=4), x, 1024)):
        a, b = _both(name, [{"in": ins}, {"in": ins * 2}], n_out, **kw)
        np.testing.assert_array_equal(b["out"], a["out"])
    blk = gt.global_registry.create("ChannelSelect", channel=5)
    with pytest.raises(GrError, match="out of range"):
        blk.apply(None, {"in": torch.from_numpy(x)},
                  _ctx(gt, 256, 256, {"in": np.complex64}, channels=4))


# -- streams handed from the JAX package to the port -----------------------------------

def _resample_rotate(pkg):
    g = pkg.Graph()
    src = g.emplace("NoiseSource", noise="complex_gaussian", seed=3)
    rr = g.emplace("RationalResampler", interp=3, decim=2)
    rot = g.emplace("Rotator", frequency_shift=-70e3)
    iq = g.emplace("IQDemodulator", center_freq=50e3, decim=3)
    snk = g.emplace("NullSink")
    g.connect_chain(src, rr, rot, iq, snk)
    return g


def test_resampler_and_rotator_continue_from_jax_states():
    """One step in the JAX package, the states (the noise key, the
    resampler's history, the Rotator's uint32 phase, IQDemodulator's
    history and phase) carried across, two more steps in the port: equal to
    three steps in the JAX package."""
    bl = 4096
    cj = gr.compile_graph(_resample_rotate(gr), block_len=bl, sample_rate=1e6)
    ct = gt.compile_graph(_resample_rotate(gt), block_len=bl, sample_rate=1e6,
                          device="cpu")
    names = {bj.unique_name: bt.unique_name for bj, bt in zip(cj.order, ct.order)}
    st_j = cj.init_states()
    ct.init_states()
    st_j, _ = cj.step(st_j, cj.gather_params(), {})
    tree = jax.tree_util.tree_map(
        lambda v: np.asarray(jax.random.key_data(v))
        if jnp.issubdtype(v.dtype, jax.dtypes.prng_key) else np.asarray(v), st_j)
    st_t = states_from_numpy(tree, "cpu", names)
    rot_t = next(b for b in ct.order if type(b).__name__ == "Rotator")
    assert st_t[rot_t.unique_name].dtype == torch.int64
    params_t = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, cj.gather_params()), names)
    for _ in range(2):
        st_j, out_j = cj.step(st_j, cj.gather_params(), {})
        st_t, out_t = ct.step(st_t, params_t)
        for uj, ut in names.items():
            if uj in out_j:
                _rms_close(out_t[ut]["in"].numpy(), np.asarray(out_j[uj]["in"]),
                           1e-4)
