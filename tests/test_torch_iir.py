"""Parity of the port's IIR family against the JAX package, on the CPU: the ops
of ops/iir.py, the plain version of the ``iir_sos`` kernel against the JAX
package's Pallas kernel in interpret mode, and the IirFilter and FmDeemphasis
blocks over three steps with their state carried.

The same inputs, made from a NumPy seed, go through both packages. Tolerances
are stated relative to the output's RMS: both sides run f32 recursions in the
same update order, but XLA and PyTorch round the products and sums at
different places, and the O(log T) scans combine in different trees.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio4_tpu.core.block import BlockCtx as JBlockCtx
from gnuradio4_tpu.blocks.filter import IirFilter as JIirFilter
from gnuradio4_tpu.blocks.sdr import FmDeemphasis as JFmDeemphasis
from gnuradio4_tpu.ops import iir as jiir
from gnuradio4_tpu.ops import filter_design as jfd
from gnuradio4_tpu.ops.demod import fm_deemphasis_coeffs as j_deemph_coeffs
from gnuradio4_tpu.ops.pallas_kernels import iir_sos_pallas

from gnuradio4_tpu_torch.core.block import BlockCtx as TBlockCtx
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.blocks.filter import IirFilter as TIirFilter
from gnuradio4_tpu_torch.blocks.sdr import FmDeemphasis as TFmDeemphasis
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import iir as tiir
from gnuradio4_tpu_torch.ops import filter_design as tfd
from gnuradio4_tpu_torch.ops.demod import am_demod, fm_deemphasis_coeffs

torch.set_num_threads(2)

# f32 recursions in the same order on both sides: a few ulps of the signal
SEQ_RTOL = 1e-5
# O(log T) scans and blocked matmuls combine in different orders
PAR_RTOL = 1e-4


def _close(got, want, rtol):
    """max|got − want| ≤ rtol·max(RMS(want), 1e-3)."""
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.sqrt(np.mean(np.abs(want) ** 2))), 1e-3)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _bw(order, fs=100.0, fc=10.0):
    return tfd.design_iir("butterworth", "lowpass", order, sample_rate=fs,
                          f_low=fc)


# a section with two distinct real poles (0.5, 0.4) and a cascade with it
REAL_POLES_SOS = np.array([[1.0, 0.5, 0.2, 1.0, -0.9, 0.2]])


# -- direct form and cascade, loops over time ------------------------------------

@pytest.mark.parametrize("shape", [(256,), (3, 256)])
def test_iir_apply_matches_jax_streamed(rng, shape):
    res = _bw(4)
    x = rng.standard_normal((*shape[:-1], 4 * shape[-1])).astype(np.float32)
    ch = shape[0] if len(shape) == 2 else 0
    sj = jiir.iir_init_state(ch, len(res.b), len(res.a))
    st = tiir.iir_init_state(ch, len(res.b), len(res.a))
    assert tuple(st.shape) == tuple(sj.shape)
    yj, yt = [], []
    for chunk in np.split(x, 4, axis=-1):
        a, sj = jiir.iir_apply(jnp.asarray(chunk), res.b, res.a, sj)
        b, st = tiir.iir_apply(torch.from_numpy(chunk), res.b, res.a, st)
        yj.append(np.asarray(a))
        yt.append(b.numpy())
    _close(np.concatenate(yt, -1), np.concatenate(yj, -1), SEQ_RTOL)
    _close(st.numpy(), np.asarray(sj), SEQ_RTOL)


@pytest.mark.parametrize("scale", [1.0, 3.0])      # 3.0: a0 != 1 in every row
@pytest.mark.parametrize("ch", [0, 3])
def test_sos_apply_matches_jax(rng, ch, scale):
    sos = _bw(4).sos * scale
    shape = (256,) if ch == 0 else (ch, 256)
    x = rng.standard_normal(shape).astype(np.float32)
    s0 = rng.standard_normal((*shape[:-1], sos.shape[0], 2)).astype(np.float32)
    yj, sj = jiir.sos_apply(jnp.asarray(x), sos, jnp.asarray(s0))
    yt, st = tiir.sos_apply(torch.from_numpy(x), sos, torch.from_numpy(s0))
    _close(yt.numpy(), np.asarray(yj), SEQ_RTOL)
    _close(st.numpy(), np.asarray(sj), SEQ_RTOL)


# -- the iir_sos kernel's plain version against the Pallas kernel ----------------

def test_iir_sos_ref_matches_pallas_butterworth4_c8(rng):
    """tests/test_pallas_kernels.py:20-32: Butterworth 4 at C = 8."""
    res = jfd.design_iir("butterworth", "lowpass", 4, sample_rate=100.0,
                         f_low=10.0)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    s0 = jiir.sos_init_state(8, res.sos.shape[0])
    yj, sj = jax.jit(lambda v, s: iir_sos_pallas(v, res.sos, s, interpret=True))(
        jnp.asarray(x), s0)
    yt, st = ck.iir_sos_ref(torch.from_numpy(x), res.sos,
                            tiir.sos_init_state(8, res.sos.shape[0]))
    _close(yt.numpy(), np.asarray(yj), SEQ_RTOL)
    _close(st.numpy(), np.asarray(sj), SEQ_RTOL)


def test_iir_sos_ref_matches_pallas_chebyshev_two_chunks(rng):
    """tests/test_pallas_kernels.py:34-48: Chebyshev 1, state carried over
    two chunks, equal to one pass."""
    res = jfd.design_iir("chebyshev1", "lowpass", 2, sample_rate=50.0, f_low=5.0)
    x = rng.standard_normal(512).astype(np.float32)
    kern = jax.jit(lambda v, s: iir_sos_pallas(v, res.sos, s, interpret=True))
    sj = jiir.sos_init_state(0, res.sos.shape[0])
    st = tiir.sos_init_state(0, res.sos.shape[0])
    yj, yt = [], []
    for chunk in x.reshape(2, 256):
        a, sj = kern(jnp.asarray(chunk), sj)
        b, st = ck.iir_sos(torch.from_numpy(chunk), res.sos, st)   # CPU → ref
        yj.append(np.asarray(a))
        yt.append(b.numpy())
    one, _ = ck.iir_sos_ref(torch.from_numpy(x), res.sos,
                            tiir.sos_init_state(0, res.sos.shape[0]))
    _close(np.concatenate(yt), np.concatenate(yj), SEQ_RTOL)
    _close(np.concatenate(yt), one.numpy(), SEQ_RTOL)
    _close(st.numpy(), np.asarray(sj), SEQ_RTOL)


def test_iir_sos_ref_matches_scipy_float64(rng):
    """The plain version against scipy's float64 sosfilt: f32 rounding of a
    stable low-pass settles, so the error stays at the f32 level of the RMS."""
    signal = pytest.importorskip("scipy.signal")
    sos = tfd.design_iir("butterworth", "lowpass", 5, sample_rate=48e3,
                         f_low=15e3).sos
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y, _ = ck.iir_sos_ref(torch.from_numpy(x), sos,
                          tiir.sos_init_state(2, sos.shape[0]))
    want = signal.sosfilt(sos, x.astype(np.float64), axis=-1)
    _close(y.numpy().astype(np.float64), want, SEQ_RTOL)


# -- one-pole recurrences, both lowerings ----------------------------------------

def _pole_case(rng, t, ch, complex_pole):
    shape = (t,) if ch == 0 else (ch, t)
    if complex_pole:
        pole = 0.97 * np.exp(0.3j)
        x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
             ).astype(np.complex64)
        y0 = np.asarray(rng.standard_normal(shape[:-1])
                        + 1j * rng.standard_normal(shape[:-1]), np.complex64)
    else:
        pole = 0.95
        x = rng.standard_normal(shape).astype(np.float32)
        y0 = np.asarray(rng.standard_normal(shape[:-1]), np.float32)
    return pole, x, y0


@pytest.mark.parametrize("complex_pole", [False, True])
@pytest.mark.parametrize("ch", [0, 2])
@pytest.mark.parametrize("t,blocked", [(8192, True), (8191, False), (128, False)])
def test_one_pole_apply_matches_jax(rng, monkeypatch, t, blocked, ch,
                                    complex_pole):
    """T = 8192 takes the blocked Toeplitz path on both sides, 8191 and 128
    the associative scan."""
    pole, x, y0 = _pole_case(rng, t, ch, complex_pole)
    calls = []
    real_blocked = tiir._one_pole_blocked
    monkeypatch.setattr(tiir, "_one_pole_blocked",
                        lambda *a: calls.append(1) or real_blocked(*a))
    yj, lj = jiir.one_pole_apply(jnp.asarray(x), pole, jnp.asarray(y0))
    yt, lt = tiir.one_pole_apply(torch.from_numpy(x), pole, torch.from_numpy(y0))
    assert len(calls) == int(blocked)
    _close(yt.numpy(), np.asarray(yj), PAR_RTOL)
    _close(lt.numpy(), np.asarray(lj), PAR_RTOL)


def test_one_pole_blocked_switch_takes_the_scan(rng, monkeypatch):
    """GR4TPU_NO_BLOCKED_ONEPOLE=1 sends a blocked-eligible length to the scan
    in both packages; both lowerings agree with the sequential recurrence."""
    pole, x, y0 = _pole_case(rng, 8192, 0, False)
    want = np.empty(8192)
    acc = float(y0)
    for n, v in enumerate(x.astype(np.float64)):
        acc = pole * acc + v
        want[n] = acc
    blocked, _ = tiir.one_pole_apply(torch.from_numpy(x), pole, torch.from_numpy(y0))
    monkeypatch.setenv("GR4TPU_NO_BLOCKED_ONEPOLE", "1")
    calls = []
    real_blocked = tiir._one_pole_blocked
    monkeypatch.setattr(tiir, "_one_pole_blocked",
                        lambda *a: calls.append(1) or real_blocked(*a))
    scanned, _ = tiir.one_pole_apply(torch.from_numpy(x), pole, torch.from_numpy(y0))
    yj, _ = jiir.one_pole_apply(jnp.asarray(x), pole, jnp.asarray(y0))
    assert not calls
    _close(scanned.numpy(), np.asarray(yj), PAR_RTOL)
    for y in (blocked, scanned):
        _close(y.numpy().astype(np.float64), want, PAR_RTOL)


@pytest.mark.parametrize("ch", [0, 2])
@pytest.mark.parametrize("t", [8192, 8191])
def test_one_pole_ba_apply_streamed_matches_jax(rng, t, ch):
    """FM de-emphasis coefficients at 50 kHz, three chunks with the carry."""
    b, a = fm_deemphasis_coeffs(50e3, 75e-6)
    bj, aj = j_deemph_coeffs(50e3, 75e-6)
    np.testing.assert_array_equal(b, bj)
    np.testing.assert_array_equal(a, aj)
    shape = (t,) if ch == 0 else (ch, t)
    uj = jnp.zeros(shape[:-1], jnp.float32)
    ut = torch.zeros(shape[:-1])
    yj, yt = [], []
    for _ in range(3):
        x = rng.standard_normal(shape).astype(np.float32)
        a_, uj = jiir.one_pole_ba_apply(jnp.asarray(x), b, a, uj)
        b_, ut = tiir.one_pole_ba_apply(torch.from_numpy(x), b, a, ut)
        yj.append(np.asarray(a_))
        yt.append(b_.numpy())
    _close(np.concatenate(yt, -1), np.concatenate(yj, -1), PAR_RTOL)
    _close(ut.numpy(), np.asarray(uj), PAR_RTOL)


def test_one_pole_ba_apply_without_feedback_matches_jax(rng):
    x = rng.standard_normal(300).astype(np.float32)
    yj, lj = jiir.one_pole_ba_apply(jnp.asarray(x), [0.5, 0.25], [1.0],
                                    jnp.float32(0.7))
    yt, lt = tiir.one_pole_ba_apply(torch.from_numpy(x), [0.5, 0.25], [1.0],
                                    torch.tensor(0.7))
    _close(yt.numpy(), np.asarray(yj), SEQ_RTOL)
    assert float(lt) == float(lj)


# -- the parallel biquad cascade -------------------------------------------------

@pytest.mark.parametrize("sos_kind", ["conjugate", "real", "mixed"])
@pytest.mark.parametrize("t", [8192, 1000])
def test_sos_parallel_apply_matches_jax(rng, sos_kind, t):
    conj = _bw(4).sos
    sos = {"conjugate": conj, "real": REAL_POLES_SOS,
           "mixed": np.concatenate([conj, REAL_POLES_SOS])}[sos_kind]
    assert tiir.sos_supports_parallel(sos)
    x = rng.standard_normal((2, t)).astype(np.float32)
    s0 = (rng.standard_normal((2, sos.shape[0]))
          + 1j * rng.standard_normal((2, sos.shape[0]))).astype(np.complex64) * 0.1
    yj, sj = jiir.sos_parallel_apply(jnp.asarray(x), sos, jnp.asarray(s0))
    yt, st = tiir.sos_parallel_apply(torch.from_numpy(x), sos, torch.from_numpy(s0))
    _close(yt.numpy(), np.asarray(yj), PAR_RTOL)
    _close(st.numpy(), np.asarray(sj), PAR_RTOL)
    assert tuple(tiir.sos_parallel_init_state(2, sos.shape[0]).shape) == \
        tuple(jiir.sos_parallel_init_state(2, sos.shape[0]).shape)


@pytest.mark.parametrize("sos", [
    _bw(4).sos, _bw(5).sos, REAL_POLES_SOS,
    np.array([[1.0, 0.0, 0.0, 1.0, -1.0, 0.25]]),          # repeated pole 0.5
    np.array([[1.0, 0.0, 0.0, 1.0, -1.0, 0.25 - 1e-9]]),   # near-repeated
    np.array([[1.0, 0.0, 0.0, 2.0, -1.0, 0.4]]),           # a0 = 2
], ids=["bw4", "bw5", "real", "repeated", "near-repeated", "a0"])
def test_sos_supports_parallel_matches_jax(sos):
    assert tiir.sos_supports_parallel(sos) == jiir.sos_supports_parallel(sos)


def test_biquad_parallel_apply_refuses_what_jax_refuses():
    x = torch.zeros(16)
    for row in (_bw(5).sos[0], np.array([1.0, 0.0, 0.0, 1.0, -1.0, 0.25])):
        with pytest.raises(ValueError):
            jiir.biquad_parallel_apply(jnp.zeros(16), row, jnp.complex64(0))
        with pytest.raises(ValueError):
            tiir.biquad_parallel_apply(x, row, torch.zeros((), dtype=torch.complex64))


def test_am_demod_matches_jax(rng):
    from gnuradio4_tpu.ops.demod import am_demod as j_am_demod
    x = (rng.standard_normal(500) + 1j * rng.standard_normal(500)).astype(np.complex64)
    _close(am_demod(torch.from_numpy(x), gain=2.5).numpy(),
           np.asarray(j_am_demod(jnp.asarray(x), gain=2.5)), SEQ_RTOL)


# -- blocks over three steps --------------------------------------------------------

def _run_both(make, chunks, ch, fs, rtol):
    """Build the block in both packages with ``make(pkg_is_jax)``, run it over
    ``chunks`` with the state carried, and compare outputs and states."""
    n = chunks[0].shape[-1]
    ctx = dict(in_len={"in": n}, out_len={"out": n}, sample_rate=fs, params={},
               channels={"in": ch, "out": ch}, dtypes={"in": np.dtype(np.float32)})
    bj, bt = make(True), make(False)
    cj, ct = JBlockCtx(**ctx), TBlockCtx(**ctx)
    sj, st = bj.init_state(cj), bt.init_state(ct)
    assert tuple(st.shape) == tuple(np.shape(sj))
    assert str(st.dtype).split(".")[-1] == np.asarray(sj).dtype.name
    yj, yt = [], []
    for x in chunks:
        sj, oj = bj.apply(sj, {"in": jnp.asarray(x)}, cj)
        st, ot = bt.apply(st, {"in": torch.from_numpy(x)}, ct)
        yj.append(np.asarray(oj["out"]))
        yt.append(ot["out"].numpy())
    _close(np.concatenate(yt, -1), np.concatenate(yj, -1), rtol)
    _close(st.numpy(), np.asarray(sj), rtol)


def _chunks(rng, ch, n, k=3):
    shape = (n,) if ch == 0 else (ch, n)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("ch", [0, 4])
@pytest.mark.parametrize("engine,order,n", [
    ("scan", 4, 512), ("scan", 5, 512), ("pallas", 4, 512), ("pallas", 5, 512),
    ("parallel", 4, 512), ("parallel", 4, 4096), ("auto", 5, 512)])
def test_iir_filter_block_matches_jax(rng, engine, order, n, ch):
    """IirFilter built in both packages from the same (b, a); "auto" is the
    scan on the CPU in both. "parallel" needs every section second order,
    so only the even design runs it; n = 4096 takes its blocked path."""
    res = tfd.design_iir("butterworth", "lowpass", order, sample_rate=48e3,
                         f_low=15e3)
    make = lambda jax_side: (JIirFilter if jax_side else TIirFilter)(
        b=res.b, a=res.a, engine=engine)
    rtol = PAR_RTOL if engine == "parallel" else SEQ_RTOL
    _run_both(make, _chunks(rng, ch, n), ch, 48e3, rtol)


def test_iir_filter_auto_engine_follows_the_device():
    """On a CUDA device "auto" takes the reference's accelerator rule: the
    parallel form when every section allows it, else the biquad-cascade
    kernel; on the CPU the scan. Decided from the device alone."""
    for order, on_card in ((5, "pallas"), (4, "parallel")):
        res = tfd.design_iir("butterworth", "lowpass", order, sample_rate=48e3,
                             f_low=15e3)
        blk = TIirFilter(b=res.b, a=res.a)
        assert blk._engine(torch.device("cuda")) == on_card
        assert blk._engine(torch.device("cpu")) == "scan"
    assert TIirFilter(b=res.b, a=res.a, engine="pallas")._engine(
        torch.device("cpu")) == "pallas"


def test_iir_filter_pallas_engine_on_cpu_counts_no_launch(rng):
    ck.reset_launch_counts()
    res = _bw(5, 48e3, 15e3)
    _run_both(lambda j: (JIirFilter if j else TIirFilter)(
        b=res.b, a=res.a, engine="pallas"), _chunks(rng, 2, 256, 2), 2, 48e3,
        SEQ_RTOL)
    assert ck.iir_sos.launches == 0


def test_iir_filter_uncertain_is_not_ported():
    """The uncertain mode is ported now (tests/test_torch_uncertain.py): its
    state is the JAX package's pair of scalar loop states {"v", "s2"}, and a
    stream that is not the 2-plane (value, sigma) pair is refused, naming the
    mode."""
    blk = TIirFilter(b=(1.0,), a=(1.0, -0.5), uncertain=True)
    ctx = TBlockCtx(in_len={"in": 8}, out_len={"out": 8}, sample_rate=1.0,
                    params={}, channels={"in": 0, "out": 0})
    state = blk.init_state(ctx)
    assert sorted(state) == ["s2", "v"] and state["v"].shape == (1,)
    with pytest.raises(GrError, match="uncertain"):
        blk.apply(state, {"in": torch.zeros(8)}, ctx)


@pytest.mark.parametrize("ch", [0, 4])
@pytest.mark.parametrize("n", [8192, 8191])
def test_fm_deemphasis_block_matches_jax(rng, n, ch):
    """FmDeemphasis at 50 kHz: n = 8192 takes the blocked one-pole path, 8191
    the scan; the carried state is the one-pole's last value."""
    make = lambda j: (JFmDeemphasis if j else TFmDeemphasis)(
        tau=75e-6, sample_rate_in=50e3)
    _run_both(make, _chunks(rng, ch, n), ch, 50e3, PAR_RTOL)


def test_registry_settings_of_the_new_blocks_match_jax():
    import gnuradio4_tpu as gr
    import gnuradio4_tpu_torch as gt
    for name in ("IirFilter", "FmDeemphasis"):
        bj = gr.global_registry.create(name)
        bt = gt.global_registry.create(name)
        assert sorted(bj.settings.keys()) == sorted(bt.settings.keys()), name
        assert bj.settings.as_dict() == bt.settings.as_dict(), name
