"""Parity of the PyTorch port's ops and kernel plain versions against the JAX
package, on the CPU.

The same inputs, made from a NumPy seed, go through the JAX function (its Pallas
kernels in interpret mode where it has them) and the port's counterpart.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gnuradio4_tpu.ops import fir as jfir
from gnuradio4_tpu.ops import signal as jsig
from gnuradio4_tpu.ops.demod import quadrature_demod as j_quad_demod
from gnuradio4_tpu.ops.pallas_kernels import fir_ilv_pallas, nco_mix_pallas

from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import signal as tsig
from gnuradio4_tpu_torch.ops.demod import quadrature_demod
from gnuradio4_tpu_torch.ops.fir import fir_apply, fir_init_state

torch.set_num_threads(2)

# f32 accumulation over K ≤ 127 taps of unit-variance samples (the JAX
# package's own Pallas FIR tests use the same bound)
FIR_ATOL = 2e-4


def _cx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _taps(rng, k, complex_taps):
    t = rng.standard_normal(k) / np.sqrt(k)
    if complex_taps:
        t = t * np.exp(1j * rng.uniform(0, 2 * np.pi, k))
        return t.astype(np.complex64)
    return t.astype(np.float32)


def _port_fir(x, hist, taps, decim):
    y = ck.fir_banded(torch.from_numpy(x), torch.from_numpy(hist), taps, decim)
    return y.numpy()


# -- banded FIR ----------------------------------------------------------------

FIR_CASES = [(127, 1, False), (127, 1, True), (31, 1, False), (31, 1, True)]


@pytest.mark.parametrize("k,decim,cx_taps", FIR_CASES)
def test_fir_banded_ref_matches_pallas_planar(rng, k, decim, cx_taps):
    """Against JAX fir_apply(method='pallas') → fir_planar_pallas (interpret)."""
    taps = _taps(rng, k, cx_taps)
    x = _cx(rng, 4096)
    hist = _cx(rng, k - 1)
    y_j, _ = jax.jit(lambda v, st: jfir.fir_apply(
        v, taps, st, decim=decim, method="pallas"))(jnp.asarray(x),
                                                    jnp.asarray(hist))
    y_t = _port_fir(x, hist, taps, decim)
    assert y_t.shape == (4096 // decim,)
    np.testing.assert_allclose(y_t, np.asarray(y_j), atol=FIR_ATOL)


@pytest.mark.parametrize("k,decim,cx_taps", FIR_CASES)
def test_fir_banded_ref_matches_pallas_ilv(rng, k, decim, cx_taps):
    """Against fir_ilv_pallas(interpret=True) fed by the JAX package's
    _ilv_prep (interleaved f32 rows of the history-prefixed stream)."""
    taps = _taps(rng, k, cx_taps)
    x = _cx(rng, 4096)
    hist = _cx(rng, k - 1)
    xc = jnp.asarray(np.concatenate([hist, x]))[None, :]
    z, w_lo, w_hi, n, n_out, tile = jfir._ilv_prep(xc, np.asarray(taps), decim)
    out = fir_ilv_pallas(z.reshape(n + 1, 2 * tile), w_lo, w_hi, interpret=True)
    y_j = np.asarray(out).reshape(-1)[: 2 * n_out].view(np.complex64)
    y_t = _port_fir(x, hist, taps, decim)
    np.testing.assert_allclose(y_t, y_j, atol=FIR_ATOL)


@pytest.mark.parametrize("cx_taps", [False, True])
def test_fir_apply_state_carry_two_chunks(rng, cx_taps):
    """Two chunks through the port's fir_apply with the carried history equal
    one pass of the JAX Pallas FIR over the whole stream."""
    k = 127
    taps = _taps(rng, k, cx_taps)
    x = _cx(rng, 8192)
    y_j, st_j = jax.jit(lambda v, st: jfir.fir_apply(
        v, taps, st, method="pallas"))(
        jnp.asarray(x), jfir.fir_init_state(0, k, jnp.complex64))
    st = fir_init_state(0, k, np.complex64)
    parts = []
    for chunk in x.reshape(2, 4096):
        y, st = fir_apply(torch.from_numpy(chunk), taps, st)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(y_j),
                               atol=FIR_ATOL)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))


def test_audio_fir_real_stream_decim8_vs_jax_matmul(rng):
    """The chain's audio FIR: real stream, real taps, K=63, ÷8. The JAX
    package's Pallas FIR needs a complex stream, so its method='pallas' takes
    the XLA banded matmul here; compare against method='matmul' by name."""
    k, decim = 63, 8
    taps = _taps(rng, k, False)
    x = rng.standard_normal(8192).astype(np.float32)
    hist = rng.standard_normal(k - 1).astype(np.float32)
    y_j, st_j = jax.jit(lambda v, st: jfir.fir_apply(
        v, taps, st, decim=decim, method="matmul"))(jnp.asarray(x),
                                                    jnp.asarray(hist))
    y_t, st_t = fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                          decim=decim)
    assert y_t.dtype == torch.float32 and y_t.shape == (8192 // decim,)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=FIR_ATOL)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


@pytest.mark.parametrize("x_cx,cx_taps,decim,shape", [
    (True, False, 2, (3, 5000)),       # multi-channel, ragged T
    (False, True, 1, (4096,)),         # real stream, complex taps stays real
    (True, True, 4, (2, 4099)),
    (False, False, 8, (4099,)),
])
def test_fir_apply_matches_jax_matmul(rng, x_cx, cx_taps, decim, shape):
    k = 63
    taps = _taps(rng, k, cx_taps)
    x = _cx(rng, *shape) if x_cx else rng.standard_normal(shape).astype(np.float32)
    hist = np.zeros((*shape[:-1], k - 1), x.dtype)
    y_j, st_j = jax.jit(lambda v, st: jfir.fir_apply(
        v, taps, st, decim=decim, method="matmul"))(jnp.asarray(x),
                                                    jnp.asarray(hist))
    y_t, st_t = fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                          decim=decim)
    assert y_t.shape == tuple(np.asarray(y_j).shape)
    assert st_t.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=FIR_ATOL)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


@pytest.mark.parametrize("t,k,decim", [(7, 63, 8), (40, 63, 1), (1, 127, 1),
                                       (100, 63, 3), (0, 5, 1)])
def test_fir_banded_ref_short_streams(rng, t, k, decim):
    """Streams shorter than one tile, down to T < K−1 (where the JAX package's
    _fir_matmul fails), against the direct sum in float64."""
    taps = _taps(rng, k, False)
    x = rng.standard_normal(t).astype(np.float32)
    hist = rng.standard_normal(k - 1).astype(np.float32)
    y = _port_fir(x, hist, taps, decim)
    xc = np.concatenate([hist, x]).astype(np.float64)
    ref = np.array([np.dot(taps[::-1], xc[m * decim: m * decim + k])
                    for m in range(t // decim)])
    assert y.shape == (t // decim,)
    np.testing.assert_allclose(y, ref.reshape(y.shape), atol=FIR_ATOL)


@pytest.mark.parametrize("t", [3 * 5120, 3 * 5120 + 297])
def test_fir_banded_ref_long_decimating_filter_vs_float64(rng, t):
    """fm_monitor's channel filter shape, complex stream and complex taps, K
    963, ÷40, with history, over whole tiles of the plain version and a
    ragged stream: against the direct-form decimating sum in float64. The
    card's tests hold the kernel's phase-grouped loop to this plain version."""
    k, decim = 963, 40
    taps = _taps(rng, k, True)
    x, hist = _cx(rng, t), _cx(rng, k - 1)
    y = _port_fir(x, hist, taps, decim)
    xc = np.concatenate([hist, x]).astype(np.complex128)
    rows = np.lib.stride_tricks.sliding_window_view(xc, k)[::decim][: t // decim]
    ref = rows @ taps.astype(np.complex128)[::-1]
    assert y.shape == (t // decim,) and y.dtype == np.complex64
    np.testing.assert_allclose(y, ref, atol=FIR_ATOL)


def test_fir_apply_rejects_unported_rungs_and_methods(rng):
    """The rungs and ``matmul_int8`` are ported now and agree with the JAX
    package (tests/test_torch_precision.py holds every combination); an
    unknown method still raises, naming it."""
    xn = _cx(rng, 256)
    x = torch.from_numpy(xn)
    st = fir_init_state(0, 5, np.complex64)
    taps = np.ones(5, np.float32)
    for kw in [dict(precision=r) for r in ("bf16", "int8", "high", "default")
               ] + [dict(method="matmul_int8")]:
        want, _ = jfir.fir_apply(jnp.asarray(xn), taps,
                                 jnp.zeros(4, jnp.complex64), **kw)
        got, _ = fir_apply(x, taps, st, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6 * np.abs(np.asarray(want)).max())
    with pytest.raises(GrError, match="winograd"):
        fir_apply(x, taps, st, method="winograd")


def test_fir_banded_ref_refuses_tf32(rng):
    x = torch.from_numpy(_cx(rng, 256))
    st = fir_init_state(0, 5, np.complex64)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(GrError, match="full float32"):
            ck.fir_banded_ref(x, st, np.ones(5, np.float32))
    finally:
        torch.set_float32_matmul_precision("highest")


def test_device_constant_uploads_once():
    """A read-only host constant is uploaded once and found again by identity;
    a writable one is keyed by its content, so an edit in place is seen."""
    w = ck.frozen(np.arange(12, dtype=np.float32).reshape(3, 4))
    t = ck.device_constant(w, "cpu")
    assert ck.device_constant(w, torch.device("cpu")) is t
    np.testing.assert_array_equal(t.numpy(), w)
    taps = np.ones(5, np.float32)
    first = ck.device_constant(taps, "cpu").clone()
    taps[2] = 7.0
    again = ck.device_constant(taps, "cpu")
    assert float(first[2]) == 1.0 and float(again[2]) == 7.0


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device reaches no plain
    version: the wrapper raises, and no launch is counted."""
    ck.reset_launch_counts()
    x = torch.empty(256, dtype=torch.complex64, device="meta")
    h = torch.empty(4, dtype=torch.complex64, device="meta")
    with pytest.raises(GrError, match="CUDA"):
        ck.fir_banded(x, h, np.ones(5, np.float32))
    with pytest.raises(GrError, match="CUDA"):
        ck.nco_mix(x, 0, 1)
    with pytest.raises(GrError, match="CUDA"):
        ck.iir_sos(x.real, np.array([[1.0, 0, 0, 1.0, 0.5, 0]]),
                   torch.empty(1, 2, device="meta"))
    with pytest.raises(GrError, match="CUDA"):
        ck.fir_demod(x, np.ones(5, np.float32), 1, h[0], 1.0)
    assert ck.launch_counts() == dict.fromkeys(
        ("fir_banded", "nco_mix", "iir_sos", "fir_demod", "one_pole",
         "fir_banded.phase_groups"), 0)


# -- integer NCO ---------------------------------------------------------------

def test_nco_phases_match_jax_uint32():
    phase0, dphi = 0xFFFFFF00, 0x9E3779B9
    got = tsig.nco_phases(phase0, dphi, 5000).numpy()
    want = np.asarray(jsig.nco_phases(jnp.uint32(phase0), jnp.uint32(dphi), 5000))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n", [4096, 5000])   # factored (n % 1024 == 0) / direct
@pytest.mark.parametrize("phase0", [0, 0xFFFFF000])
def test_complex_exp_ramp_matches_jax(n, phase0):
    """Both forms of the ramp, including a start phase just below the 2³² wrap;
    tolerance: f32 sin/cos rounding (≤ 1e-5)."""
    dphi = int(jsig.phase_increment(-3e6, 20e6))
    want = np.asarray(jsig.complex_exp_ramp(np.uint32(phase0), np.uint32(dphi), n,
                                            amplitude=0.75))
    got = tsig.complex_exp_ramp(phase0, dphi, n, amplitude=0.75).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_complex_exp_ramp_phase_continuity_across_wrap():
    """Chunked ramps with the carried phase equal the one-shot ramp, across
    several 2³² wraps."""
    dphi = int(jsig.phase_increment(7.3e6, 20e6))
    phase, parts = 0xFFFFFF00, []
    for _ in range(4):
        parts.append(tsig.complex_exp_ramp(phase, dphi, 2048).numpy())
        phase = (phase + 2048 * dphi) & tsig.MASK32
    one = tsig.complex_exp_ramp(0xFFFFFF00, dphi, 8192).numpy()
    np.testing.assert_array_equal(np.concatenate(parts), one)


@pytest.mark.parametrize("n", [4096, 3000])
def test_nco_rotate_matches_jax(rng, n):
    x = _cx(rng, 2, n)
    dphi = int(jsig.phase_increment(1.1e6, 20e6))
    want = np.asarray(jsig.nco_rotate(jnp.asarray(x), np.uint32(0xFFFF0000),
                                      np.uint32(dphi)))
    got = tsig.nco_rotate(torch.from_numpy(x), 0xFFFF0000, dphi).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(4096,), (3, 1000)])
def test_nco_mix_ref_matches_pallas(rng, shape):
    """Against nco_mix_pallas(interpret=True), phase carry included."""
    x = _cx(rng, *shape)
    phase0 = 0xFFFFFFF0
    dphi = int(jsig.phase_increment(-3e6, 20e6))
    y_j, ph_j = jax.jit(lambda v: nco_mix_pallas(
        v, np.uint32(phase0), np.uint32(dphi), interpret=True))(jnp.asarray(x))
    y_t, ph_t = ck.nco_mix(torch.from_numpy(x), phase0, dphi)
    assert ph_t == int(np.asarray(ph_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_nco_mix_ref_matches_complex_exp_ramp(rng):
    """The mixer's direct form against x·complex_exp_ramp (factored form), the
    product FreqXlatingFir computes in the JAX package."""
    x = _cx(rng, 8192)
    dphi = int(jsig.phase_increment(-3e6, 20e6))
    want = x * np.asarray(jsig.complex_exp_ramp(np.uint32(5), np.uint32(dphi), 8192))
    got, _ = ck.nco_mix_ref(torch.from_numpy(x), 5, dphi)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -- demod ---------------------------------------------------------------------

@pytest.mark.parametrize("rot", [None, complex(np.exp(2j * np.pi * 0.3))])
@pytest.mark.parametrize("shape", [(4096,), (2, 1024)])
def test_quadrature_demod_matches_jax(rng, rot, shape):
    x = _cx(rng, *shape)
    last = _cx(rng, *shape[:-1]) if len(shape) > 1 else np.complex64(0.3 - 0.2j)
    y_j, l_j = j_quad_demod(jnp.asarray(x), jnp.asarray(last), gain=1.7, rot=rot)
    y_t, l_t = quadrature_demod(torch.from_numpy(x), torch.as_tensor(last),
                                gain=float(np.float32(1.7)), rot=rot)
    assert y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))


# -- fused FIR + quadrature demod ------------------------------------------------

# tests/test_pallas_kernels.py:128: the fused kernel's atan2 polynomial and f32
# FIR sums against the composition, in rad·gain
DEMOD_ATOL = 2e-3


@pytest.mark.parametrize("k,decim,t,xlating", [
    (127, 1, 1 << 15, False), (64, 2, 1 << 15, False), (127, 1, 12345 + 126, False),
    # the CUDA kernel's polyphase path: decim 4 (the JAX package composes FIR
    # and demod there), decim 3 with heterodyned taps (its Pallas kernel in
    # interpret mode), and a tail that leaves T % decim samples unused
    (127, 4, 1 << 15, False), (127, 3, 3 * 4096, True), (127, 4, 12347, False)])
def test_fir_quad_demod_fused_matches_jax(k, decim, t, xlating):
    """tests/test_pallas_kernels.py:110-128 (seed, taps, gain 1.5, carried
    prev) through both packages' fir_quad_demod_fused; the port's CPU path is
    fir_demod_ref."""
    from gnuradio4_tpu_torch.ops.fir import fir_quad_demod_fused
    rng = np.random.default_rng(0)
    taps = (rng.standard_normal(k) / 8).astype(np.float32)
    if xlating:
        taps = jfir.freq_xlating_taps(taps, 0.15, 1.0)
    x = (rng.standard_normal(t + k - 1)
         + 1j * rng.standard_normal(t + k - 1)).astype(np.complex64)
    prev = np.complex64(0.3 + 0.1j)
    want = jax.jit(lambda v, pv: jfir.fir_quad_demod_fused(
        v[None, :], taps, decim, pv, 1.5))(jnp.asarray(x), jnp.asarray(prev))
    got = fir_quad_demod_fused(torch.from_numpy(x)[None, :], taps, decim,
                               torch.tensor(prev), 1.5)
    assert got.shape == want.shape == (1, (t - k + 1 + k - 1) // decim)
    assert got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < DEMOD_ATOL


def test_fir_demod_ref_complex_taps_streamed_matches_jax():
    """tests/test_pallas_kernels.py:130-161: heterodyned taps (the WBFM
    xlating form) streamed in two chunks; the second chunk's v[-1] is the
    first chunk's last FIR output."""
    rng = np.random.default_rng(1)
    k, n = 127, 1 << 14
    taps = jfir.freq_xlating_taps(
        (rng.standard_normal(k) / 8).astype(np.float32), 0.15, 1.0)
    x = (rng.standard_normal(2 * n + k - 1)
         + 1j * rng.standard_normal(2 * n + k - 1)).astype(np.complex64)
    one = jnp.ones((), jnp.complex64)
    y, _ = jfir.fir_apply(jnp.asarray(x[k - 1:]), taps, jnp.asarray(x[: k - 1]))
    want, _ = j_quad_demod(y, one, gain=1.0)
    xt = torch.from_numpy(x)
    c1 = ck.fir_demod_ref(xt[: n + k - 1], taps, 1,
                          torch.ones((), dtype=torch.complex64), 1.0)
    v_last = ck.fir_banded_ref(xt[k - 1: n + k - 1], xt[: k - 1], taps)[-1]
    c2 = ck.fir_demod(xt[n: 2 * n + k - 1], taps, 1, v_last, 1.0)
    got = torch.cat([c1, c2]).numpy()
    assert float(np.max(np.abs(got - np.asarray(want)))) < DEMOD_ATOL


def test_fir_demod_ref_channels_are_independent(rng):
    """C = 3 in one call equals three single-channel calls, each with its
    own prev (the kernel takes C as a grid dimension)."""
    k = 31
    taps = _taps(rng, k, True)
    xc = _cx(rng, 3, 5000 + k - 1)
    prev = _cx(rng, 3)
    got = ck.fir_demod_ref(torch.from_numpy(xc), taps, 3, torch.from_numpy(prev), 0.7)
    assert got.shape == (3, 5000 // 3)
    for c in range(3):
        one = ck.fir_demod_ref(torch.from_numpy(xc[c]), taps, 3,
                               torch.from_numpy(prev)[c], 0.7)
        np.testing.assert_allclose(got[c].numpy(), one.numpy(), atol=DEMOD_ATOL)
