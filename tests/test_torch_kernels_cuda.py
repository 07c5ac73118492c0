"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Skipped where there is no CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; there, run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import filter_design as fd
from gnuradio4_tpu_torch.ops.fir import (fir_apply, fir_quad_demod_fused,
                                         freq_xlating_taps)
from gnuradio4_tpu_torch.ops.iir import sos_init_state
from gnuradio4_tpu_torch.ops.signal import phase_increment

pytestmark = pytest.mark.cuda

# f32 accumulation over ≤127 taps of unit-variance samples, two summation orders
FIR_ATOL = 2e-4
# sincosf against torch's sin/cos, |x| ≲ 5
NCO_ATOL = 1e-5
# f32 biquad recursions, FMA-contracted on the card, relative to the RMS
IIR_RTOL = 1e-5
# f32 against scipy's float64 sosfilt, relative to the RMS (chip_smoke.py's)
SCIPY_RTOL = 2e-5
# atan2 of f32 FIR outputs, wrapped into (−π, π], in rad·gain
DEMOD_ATOL = 2e-3
# f32 sums of 16384 taps against a float64 reference, relative to the output
# RMS: the rounding error grows like √K·2^-24 (~1e-5); 2.1e-5 measured on an
# H100
LONG_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _taps(kind: str) -> np.ndarray:
    fs = 20e6
    if kind == "xlating127":
        return freq_xlating_taps(fd.design_fir("lowpass", 127, sample_rate=fs,
                                               f_low=2e6), 3e6, fs)
    if kind == "real127":
        return fd.design_fir("lowpass", 127, sample_rate=fs, f_low=2e6
                             ).astype(np.float32)
    if kind == "real63":
        return fd.design_fir("lowpass", 63, sample_rate=fs, f_low=1e6
                             ).astype(np.float32)
    if kind == "audio127":
        return fd.design_fir("lowpass", 127, sample_rate=250e3, f_low=15e3
                             ).astype(np.float32)
    if kind == "xlating7":
        return np.ascontiguousarray(_taps("xlating127")[60:67])
    if kind == "xlating963":        # fm_monitor's channel filter, ÷40
        return freq_xlating_taps(fd.design_fir("lowpass", 963, sample_rate=fs,
                                               f_low=100e3), 3.1e6, fs)
    if kind == "real963":
        return fd.design_fir("lowpass", 963, sample_rate=fs, f_low=100e3
                             ).astype(np.float32)
    if kind == "random16384":
        g = np.random.default_rng(16384)
        return ((g.standard_normal(16384) + 1j * g.standard_normal(16384))
                / 128).astype(np.complex64)
    return np.ones(1, np.float32)


@pytest.mark.parametrize("x_dt,taps,decim,shape", [
    (torch.complex64, "xlating127", 1, (1 << 20,)),
    (torch.complex64, "real127", 1, (1 << 20,)),
    (torch.float32, "real63", 8, (1 << 20,)),
    (torch.float32, "xlating127", 1, (65536,)),
    (torch.complex64, "xlating127", 1, (4, 100003)),
    (torch.float32, "real63", 8, (3, 100005)),
    (torch.complex64, "real63", 3, (5000,)),
    (torch.complex64, "one", 1, (1000,)),
    (torch.float32, "real63", 8, (7,)),          # fewer samples than one output
    (torch.float32, "real63", 2048, (1 << 20,)),  # decim above the old limit
    (torch.complex64, "real63", 1024, (1 << 20,)),
    (torch.complex64, "xlating7", 1, (65539, 64)),  # channels beyond grid y
])
def test_fir_banded_matches_plain(cuda, x_dt, taps, decim, shape):
    g = torch.Generator(device=cuda).manual_seed(7)
    h = _taps(taps)
    k = len(h)
    x = torch.randn(shape, dtype=x_dt, device=cuda, generator=g)
    hist = torch.randn((*shape[:-1], k - 1), dtype=x_dt, device=cuda, generator=g)
    before = ck.fir_banded.launches
    y = ck.fir_banded(x, hist, h, decim)
    y_ref = ck.fir_banded_ref(x, hist, h, decim)
    torch.cuda.synchronize()
    # an empty output launches nothing and counts nothing
    assert ck.fir_banded.launches == before + (1 if y.numel() else 0)
    assert y.shape == y_ref.shape == (*shape[:-1], shape[-1] // decim)
    assert y.dtype == y_ref.dtype
    if y.numel():
        assert float((y - y_ref).abs().max()) <= FIR_ATOL


@pytest.mark.parametrize("x_dt,taps,decim,n", [
    (torch.complex64, "xlating127", 1, 1 << 23),   # the chain, absorbed
    (torch.complex64, "real127", 1, 1 << 23),      # the chain, derotated
    (torch.float32, "real63", 8, 1 << 23),         # the chain's audio FIR
    (torch.float32, "audio127", 5, 4194305)])      # Path A's audio FIR
def test_fir_banded_chain_shapes_on_the_shared_loop(cuda, x_dt, taps, decim, n):
    """fir_banded at the chain's and Path A's shapes, on the tile loop it
    shares with fir_demod (fir_common.cuh): one launch each, against the
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(19)
    h = _taps(taps)
    k = len(h)
    x = torch.randn(n, dtype=x_dt, device=cuda, generator=g)
    hist = torch.randn(k - 1, dtype=x_dt, device=cuda, generator=g)
    before = ck.fir_banded.launches
    y = ck.fir_banded(x, hist, h, decim)
    y_ref = ck.fir_banded_ref(x, hist, h, decim)
    torch.cuda.synchronize()
    assert ck.fir_banded.launches == before + 1
    assert y.shape == y_ref.shape == (n // decim,)
    assert float((y - y_ref).abs().max()) <= FIR_ATOL


# tiles of the phase-grouped loop at K 963 ÷40: 224 outputs of 40 samples
GROUPED_TILE = 224 * 40


@pytest.mark.parametrize("x_dt,taps,decim,shape", [
    (torch.complex64, "xlating963", 40, (64 * GROUPED_TILE,)),    # whole tiles
    (torch.complex64, "xlating963", 40, (64 * GROUPED_TILE + 1493,)),  # ragged
    (torch.complex64, "real963", 40, (64 * GROUPED_TILE + 1493,)),
    (torch.float32, "real963", 40, (64 * GROUPED_TILE + 1493,)),
    (torch.complex64, "xlating963", 40, (2, 9 * GROUPED_TILE + 77)),  # channels
    (torch.complex64, "real63", 64, (1 << 20,)),                  # decim > K
    (torch.complex64, "xlating963", 40, (GROUPED_TILE - 41,)),    # one short tile
])
def test_fir_banded_phase_groups_match_plain(cuda, x_dt, taps, decim, shape):
    """Long decimating filters take the phase-grouped loop (gr4_fir_banded
    reports groups > 1, counted in fir_banded.phase_groups) and agree with
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(23)
    h = _taps(taps)
    k = len(h)
    x = torch.randn(shape, dtype=x_dt, device=cuda, generator=g)
    hist = torch.randn((*shape[:-1], k - 1), dtype=x_dt, device=cuda, generator=g)
    before = ck.launch_counts()
    y = ck.fir_banded(x, hist, h, decim)
    y_ref = ck.fir_banded_ref(x, hist, h, decim)
    torch.cuda.synchronize()
    after = ck.launch_counts()
    assert after["fir_banded"] == before["fir_banded"] + 1
    assert (after["fir_banded.phase_groups"]
            == before["fir_banded.phase_groups"] + 1)
    assert y.shape == y_ref.shape == (*shape[:-1], shape[-1] // decim)
    assert float((y - y_ref).abs().max()) <= FIR_ATOL


@pytest.mark.parametrize("x_dt,taps,decim,n,grouped", [
    (torch.complex64, "xlating963", 40, 1 << 22, True),   # fm's channel filter
    (torch.complex64, "xlating127", 1, 1 << 20, False),   # the chain's FIR
    (torch.float32, "real63", 8, 1 << 20, False)])        # its audio FIR
def test_fir_banded_counts_phase_groups_by_path(cuda, x_dt, taps, decim, n, grouped):
    """fir_banded.phase_groups counts the launches that took the
    phase-grouped loop, and only those."""
    h = _taps(taps)
    x = torch.ones(n, dtype=x_dt, device=cuda)
    hist = torch.zeros(len(h) - 1, dtype=x_dt, device=cuda)
    ck.reset_launch_counts()
    ck.fir_banded(x, hist, h, decim)
    ck.fir_banded(x, hist, h, decim)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    assert counts["fir_banded"] == 2
    assert counts["fir_banded.phase_groups"] == (2 if grouped else 0)


def test_fir_apply_state_carry_phase_groups_on_card(cuda):
    """At K 963 ÷40 (the phase-grouped loop), two chunks through fir_apply
    with the carried history equal one pass over the joined stream."""
    g = torch.Generator(device=cuda).manual_seed(24)
    h = _taps("xlating963")
    n1, n2 = 37 * GROUPED_TILE + 40 * 101, 23 * GROUPED_TILE + 40 * 7
    x = torch.randn(n1 + n2, dtype=torch.complex64, device=cuda, generator=g)
    st0 = torch.randn(len(h) - 1, dtype=torch.complex64, device=cuda, generator=g)
    before = ck.fir_banded.phase_groups
    y_one, st_one = fir_apply(x, h, st0, decim=40)
    y1, st = fir_apply(x[:n1], h, st0, decim=40)
    y2, st = fir_apply(x[n1:], h, st, decim=40)
    torch.cuda.synchronize()
    assert ck.fir_banded.phase_groups == before + 3
    assert y_one.shape == ((n1 + n2) // 40,)
    assert float((torch.cat([y1, y2]) - y_one).abs().max()) <= FIR_ATOL
    assert torch.equal(st, st_one)


def test_fir_apply_state_carry_on_card(cuda):
    """Two chunks through fir_apply with the carried history equal one pass."""
    g = torch.Generator(device=cuda).manual_seed(8)
    h = _taps("xlating127")
    x = torch.randn(1 << 16, dtype=torch.complex64, device=cuda, generator=g)
    st0 = torch.zeros(126, dtype=torch.complex64, device=cuda)
    y_one, st_one = fir_apply(x, h, st0)
    y1, st = fir_apply(x[: 1 << 15], h, st0)
    y2, st = fir_apply(x[1 << 15:], h, st)
    torch.cuda.synchronize()
    assert float((torch.cat([y1, y2]) - y_one).abs().max()) <= FIR_ATOL
    assert torch.equal(st, st_one)


@pytest.mark.parametrize("shape", [(1 << 20,), (4, 100003)])
def test_nco_mix_matches_plain_across_wrap(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(shape, dtype=torch.complex64, device=cuda, generator=g)
    dphi = int(phase_increment(-3e6, 20e6))
    phase0 = (1 << 32) - 12345
    before = ck.nco_mix.launches
    y, ph = ck.nco_mix(x, phase0, dphi)
    y_ref, ph_ref = ck.nco_mix_ref(x, phase0, dphi)
    torch.cuda.synchronize()
    assert ck.nco_mix.launches == before + 1
    assert ph == ph_ref == (phase0 + shape[-1] * dphi) % (1 << 32)
    assert float((y - y_ref).abs().max()) <= NCO_ATOL
    # continuity: two halves with the carried phase equal one pass
    half = shape[-1] // 2
    y1, p1 = ck.nco_mix(x[..., :half].contiguous(), phase0, dphi)
    y2, _ = ck.nco_mix(x[..., half:].contiguous(), p1, dphi)
    torch.cuda.synchronize()
    assert float((torch.cat([y1, y2], -1) - y).abs().max()) <= NCO_ATOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(64, 2, dtype=torch.complex64, device=cuda).t()  # non-contiguous
    with pytest.raises(GrError, match="contiguous"):
        ck.nco_mix(x, 0, 1)
    with pytest.raises(GrError, match="complex64"):
        ck.nco_mix(torch.zeros(8, device=cuda), 0, 1)
    with pytest.raises(GrError, match="one CUDA device"):
        ck.fir_banded(torch.zeros(8, device=cuda), torch.zeros(2), np.ones(3))
    with pytest.raises(GrError, match="shapes"):
        ck.fir_banded(torch.zeros(8, device=cuda), torch.zeros(5, device=cuda),
                      np.ones(3))
    with pytest.raises(GrError, match="float32"):
        ck.fir_banded(torch.zeros(8, dtype=torch.float64, device=cuda),
                      torch.zeros(2, dtype=torch.float64, device=cuda), np.ones(3))


def _sos(order: int) -> np.ndarray:
    return fd.design_iir("butterworth", "lowpass", order, sample_rate=48e3,
                         f_low=15e3).sos


def _rms_err(y, y_ref) -> float:
    return float((y - y_ref).abs().max()) / max(float(y_ref.pow(2).mean().sqrt()), 1e-3)


@pytest.mark.parametrize("order,shape", [(5, (16, 4096)), (5, (4096,)),
                                         (4, (3, 1000)), (12, (2, 777)),
                                         (5, (2, 127)), (5, (2, 128)), (5, (2, 129))])
def test_iir_sos_matches_plain(cuda, order, shape):
    """Against the plain loop; T 127, 128 and 129 sit around one chunk
    (T < L is the serial loop over one chunk)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    sos = _sos(order)
    ch = shape[0] if len(shape) == 2 else 0
    x = torch.randn(shape, device=cuda, generator=g)
    s0 = 0.1 * torch.randn(sos_init_state(ch, sos.shape[0]).shape, device=cuda,
                           generator=g)
    before = ck.iir_sos.launches
    y, st = ck.iir_sos(x, sos, s0)
    y_ref, st_ref = ck.iir_sos_ref(x, sos, s0)
    torch.cuda.synchronize()
    # one group of sections: reduce, carry and rerun
    assert ck.iir_sos.launches == before + 3
    assert y.shape == y_ref.shape and st.shape == st_ref.shape
    assert _rms_err(y, y_ref) <= IIR_RTOL
    assert _rms_err(st, st_ref) <= IIR_RTOL


@pytest.mark.parametrize("n_sec,t", [(17, 4096), (33, 4096), (17, 1000)])
def test_iir_sos_any_number_of_sections(cuda, n_sec, t):
    """17 and 33 repeated biquads: three launches per group of 16 sections,
    each group after the first filtering in place; against the plain loop
    (T 1000: a partial last chunk), and two chunks with the carried state
    within IIR_RTOL of one pass (the chunk grid starts at each call's first
    sample, so the rounding differs)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    sos = np.tile(_sos(4)[:1], (n_sec, 1))
    x = torch.randn(3, t, device=cuda, generator=g)
    s0 = 0.1 * torch.randn(3, n_sec, 2, device=cuda, generator=g)
    before = ck.iir_sos.launches
    y, st = ck.iir_sos(x, sos, s0)
    y_ref, st_ref = ck.iir_sos_ref(x, sos, s0)
    torch.cuda.synchronize()
    assert ck.iir_sos.launches == before + 3 * -(-n_sec // 16)
    assert _rms_err(y, y_ref) <= IIR_RTOL
    assert _rms_err(st, st_ref) <= IIR_RTOL
    y1, st1 = ck.iir_sos(x[:, :500].contiguous(), sos, s0)
    y2, st2 = ck.iir_sos(x[:, 500:].contiguous(), sos, st1)
    torch.cuda.synchronize()
    assert _rms_err(torch.cat([y1, y2], -1), y) <= IIR_RTOL
    assert _rms_err(st2, st) <= IIR_RTOL


def test_iir_sos_state_carry_on_card(cuda):
    """Two chunks with the carried state agree with one pass within IIR_RTOL:
    the chunked scan's grid starts at each call's first sample, so the two
    round differently (no longer bit for bit)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    sos = _sos(5)
    x = torch.randn(16, 1 << 14, device=cuda, generator=g)
    s0 = torch.zeros(16, 3, 2, device=cuda)
    y_one, st_one = ck.iir_sos(x, sos, s0)
    y1, st = ck.iir_sos(x[:, : 5000].contiguous(), sos, s0)
    y2, st = ck.iir_sos(x[:, 5000:].contiguous(), sos, st)
    torch.cuda.synchronize()
    assert _rms_err(torch.cat([y1, y2], -1), y_one) <= IIR_RTOL
    assert _rms_err(st, st_one) <= IIR_RTOL


def _float64_err(y, x, sos) -> float:
    """max|y − sosfilt(x)| over the RMS of scipy's float64 sosfilt."""
    signal = pytest.importorskip("scipy.signal")
    want = signal.sosfilt(sos, x.cpu().numpy().astype(np.float64), axis=-1)
    got = y.cpu().numpy().astype(np.float64)
    return float(np.max(np.abs(got - want))) / float(np.sqrt(np.mean(want ** 2)))


def test_iir_sos_one_channel_2_20_against_float64(cuda):
    """One channel of 2^20 samples (8192 chunks: runs of 32 chunks per carry
    thread and the whole scan) against scipy's float64 sosfilt."""
    g = torch.Generator(device=cuda).manual_seed(17)
    sos = _sos(5)
    x = torch.randn(1, 1 << 20, device=cuda, generator=g)
    y, st = ck.iir_sos(x, sos, torch.zeros(1, 3, 2, device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert _float64_err(y, x, sos) <= SCIPY_RTOL


def test_iir_sos_narrow_band_error_within_twice_the_plain_loop(cuda):
    """Butterworth 5 at 200 Hz of 48 kHz, T 2^15: poles near the unit circle,
    where the carry matters most. The plain loop itself sits ~4e-4 of the RMS
    from float64 (the design amplifies f32 rounding); the kernel's error is at
    most twice the plain loop's on the same input."""
    sos = fd.design_iir("butterworth", "lowpass", 5, sample_rate=48e3,
                        f_low=200.0).sos
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (2, 1 << 15)).astype(np.float32))
    s0 = torch.zeros(2, 3, 2)
    y, _ = ck.iir_sos(x.to(cuda), sos, s0.to(cuda))
    y_plain, _ = ck.iir_sos_ref(x, sos, s0)        # the CPU: the plain loop
    torch.cuda.synchronize()
    err, err_plain = _float64_err(y, x, sos), _float64_err(y_plain, x, sos)
    print(f"narrow band, against float64: kernel {err:.3e}, plain {err_plain:.3e}")
    assert err <= 2 * err_plain


def _fm_stream(g, cuda, shape):
    """An FM-modulated carrier with a little noise: what a receiver sees, and
    away from |v| ≈ 0 where atan2 amplifies rounding without bound."""
    n = shape[-1]
    dev = torch.randn(shape, device=cuda, generator=g).cumsum(-1) * 0.05
    ph = torch.sin(dev) * 1.5 + torch.arange(n, device=cuda) * 0.3
    x = torch.polar(torch.ones_like(ph), ph)
    return (x + 0.05 * torch.randn(shape, dtype=torch.complex64, device=cuda,
                                   generator=g)).contiguous()


def _wrapped_err(a, b, gain):
    d = (a - b) / gain
    return float(torch.remainder(d + torch.pi, 2 * torch.pi).sub(torch.pi).abs().max()) * gain


# fir_demod's demod outputs per tile at 256 threads (K 127 at decim 1 and 3):
# 7 FIR outputs a thread, one of them recomputed from the previous tile
DEMOD_TILE = 256 * 7 - 1


@pytest.mark.parametrize("taps,decim,shape", [
    ("real127", 1, (1 << 20,)), ("xlating127", 1, (1 << 20,)),
    ("real63", 2, (100003,)), ("xlating127", 1, (4, 65536 + 13)),
    ("one", 1, (1000,)), ("real63", 3, (40,)),
    ("real63", 1024, (1 << 20,)), ("xlating127", 2048, (1 << 20,)),
    ("xlating7", 1, (65539, 64)),
    # tile edges: M = 2·tile − 1, 2·tile, 2·tile + 1
    ("real127", 1, (2 * DEMOD_TILE - 1,)), ("real127", 1, (2 * DEMOD_TILE,)),
    ("real127", 1, (2 * DEMOD_TILE + 1,)),
    ("real127", 3, (3 * (2 * DEMOD_TILE - 1),)), ("real127", 3, (3 * 2 * DEMOD_TILE,)),
    ("real127", 3, (3 * (2 * DEMOD_TILE + 1) + 2,)),
    # the polyphase path: decim 4 and 8, real and complex taps
    ("real127", 4, (1 << 20,)), ("xlating127", 4, (1 << 20,)),
    ("real127", 8, (1 << 20,)), ("xlating127", 8, (3, 100007)),
    # M = 1; T shorter than one tile; decim > K with the planes in chunks
    ("real127", 1, (1,)), ("xlating127", 4, (7,)), ("real127", 1, (500,)),
    ("xlating127", 200, (50000,))])
def test_fir_demod_matches_plain(cuda, taps, decim, shape):
    g = torch.Generator(device=cuda).manual_seed(12)
    h = _taps(taps)
    k = len(h)
    xc = _fm_stream(g, cuda, (*shape[:-1], shape[-1] + k - 1))
    prev = torch.polar(torch.ones(shape[:-1], device=cuda),
                       torch.full(shape[:-1], 0.7, device=cuda))
    gain = 250e3 / (2 * np.pi * 75e3)
    before = ck.fir_demod.launches
    y = ck.fir_demod(xc, h, decim, prev, gain)
    y_ref = ck.fir_demod_ref(xc, h, decim, prev, gain)
    torch.cuda.synchronize()
    assert ck.fir_demod.launches == before + (1 if y.numel() else 0)
    assert y.shape == y_ref.shape == (*shape[:-1], shape[-1] // decim)
    if y.numel():
        assert _wrapped_err(y, y_ref, gain) <= DEMOD_ATOL * gain


def _fir_float64(xc, taps, decim):
    """y[..., m] = Σ_k h[k]·xc[..., m·decim + K−1−k] in float64 (FFT)."""
    xc = xc.cpu().numpy().astype(np.complex128)
    k = len(taps)
    n = xc.shape[-1] + k - 1
    full = np.fft.ifft(np.fft.fft(xc, n) * np.fft.fft(taps.astype(np.complex128), n))
    m = (xc.shape[-1] - (k - 1)) // decim
    return full[..., k - 1: k - 1 + m * decim: decim]


def test_fir_kernels_take_16384_complex_taps(cuda):
    """K 16384 complex taps at T 2^15: the taps and one window exceed the
    shared-memory budget, so both kernels stage the taps in chunks. Against a
    float64 FIR (and, for fir_demod, the demod of its rounding to c64)."""
    from gnuradio4_tpu_torch.ops.demod import quadrature_demod
    g = torch.Generator(device=cuda).manual_seed(14)
    h = _taps("random16384")
    k, t = len(h), 1 << 15
    x = torch.randn(t, dtype=torch.complex64, device=cuda, generator=g)
    hist = torch.randn(k - 1, dtype=torch.complex64, device=cuda, generator=g)
    y = ck.fir_banded(x, hist, h)
    want = _fir_float64(torch.cat([hist, x]), h, 1)
    torch.cuda.synchronize()
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    assert y.shape == (t,)
    assert float(np.max(np.abs(y.cpu().numpy() - want))) <= LONG_RTOL * rms
    xc = _fm_stream(g, cuda, (t + k - 1,))
    prev = torch.ones((), dtype=torch.complex64, device=cuda)
    gain = 250e3 / (2 * np.pi * 75e3)
    y = ck.fir_demod(xc, h, 1, prev, gain)
    v = torch.from_numpy(_fir_float64(xc, h, 1).astype(np.complex64)).to(cuda)
    y_ref, _ = quadrature_demod(v, prev, gain=gain)
    torch.cuda.synchronize()
    assert y.shape == (t,)
    assert _wrapped_err(y, y_ref, gain) <= DEMOD_ATOL * gain


def test_fir_filter_decim_1024_card_matches_cpu(cuda):
    """FirFilter(63 taps, decim 1024) on a complex stream over three steps
    with its history carried: the card (one fir_banded launch per step)
    against the CPU."""
    from gnuradio4_tpu_torch.blocks.filter import FirFilter
    from gnuradio4_tpu_torch.core.block import BlockCtx
    taps = fd.design_fir("lowpass", 63, sample_rate=48e3, f_low=10).astype(np.float32)
    n, decim = 64 * 1024, 1024
    rng = np.random.default_rng(15)
    chunks = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
              for _ in range(3)]
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        blk = FirFilter(taps=taps, decim=decim)
        ctx = BlockCtx(in_len={"in": n}, out_len={"out": n // decim},
                       sample_rate=48e3, params={}, channels={"in": 0, "out": 0},
                       dtypes={"in": np.dtype(np.complex64)}, device=dev)
        st = blk.init_state(ctx)
        before = ck.fir_banded.launches
        ys = []
        for x in chunks:
            st, out = blk.apply(st, {"in": torch.from_numpy(x).to(dev)}, ctx)
            ys.append(out["out"].cpu())
        outs[dev.type] = (torch.cat(ys), ck.fir_banded.launches - before)
    assert outs["cpu"][1] == 0 and outs["cuda"][1] == 3
    assert outs["cuda"][0].shape == (3 * n // decim,)
    assert float((outs["cuda"][0] - outs["cpu"][0]).abs().max()) <= FIR_ATOL


def test_fir_quad_demod_fused_carry_on_card(cuda):
    """fir_quad_demod_fused over two chunks, the second with the first's
    last FIR output as prev, equals one pass."""
    g = torch.Generator(device=cuda).manual_seed(13)
    h = _taps("xlating127")
    k, n = len(h), 1 << 16
    xc = _fm_stream(g, cuda, (2 * n + k - 1,))
    one = torch.ones((), dtype=torch.complex64, device=cuda)
    y_one = fir_quad_demod_fused(xc[None], h, 1, one, 1.0)
    c1 = fir_quad_demod_fused(xc[None, : n + k - 1], h, 1, one, 1.0)
    v_last = ck.fir_banded(xc[k - 1: n + k - 1].contiguous(),
                           xc[: k - 1].contiguous(), h)[-1]
    c2 = fir_quad_demod_fused(xc[None, n:], h, 1, v_last, 1.0)
    torch.cuda.synchronize()
    assert y_one.shape == (1, 2 * n)
    assert _wrapped_err(torch.cat([c1, c2], -1), y_one, 1.0) <= DEMOD_ATOL


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(64, device=cuda)
    with pytest.raises(GrError, match="float32"):
        ck.iir_sos(x.double(), _sos(4), torch.zeros(2, 2, device=cuda))
    with pytest.raises(GrError, match="shapes"):
        ck.iir_sos(x, _sos(4), torch.zeros(3, 2, device=cuda))
    # 17 sections, once refused: now two groups, equal to the plain loop
    many = np.tile(_sos(4)[:1], (17, 1))
    xr = torch.randn(64, device=cuda)
    y, st = ck.iir_sos(xr, many, torch.zeros(17, 2, device=cuda))
    y_ref, st_ref = ck.iir_sos_ref(xr, many, torch.zeros(17, 2, device=cuda))
    assert _rms_err(y, y_ref) <= IIR_RTOL and _rms_err(st, st_ref) <= IIR_RTOL
    xc = torch.zeros(64, dtype=torch.complex64, device=cuda)
    prev = torch.zeros((), dtype=torch.complex64, device=cuda)
    with pytest.raises(GrError, match="complex64"):
        ck.fir_demod(x, np.ones(3, np.float32), 1, prev, 1.0)
    with pytest.raises(GrError, match="shapes"):
        ck.fir_demod(xc, np.ones(3, np.float32), 1,
                     torch.zeros(2, dtype=torch.complex64, device=cuda), 1.0)


def _headline_chain(absorb: bool, monkeypatch):
    """bench.py's headline chain in the port, with VectorSinks."""
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.blocks.basic import ComplexToneSource
    from gnuradio4_tpu_torch.blocks.filter import FirFilter, FreqXlatingFir
    from gnuradio4_tpu_torch.blocks.fourier import FFT
    from gnuradio4_tpu_torch.blocks.sdr import QuadratureDemod
    from gnuradio4_tpu_torch.blocks.testing import VectorSink
    if absorb:
        monkeypatch.delenv("GR4TPU_NO_ROTATION_ABSORB", raising=False)
    else:
        monkeypatch.setenv("GR4TPU_NO_ROTATION_ABSORB", "1")
    g = gt.Graph()
    fir = FreqXlatingFir(taps=_taps("real127"), center_freq=3e6,
                         sample_rate_in=20e6, decim=1)
    s1, s2 = VectorSink(), VectorSink()
    g.connect_chain(ComplexToneSource(frequency=1e6), fir,
                    FFT(fft_size=4096, window="Hann", output="magnitude",
                        calibrate=False), s1)
    dem = QuadratureDemod(gain=1.0)
    g.connect(fir, dem)
    g.connect_chain(dem, FirFilter(taps=_taps("real63"), decim=8), s2)
    return g, s1, s2


@pytest.mark.parametrize("absorb", [True, False])
def test_chain_async_batched_scheduler_matches_sync(cuda, monkeypatch, absorb):
    """The headline chain on the card under pipelined async delivery and
    4-step batches gives the synchronous unbatched run's sinks bit for bit,
    with the same kernel launches per logical step."""
    import gnuradio4_tpu_torch as gt
    outs, launches = [], []
    for kw in (dict(pipeline_depth=1),
               dict(pipeline_depth=2, async_delivery=True, batch_steps=4)):
        g, s1, s2 = _headline_chain(absorb, monkeypatch)
        ck.reset_launch_counts()
        gt.Scheduler(g, block_len=1 << 18, sample_rate=20e6, device="cuda",
                     **kw).run_and_wait(8)
        launches.append(ck.launch_counts())
        outs.append((s1.data(), s2.data()))
    assert outs[0][0].shape == (8 << 18,) and outs[0][1].shape == (1 << 18,)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    assert launches[0] == launches[1]
    assert launches[0]["fir_banded"] == 16
    assert launches[0]["nco_mix"] == (0 if absorb else 8)


@pytest.mark.parametrize("x_dt", [torch.complex64, torch.float32])
@pytest.mark.parametrize("method", ["pallas", "pallas_ilv", "auto"])
def test_fir_apply_pallas_methods_launch_fir_banded(cuda, method, x_dt):
    """``fir_apply(method='pallas'/'pallas_ilv'/'auto')`` on a CUDA tensor is
    the banded kernel for complex and real streams: one launch, the plain
    version's numbers."""
    g = torch.Generator(device=cuda).manual_seed(11)
    h = _taps("real127")
    x = torch.randn(1 << 18, dtype=x_dt, device=cuda, generator=g)
    st = torch.randn(126, dtype=x_dt, device=cuda, generator=g)
    before = ck.fir_banded.launches
    y, _ = fir_apply(x, h, st, decim=2, method=method)
    torch.cuda.synchronize()
    assert ck.fir_banded.launches == before + 1
    y_ref, _ = fir_apply(x, h, st, decim=2, method="matmul")
    assert y.dtype == y_ref.dtype == x_dt
    assert float((y - y_ref).abs().max()) <= FIR_ATOL


@pytest.mark.parametrize("x_dt,taps", [(torch.complex64, "real127"),
                                       (torch.float32, "real127"),
                                       (torch.complex64, "xlating127")])
def test_fir_apply_conv_full_f32_under_default_cudnn_flags(cuda, x_dt, taps):
    """``method='conv'`` under PyTorch's default cuDNN flags (TF32 allowed)
    runs in full float32 (TF32 would miss by ~1e-3 of the RMS) and leaves the
    flags as it found them."""
    g = torch.Generator(device=cuda).manual_seed(15)
    h = _taps(taps)
    x = torch.randn(1 << 18, dtype=x_dt, device=cuda, generator=g)
    st = torch.randn(126, dtype=x_dt, device=cuda, generator=g)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y, _ = fir_apply(x, h, st, decim=2, method="conv")
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    y_ref, _ = fir_apply(x, h, st, decim=2, method="matmul")
    scale = float(y_ref.abs().pow(2).mean().sqrt())
    assert y.shape == y_ref.shape
    assert float((y - y_ref).abs().max()) <= 1e-5 * scale


def test_rotator_launches_nco_mix_per_step_across_wrap(cuda):
    """A Rotator on the card: one ``nco_mix`` launch per step, the CPU's
    output and uint32 phase across a 2^32 wrap."""
    import gnuradio4_tpu_torch as gt
    blk = gt.global_registry.create("Rotator", frequency_shift=-3.1e6)
    ctx = gt.BlockCtx(in_len={"in": 1 << 16}, out_len={"out": 1 << 16},
                      sample_rate=20e6, params={},
                      channels={"in": 0, "out": 0},
                      dtypes={"in": np.dtype(np.complex64)})
    blk.init_state(ctx)
    ctx.params = blk.prepare_params(blk.settings.dynamic_params())
    x = torch.randn(4, 1 << 16, dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(12))
    outs = {}
    for device in ("cpu", "cuda"):
        st = torch.tensor((1 << 32) - 54321)
        ys = []
        before = ck.nco_mix.launches
        for i in range(4):
            st, o = blk.apply(st, {"in": x[i].to(device)}, ctx)
            ys.append(o["out"].cpu())
        outs[device] = (torch.cat(ys), int(st), ck.nco_mix.launches - before)
    assert outs["cuda"][2] == 4 and outs["cpu"][2] == 0
    assert outs["cuda"][1] == outs["cpu"][1] < (1 << 32) - 54321
    assert float((outs["cuda"][0] - outs["cpu"][0]).abs().max()) <= NCO_ATOL


def test_resampler_forms_and_ldpc_forms_agree_on_card(cuda):
    """Both RationalResampler forms and both LDPC decoder forms on the card
    against the CPU; the decoders' hard bits exact at 4 dB."""
    from gnuradio4_tpu_torch.ops import ldpc
    from gnuradio4_tpu_torch.ops.resample import RationalResamplerKernel
    k = RationalResamplerKernel(3, 2)
    x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(13))
    st = k.init_state(0, np.float32)
    y_cpu, _ = k.apply(x, st, method="interleave")
    for form in ("interleave", "matmul"):
        y, _ = k.apply(x.to(cuda), st.to(cuda), method=form)
        assert float((y.cpu() - y_cpu).abs().max()) <= FIR_ATOL
    H, G = ldpc.make_ldpc(256, 128, seed=0)
    rng = np.random.default_rng(14)
    c = ldpc.encode(G, rng.integers(0, 2, (64, G.shape[0])))
    sigma = np.sqrt(1.0 / (2 * 10 ** 0.4 * 0.5))
    llr = torch.from_numpy((2 * (1.0 - 2.0 * c + sigma * rng.standard_normal(
        c.shape)) / sigma ** 2).astype(np.float32))
    graph = ldpc.LdpcGraph(H)
    want, ok_want = ldpc.decode_np(H, llr.numpy(), 25)
    for fn in (ldpc.min_sum_decode, ldpc.min_sum_decode_dense):
        bits, ok = fn(graph, llr.to(cuda), 25)
        np.testing.assert_array_equal(bits.cpu().numpy(), want)
        np.testing.assert_array_equal(ok.cpu().numpy(), ok_want)


# one_pole (csrc/one_pole.cu) against a float64 sequential loop with the pole
# rounded as the kernel rounds it, relative to the largest |y|: f32 rounding
# through stretches of 16, scans of 8 levels and the tiles' carries (the plain
# version reads at most 2.1e-06 at |p| 0.999999, T 2^20); a wrong power or
# carry is O(1)
ONE_POLE_RTOL = 1e-5
# FmDeemphasis on the card against the CPU's blocked torch path, relative to
# the largest |y|
DEEMPH_RTOL = 1e-6


def _one_pole_case(shape, t, mag, cx, seed):
    """(pole, x, state) on the host: a real pole of magnitude ``mag`` or the
    complex one at angle 0.3 rad; unit-variance samples and state."""
    g = torch.Generator().manual_seed(seed)
    full = (*shape, t)
    dt = torch.complex64 if cx else torch.float32
    return (mag * np.exp(0.3j) if cx else mag, torch.randn(full, dtype=dt, generator=g),
            torch.randn(shape, dtype=dt, generator=g))


def _one_pole_float64(x, pole, state):
    """u[n] = p·u[n−1] + x[n] in float64 by scipy's lfilter (a sequential
    loop), p rounded to the stream's type."""
    signal = pytest.importorskip("scipy.signal")
    cx = x.is_complex()
    p = complex(np.complex64(pole)) if cx else float(np.float32(pole))
    x64 = x.numpy().astype(np.complex128 if cx else np.float64)
    zi = (p * state.numpy().astype(x64.dtype))[..., None]
    u, _ = signal.lfilter([1.0], [1.0, -p], x64, axis=-1, zi=zi)
    return u


@pytest.mark.parametrize("shape", [(), (1,), (100,)])
@pytest.mark.parametrize("t", [1, 127, 4096, 131071, 131072, 1 << 20])
@pytest.mark.parametrize("mag", [0.2, 0.76347, 0.995, 0.999999])
@pytest.mark.parametrize("cx", [False, True])
def test_one_pole_matches_float64_loop(cuda, cx, mag, t, shape):
    """One launch a call at every shape: one tile (T ≤ 4096), partial last
    tiles (127, 131071), the look-back over 32 (fm's T) and 256 tiles of a
    channel, and 100 channels."""
    pole, x, s = _one_pole_case(shape, t, mag, cx, seed=t + len(shape))
    before = ck.one_pole.launches
    y, last = ck.one_pole(x.to(cuda), pole, s.to(cuda))
    torch.cuda.synchronize()
    assert ck.one_pole.launches == before + 1
    assert y.shape == x.shape and last.shape == s.shape and y.dtype == x.dtype
    want = _one_pole_float64(x, pole, s)
    scale = float(np.abs(want).max())
    assert float(np.abs(y.cpu().numpy() - want).max()) <= ONE_POLE_RTOL * scale
    assert float(np.abs(last.cpu().numpy() - want[..., -1]).max()) <= ONE_POLE_RTOL * scale


@pytest.mark.parametrize("cx", [False, True])
def test_one_pole_four_calls_equal_one(cuda, cx):
    """Four calls with the carry equal one call over their concatenation
    within f32 rounding (each call's tiles start at its first sample), and
    each call counts one launch."""
    pole, x, s = _one_pole_case((100,), 4 * 131072, 0.995, cx, seed=41)
    x, s = x.to(cuda), s.to(cuda)
    y_one, last_one = ck.one_pole(x, pole, s)
    before = ck.launch_counts()["one_pole"]
    ys, st = [], s
    for part in x.chunk(4, dim=-1):
        y, st = ck.one_pole(part.contiguous(), pole, st)
        ys.append(y)
    torch.cuda.synchronize()
    assert ck.launch_counts()["one_pole"] == before + 4
    scale = float(y_one.abs().max())
    assert float((torch.cat(ys, -1) - y_one).abs().max()) <= ONE_POLE_RTOL * scale
    assert float((st - last_one).abs().max()) <= ONE_POLE_RTOL * scale


@pytest.mark.parametrize("shape", [(131072,), (100, 131072), (3, 5000)])
def test_fm_deemphasis_card_matches_cpu(cuda, shape):
    """FmDeemphasis (75 µs at 50 kHz) over three steps with its state carried,
    the card's kernel against the CPU's blocked torch path (T 5000: its scan)."""
    from gnuradio4_tpu_torch.blocks.sdr import FmDeemphasis
    from gnuradio4_tpu_torch.core.block import BlockCtx
    ch = shape[0] if len(shape) == 2 else 0
    outs = {}
    for dev in ("cpu", cuda):
        blk = FmDeemphasis(tau=75e-6, sample_rate_in=50e3)
        ctx = BlockCtx(in_len={"in": shape[-1]}, out_len={"out": shape[-1]},
                       sample_rate=50e3, params={}, channels={"in": ch, "out": ch},
                       device=torch.device(dev))
        g = torch.Generator().manual_seed(43)
        state, ys = blk.init_state(ctx), []
        for _ in range(3):
            state, out = blk.apply(state, {"in": torch.randn(shape, generator=g).to(dev)},
                                   ctx)
            ys.append(out["out"].cpu())
        outs[str(dev)] = (torch.cat(ys, -1), state.cpu())
    (y_cpu, s_cpu), (y_card, s_card) = outs["cpu"], outs["cuda"]
    scale = float(y_cpu.abs().max())
    assert float((y_card - y_cpu).abs().max()) <= DEEMPH_RTOL * scale
    assert float((s_card - s_cpu).abs().max()) <= DEEMPH_RTOL * scale


def test_deemphasis_is_one_kernel_and_no_copy(cuda):
    """One de-emphasis call at fm_allband's shape is one launch of one_pole
    and no other kernel, copy or fill on the card (after the first call,
    which zeroes the look-back's workspace once)."""
    from torch.profiler import ProfilerActivity, profile
    from gnuradio4_tpu_torch.ops.demod import fm_deemphasis_coeffs
    from gnuradio4_tpu_torch.ops.iir import one_pole_ba_apply
    b, a = fm_deemphasis_coeffs(50e3, 75e-6)
    x = torch.randn(100, 131072, device=cuda)
    u = torch.zeros(100, device=cuda)
    one_pole_ba_apply(x, b, a, u)
    torch.cuda.synchronize()
    before = ck.launch_counts()["one_pole"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pole_ba_apply(x, b, a, u)
        torch.cuda.synchronize()
    assert ck.launch_counts()["one_pole"] == before + 1
    device_ops = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_ops) == 1 and "one_pole" in device_ops[0], device_ops


def test_one_pole_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(8, device=cuda)
    with pytest.raises(GrError, match="complex pole"):
        ck.one_pole(x, 0.5j, torch.zeros((), device=cuda))
    with pytest.raises(GrError, match="float32 or"):
        ck.one_pole(x, 0.5, torch.zeros((), dtype=torch.complex64, device=cuda))
    with pytest.raises(GrError, match="shapes"):
        ck.one_pole(x, 0.5, torch.zeros(2, device=cuda))
    with pytest.raises(GrError, match="contiguous"):
        ck.one_pole(torch.zeros(8, 2, device=cuda).t(), 0.5, torch.zeros(2, device=cuda))


@pytest.mark.parametrize("dt,pole", [(torch.float32, 0.995), (torch.complex64, 0.995),
                                     (torch.complex64, 0.995 * np.exp(0.3j))])
def test_one_pole_apply_keeps_the_stream_type_on_card(cuda, dt, pole):
    """one_pole_apply on a float32 or complex64 card stream returns that
    type, as the CPU's path does, with the CPU's values within f32 rounding."""
    from gnuradio4_tpu_torch.ops.iir import one_pole_apply
    g = torch.Generator().manual_seed(47)
    x = torch.randn(3, 4096, dtype=dt, generator=g)
    s = torch.randn(3, dtype=dt, generator=g)
    y_cpu, last_cpu = one_pole_apply(x, pole, s)
    y, last = one_pole_apply(x.to(cuda), pole, s.to(cuda))
    assert y.dtype == last.dtype == y_cpu.dtype == last_cpu.dtype == dt
    scale = float(y_cpu.abs().max())
    assert float((y.cpu() - y_cpu).abs().max()) <= ONE_POLE_RTOL * scale
    assert float((last.cpu() - last_cpu).abs().max()) <= ONE_POLE_RTOL * scale


@pytest.mark.parametrize("dt", [torch.float64, torch.complex128])
def test_one_pole_apply_refuses_other_types_on_card(cuda, dt):
    """The card takes float32 and complex64 streams only: a wider type is
    refused, never narrowed, and so is a complex pole over a real stream."""
    from gnuradio4_tpu_torch.ops.iir import one_pole_apply
    x = torch.zeros(2, 4096, dtype=dt, device=cuda)
    with pytest.raises(GrError, match="float32 or"):
        one_pole_apply(x, 0.5, torch.zeros(2, dtype=dt, device=cuda))
    with pytest.raises(GrError, match="complex pole"):
        one_pole_apply(torch.zeros(4096, device=cuda), 0.5j,
                       torch.zeros((), device=cuda))
