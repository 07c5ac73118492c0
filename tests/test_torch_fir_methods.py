"""Parity of the port's FIR lowerings (``fir_apply(method=...)``), the
polyphase interpolator and the one-matmul resampler against the JAX package,
on the CPU. The JAX package's ``pallas`` method runs its Pallas kernel in
interpret mode here, as its own tests run it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio4_tpu.ops import fir as jfir
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import fir as tfir

torch.set_num_threads(2)

# f32 accumulation over ≤ 48 taps of unit-variance samples, two summation
# orders: max|Δ| relative to the output RMS
RTOL = 1e-5
# FFT overlap-save against a direct sum: two 1024-point f32 transforms
FFT_RTOL = 1e-4
METHODS = ["auto", "conv", "fft", "matmul", "matmul_ilv", "pallas",
           "pallas_ilv"]


def _rms_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.sqrt(np.mean(np.abs(want) ** 2))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale if want.size else 0.0
    assert err <= rtol, err


def _data(rng, shape, cx):
    x = rng.standard_normal(shape)
    if cx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if cx else np.float32)


def _stream(pkg_fir, to, x_chunks, taps, hist, decim, method):
    """Every chunk through ``pkg_fir.fir_apply`` with the carried history."""
    st = to(hist)
    ys = []
    for x in x_chunks:
        y, st = pkg_fir.fir_apply(to(x), taps, st, decim=decim, method=method)
        ys.append(np.asarray(y))
    return np.concatenate(ys, -1), np.asarray(st)


@pytest.mark.parametrize("decim", [1, 2, 8])
@pytest.mark.parametrize("cx_taps", [False, True])
@pytest.mark.parametrize("cx_x", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_fir_method_matches_jax(rng, method, cx_x, cx_taps, decim):
    """Each method, real or complex stream and taps, decim 1/2/8, streamed over
    two chunks (the second continues the first's history)."""
    k = 37
    taps = _data(rng, k, cx_taps)
    chunks = [_data(rng, 1024, cx_x) for _ in range(2)]
    hist = _data(rng, k - 1, cx_x)
    want, st_j = _stream(jfir, jnp.asarray, chunks, taps, hist, decim, method)
    got, st_t = _stream(tfir, torch.from_numpy, chunks, taps, hist, decim,
                        method)
    _rms_close(got, want, FFT_RTOL if method == "fft" else RTOL)
    np.testing.assert_array_equal(st_t, st_j)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("method", METHODS)
def test_fir_method_multichannel_and_one_tap(rng, method):
    """[C, T] streams, and the one-tap filter every method routes to conv."""
    x = _data(rng, (3, 512), True)
    for taps, decim in ((_data(rng, 9, False), 1), (np.full(1, 0.5, np.float32), 4)):
        k = len(taps)
        hist = _data(rng, (3, k - 1), True)
        want, _ = jfir.fir_apply(jnp.asarray(x), taps, jnp.asarray(hist),
                                 decim=decim, method=method)
        got, st = tfir.fir_apply(torch.from_numpy(x), taps,
                                 torch.from_numpy(hist), decim=decim,
                                 method=method)
        _rms_close(got.numpy(), np.asarray(want),
                   FFT_RTOL if method == "fft" else RTOL)
        assert st.shape == (3, k - 1)


def test_fir_methods_raise_for_unported_rungs():
    """Every rung is ported now (tests/test_torch_precision.py holds each
    against the JAX package): ``matmul_int8`` and the rungs run and agree
    with the JAX package here; what still raises is an unknown method or
    rung, and an explicit rung the matmul path cannot take (K > 512), with
    the reference's message."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(64).astype(np.float32)
    taps = rng.standard_normal(5).astype(np.float32)
    st = np.zeros(4, np.float32)
    cases = [dict(method="matmul_int8"), dict(precision="int8")] + [
        dict(method="matmul", precision=r) for r in ("default", "high",
                                                     "bf16")]
    for kw in cases:
        want, _ = jfir.fir_apply(jnp.asarray(x), taps, jnp.asarray(st), **kw)
        got, _ = tfir.fir_apply(torch.from_numpy(x), taps,
                                torch.from_numpy(st), **kw)
        _rms_close(got.numpy(), np.asarray(want), RTOL)
    with pytest.raises(GrError, match="unknown method"):
        tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(st),
                       method="winograd")
    with pytest.raises(GrError, match="unknown precision"):
        tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(st),
                       precision="fp8")
    with pytest.raises(GrError, match="requires the matmul path"):
        tfir.fir_apply(torch.from_numpy(x), np.ones(513, np.float32),
                       torch.zeros(512), precision="bf16")


@pytest.mark.parametrize("method", ["pallas", "pallas_ilv", "auto"])
@pytest.mark.parametrize("cx", [True, False])
def test_cpu_pallas_method_takes_the_plain_version(rng, monkeypatch, method, cx):
    """``pallas``/``pallas_ilv``/``auto`` go to ``fir_banded`` for real and
    complex streams alike (the kernel on a CUDA tensor); on the CPU that is its
    plain version: no launch counted, the same numbers as ``matmul``."""
    routed = []
    banded = tfir.fir_banded
    monkeypatch.setattr(tfir, "fir_banded",
                        lambda *a: routed.append(a[0].dtype) or banded(*a))
    ck.reset_launch_counts()
    x = torch.from_numpy(_data(rng, 2048, cx))
    st = torch.zeros(36, dtype=x.dtype)
    taps = _data(rng, 37, False)
    a, _ = tfir.fir_apply(x, taps, st, method=method)
    assert routed == [x.dtype]
    b, _ = tfir.fir_apply(x, taps, st, method="matmul")
    assert torch.equal(a, b)
    assert ck.launch_counts()["fir_banded"] == 0
    if not cx:       # a real stream with matmul_ilv takes matmul, not the kernel
        c, _ = tfir.fir_apply(x, taps, st, method="matmul_ilv")
        assert routed == [x.dtype] and torch.equal(c, b)


@pytest.mark.parametrize("interp", [2, 3, 5])
@pytest.mark.parametrize("cx", [False, True])
def test_fir_interpolate_matches_jax(rng, interp, cx):
    taps = _data(rng, 16 * interp + 1, False)
    kp = -(-len(taps) // interp)
    chunks = [_data(rng, 700, cx) for _ in range(2)]
    st_j = jnp.asarray(_data(rng, kp - 1, cx))
    st_t = torch.from_numpy(np.asarray(st_j))
    for x in chunks:
        yj, st_j = jfir.fir_interpolate(jnp.asarray(x), taps, st_j, interp)
        yt, st_t = tfir.fir_interpolate(torch.from_numpy(x), taps, st_t, interp)
        assert yt.shape == (700 * interp,)
        _rms_close(yt.numpy(), np.asarray(yj), RTOL)
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


@pytest.mark.parametrize("interp,decim,t", [(3, 2, 1000), (2, 3, 999),
                                            (1, 4, 1024), (5, 4, 4096 + 12)])
@pytest.mark.parametrize("cx_x,cx_taps", [(False, False), (True, False),
                                          (True, True), (False, True)])
def test_fir_resample_matmul_matches_jax(rng, interp, decim, t, cx_x, cx_taps):
    """The one-matmul resampler, with a ragged last tile, the complex rails
    and complex taps."""
    taps = _data(rng, 16 * interp + 1, cx_taps)
    kp = -(-len(taps) // interp)
    xc = _data(rng, (2, kp - 1 + t), cx_x)
    want = np.asarray(jfir.fir_resample_matmul(jnp.asarray(xc), taps, interp,
                                               decim))
    got = tfir.fir_resample_matmul(torch.from_numpy(xc), taps, interp, decim)
    assert got.shape == (2, t * interp // decim)
    _rms_close(got.numpy(), want, RTOL)
