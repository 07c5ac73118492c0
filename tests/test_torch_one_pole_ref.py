"""The plain version of the ``one_pole`` kernel (ops/cuda_kernels.py
``one_pole_ref``: the kernel's tiles, warp and block scans and tile carries in
PyTorch) against a float64 sequential loop, and the routing of ops/iir.py's
first-order sections: CPU tensors keep the blocked Toeplitz path and the
log-depth scan, and launch nothing.

The float64 loop is scipy's ``lfilter`` (a sequential loop in C) run with the
pole rounded as the kernel rounds it, so the comparison sees the arithmetic's
rounding alone. Shapes of [100] stop at T 131072 here (the card's tests in
tests/test_torch_kernels_cuda.py take [100, 2^20]).
"""

import numpy as np
import pytest
import torch

from gnuradio4_tpu_torch.blocks.sdr import FmDeemphasis
from gnuradio4_tpu_torch.core.block import BlockCtx
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import iir as tiir
from gnuradio4_tpu_torch.ops.demod import fm_deemphasis_coeffs

signal = pytest.importorskip("scipy.signal")

torch.set_num_threads(2)

# f32 rounding through stretches of 16, scans of 8 levels and a chain of up to
# 256 tile carries, against a float64 loop, relative to the largest |y|: at
# most 2.1e-06 measured (|p| 0.999999, T 2^20); a wrong power or carry is O(1)
ONE_POLE_RTOL = 1e-5
MAGNITUDES = (0.2, 0.76347, 0.995, 0.999999)   # 0.76347: fm's de-emphasis
LENGTHS = (1, 127, 4096, 131071, 131072, 1 << 20)
SHAPES = ((), (1,), (100,))
GRID = [(m, t, s) for m in MAGNITUDES for t in LENGTHS for s in SHAPES
        if not (s == (100,) and t > 131072)]


def one_pole_case(rng, shape, t, mag, cx):
    """(pole, x, state) as numpy: a real pole of magnitude ``mag`` or the
    complex one at angle 0.3 rad; unit-variance samples and state."""
    full = (*shape, t)
    x = rng.standard_normal(full).astype(np.float32)
    s = np.asarray(rng.standard_normal(shape), np.float32)
    if not cx:
        return mag, x, s
    x = (x + 1j * rng.standard_normal(full)).astype(np.complex64)
    s = np.asarray(s + 1j * rng.standard_normal(shape), np.complex64)
    return mag * np.exp(0.3j), x, s


def float64_loop(x, pole, state, cx):
    """u[n] = p·u[n−1] + x[n] in float64, p rounded to the stream's type;
    returns (u, u[..., −1])."""
    p = complex(np.complex64(pole)) if cx else float(np.float32(pole))
    x64 = x.astype(np.complex128 if cx else np.float64)
    zi = (p * state.astype(x64.dtype))[..., None]
    u, _ = signal.lfilter([1.0], [1.0, -p], x64, axis=-1, zi=zi)
    return u, u[..., -1]


def rel_err(got, want, scale) -> float:
    return float(np.max(np.abs(np.asarray(got) - want))) / scale


@pytest.mark.parametrize("cx", [False, True])
@pytest.mark.parametrize("mag,t,shape", GRID)
def test_one_pole_ref_matches_float64_loop(mag, t, shape, cx):
    rng = np.random.default_rng(int(1e6 * mag) + t + len(shape))
    pole, x, s = one_pole_case(rng, shape, t, mag, cx)
    y, last = ck.one_pole_ref(torch.from_numpy(x), pole, torch.from_numpy(s))
    want, want_last = float64_loop(x, pole, s, cx)
    assert y.shape == x.shape and last.shape == s.shape
    assert y.dtype == last.dtype == torch.from_numpy(x).dtype
    scale = float(np.max(np.abs(want)))
    assert rel_err(y, want, scale) <= ONE_POLE_RTOL
    assert rel_err(last, want_last, scale) <= ONE_POLE_RTOL


def test_one_pole_ref_gains_are_the_sections_epilogue():
    """gain_x·x + gain_u·u: one_pole_ba_apply's K and A in the same pass."""
    rng = np.random.default_rng(5)
    pole, x, s = one_pole_case(rng, (3,), 5000, 0.76347, False)
    xt = torch.from_numpy(x)
    u, _ = ck.one_pole_ref(xt, pole, torch.from_numpy(s))
    y, _ = ck.one_pole_ref(xt, pole, torch.from_numpy(s), 0.25, -1.5)
    torch.testing.assert_close(y, 0.25 * xt - 1.5 * u, rtol=0, atol=1e-5)


def test_one_pole_powers_are_float64_powers_of_the_rounded_pole():
    for pole, cx in ((0.76347, False), (0.97 * np.exp(0.3j), True)):
        pw = ck.one_pole_powers(pole, cx)
        p = np.complex64(pole) if cx else np.float32(pole)
        assert pw.shape == (ck.ONE_POLE_LEVELS,) and not pw.flags.writeable
        assert pw[0] == p
        for j in (1, 5, 12, 17):
            want = np.complex128(p) ** (2 ** j)
            assert pw[j] == (np.complex64(want) if cx else np.float32(want.real))


def test_one_pole_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    pole, x, s = one_pole_case(rng, (2,), 9000, 0.995, True)
    ck.reset_launch_counts()
    y, last = ck.one_pole(torch.from_numpy(x), pole, torch.from_numpy(s))
    y_ref, last_ref = ck.one_pole_ref(torch.from_numpy(x), pole, torch.from_numpy(s))
    assert torch.equal(y, y_ref) and torch.equal(last, last_ref)
    assert ck.launch_counts()["one_pole"] == 0
    meta = torch.empty(8, device="meta")
    with pytest.raises(GrError, match="CUDA"):
        ck.one_pole(meta, 0.5, torch.empty((), device="meta"))


@pytest.mark.parametrize("t,path", [(8192, "_one_pole_blocked"),
                                    (8191, "_one_pole_scan"),
                                    (1 << 17, "_one_pole_blocked")])
def test_cpu_tensors_keep_the_torch_path(monkeypatch, t, path):
    """one_pole_apply, one_pole_ba_apply and FmDeemphasis on CPU tensors reach
    ops/iir.py's blocked form (T ≥ 4096, T % 128 == 0) or its scan, and never
    the kernel's wrapper."""
    calls = []
    real = getattr(tiir, path)
    monkeypatch.setattr(tiir, path, lambda *a: calls.append(1) or real(*a))

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was reached on the CPU")

    monkeypatch.setattr(tiir, "one_pole", refuse)
    ck.reset_launch_counts()
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, t)).astype(np.float32))
    tiir.one_pole_apply(x, 0.76347, torch.zeros(2))
    b, a = fm_deemphasis_coeffs(50e3, 75e-6)
    tiir.one_pole_ba_apply(x, b, a, torch.zeros(2))
    blk = FmDeemphasis(tau=75e-6, sample_rate_in=50e3)
    ctx = BlockCtx(in_len={"in": t}, out_len={"out": t}, sample_rate=50e3,
                   params={}, channels={"in": 2, "out": 2})
    blk.apply(blk.init_state(ctx), {"in": x}, ctx)
    assert len(calls) >= 3
    assert ck.launch_counts()["one_pole"] == 0
