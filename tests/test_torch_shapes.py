"""The shapes the port's FIR and IIR kernels take at any size, on the CPU:
FirFilter at decimations of 1024 and 2048 and IirFilter(engine="pallas") with
17 biquad sections, each against the JAX package (its Pallas kernel in
interpret mode); the plain FIR and fused FIR→demod at those shapes against
float64 sums; and the device default, which is the card and never falls
back to the CPU.

Inputs come from a NumPy seed and go through both packages. Tolerances are
stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio4_tpu.core.block import BlockCtx as JBlockCtx
from gnuradio4_tpu.blocks.filter import FirFilter as JFirFilter
from gnuradio4_tpu.blocks.filter import IirFilter as JIirFilter

import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.block import BlockCtx as TBlockCtx
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.blocks.filter import FirFilter as TFirFilter
from gnuradio4_tpu_torch.blocks.filter import IirFilter as TIirFilter
from gnuradio4_tpu_torch.ops import cuda_kernels as ck
from gnuradio4_tpu_torch.ops import filter_design as tfd

torch.set_num_threads(2)

# f32 FIR sums of ≤ 63 taps against another order of the same sums, relative
# to the output's RMS
FIR_RTOL = 1e-5
# f32 biquad recursions in the same update order, relative to the RMS, over
# 17 cascaded sections: the high-Q sections (poles at |p| = 0.957) amplify
# each side's rounding (XLA and PyTorch contract products into FMAs at
# different places); 2.4e-5 measured
IIR_RTOL = 1e-4


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


def _close(got, want, rtol):
    """max|got − want| ≤ rtol·max(RMS(want), 1e-3)."""
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.sqrt(np.mean(np.abs(want) ** 2))), 1e-3)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _run_both(make, chunks, out_len, dtype, rtol):
    """The block from ``make(jax_side)`` in both packages over ``chunks`` with
    its state carried: outputs and final states compared."""
    n = chunks[0].shape[-1]
    ctx = dict(in_len={"in": n}, out_len={"out": out_len}, sample_rate=48e3,
               params={}, channels={"in": 0, "out": 0},
               dtypes={"in": np.dtype(dtype)})
    bj, bt = make(True), make(False)
    cj, ct = JBlockCtx(**ctx), TBlockCtx(**ctx)
    sj, st = bj.init_state(cj), bt.init_state(ct)
    yj, yt = [], []
    for x in chunks:
        sj, oj = bj.apply(sj, {"in": jnp.asarray(x)}, cj)
        st, ot = bt.apply(st, {"in": torch.from_numpy(x)}, ct)
        yj.append(np.asarray(oj["out"]))
        yt.append(ot["out"].numpy())
    _close(np.concatenate(yt, -1), np.concatenate(yj, -1), rtol)
    _close(st.numpy(), np.asarray(sj), rtol)


@pytest.mark.parametrize("dtype,decim", [(np.complex64, 1024),
                                         (np.float32, 2048)])
def test_fir_filter_large_decimation_matches_jax(rng, dtype, decim):
    """FirFilter(63 taps) at a decimation above the old staging limit (935 for
    a complex stream, 1871 for a real one), three steps of 8 outputs."""
    taps = tfd.design_fir("lowpass", 63, sample_rate=48e3, f_low=10).astype(np.float32)
    n = 8 * decim
    chunks = []
    for _ in range(3):
        x = rng.standard_normal(n)
        if dtype == np.complex64:
            x = x + 1j * rng.standard_normal(n)
        chunks.append(x.astype(dtype))
    make = lambda jax_side: (JFirFilter if jax_side else TFirFilter)(
        taps=taps, decim=decim)
    _run_both(make, chunks, n // decim, dtype, FIR_RTOL)


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_iir_filter_pallas_17_sections_matches_jax(rng, n_chunks):
    """IirFilter(engine="pallas") of Butterworth order 33 (17 sections, one
    more than a launch of the card's kernel unrolls) against the JAX
    package's Pallas kernel in interpret mode."""
    res = tfd.design_iir("butterworth", "lowpass", 33, sample_rate=48e3,
                         f_low=15e3)
    assert tfd.ba_to_sos(res.b, res.a).shape[0] == 17
    chunks = [rng.standard_normal(256).astype(np.float32) for _ in range(n_chunks)]
    make = lambda jax_side: (JIirFilter if jax_side else TIirFilter)(
        b=res.b, a=res.a, engine="pallas")
    ck.reset_launch_counts()
    _run_both(make, chunks, 256, np.float32, IIR_RTOL)
    assert ck.iir_sos.launches == 0          # the CPU takes the plain version


def _direct(xc, taps, decim, m):
    """float64 direct sums y[m] = Σ_k h[k]·xc[m·decim + K−1−k]."""
    k = len(taps)
    idx = np.arange(m)[:, None] * decim + (k - 1) - np.arange(k)[None, :]
    return (xc[..., idx] * taps.astype(np.complex128)).sum(-1)


@pytest.mark.parametrize("decim,k,t", [(1024, 63, 1024 * 9 + 5),
                                       (2048, 63, 2048 * 4),
                                       (1, 4100, 300)])
def test_fir_banded_ref_at_the_new_shapes_matches_float64(rng, decim, k, t):
    """The plain FIR (the CPU path of fir_banded) at large decimation and a
    tap count whose Toeplitz band spans several tiles, against float64 direct
    sums; f32 accumulation over k taps of unit-variance samples, relative to
    the RMS."""
    taps = (rng.standard_normal(k) + 1j * rng.standard_normal(k)).astype(np.complex64)
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    hist = (rng.standard_normal(k - 1) + 1j * rng.standard_normal(k - 1)).astype(np.complex64)
    y = ck.fir_banded(torch.from_numpy(x), torch.from_numpy(hist), taps, decim)
    xc = np.concatenate([hist, x]).astype(np.complex128)
    want = _direct(xc, taps, decim, t // decim)
    assert y.shape == (t // decim,)
    _close(y.numpy().astype(np.complex128), want, 2e-6 * np.sqrt(k))


def test_fir_demod_ref_at_large_decimation_matches_float64(rng):
    """The plain fused FIR→demod (the CPU path of fir_demod) at decim 1024:
    gain·arg(v[m]·conj v[m−1]) from float64 FIR sums, wrapped into (−π, π]."""
    k, decim, t = 63, 1024, 1024 * 12
    taps = tfd.design_fir("lowpass", k, sample_rate=48e3, f_low=10).astype(np.float32)
    phase = np.cumsum(rng.standard_normal(t + k - 1)) * 0.1
    xc = np.exp(1j * phase).astype(np.complex64)
    prev = np.complex64(0.6 + 0.8j)
    y = ck.fir_demod(torch.from_numpy(xc), taps, decim,
                     torch.tensor(prev), 1.5).numpy()
    v = _direct(xc.astype(np.complex128), taps, decim, t // decim)
    want = 1.5 * np.angle(v * np.conj(np.concatenate([[prev], v[:-1]])))
    d = np.remainder(y / 1.5 - want / 1.5 + np.pi, 2 * np.pi) - np.pi
    # atan2 of f32 sums of 63 unit-modulus samples
    assert y.shape == (t // decim,) and float(np.max(np.abs(d))) <= 1e-5


def test_default_device_raises_without_a_card(monkeypatch):
    """With no CUDA device, device=None raises and names device="cpu"; the
    CPU is run only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(GrError, match='device="cpu"'):
        gt.default_device()
    g = gt.Graph()
    g.connect(g.emplace("NullSource"), g.emplace("NullSink"))
    with pytest.raises(GrError, match='device="cpu"'):
        gt.compile_graph(g, block_len=64)
    with pytest.raises(GrError, match='device="cpu"'):
        gt.Scheduler(g, block_len=64)
    s = gt.Scheduler(g, block_len=64, device="cpu")
    assert s.device == torch.device("cpu")


def test_default_device_is_the_card_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert gt.default_device() == torch.device("cuda")
