"""The precision ladder of the port against the JAX package, on the CPU:
``fir_apply`` at every rung, FirFilter's ``precision`` setting, and the
matmul FFT engines, on the same seeded inputs. On the CPU both packages give
their CPU results: ``default``/``high``/``highest`` are exact float32,
``bf16`` is bf16-rounded operands with float32 sums, ``int8`` is exact
integer sums (the quantized integers are held equal). Agreement: within
``PEAK_TOL`` = 1e-6 of the output's peak.

The card's formulation of each rung (``ops/precision.py`` ``card_dot``: one
bf16 tensor-core pass for ``default``/``bf16``, bf16×3 for ``high``; int8
through ``torch._int_mm``), emulated on the CPU by putting ``card_dot`` in
``rung_dot``'s place, is held against a float64 direct sum at the JAX
package's contracts (``tests/test_fir_methods.py``):
``high`` ≥ 90 dB, ``bf16`` and ``default`` > 45 dB, ``int8`` > 40 dB for a
real stream and > 38 dB for a complex one. An input whose every partial
sum is exact in float32 tells the rungs apart by exact values, so a rung
that ran at another precision cannot pass. The card itself runs them in
``chip_smoke.py`` phase 22; the ``cuda`` cases here skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu.ops import fft as jfft
from gnuradio4_tpu.ops import fir as jfir
from gnuradio4_tpu_torch.core.errors import GrError as TGrError
from gnuradio4_tpu_torch.ops import cuda_kernels as tck
from gnuradio4_tpu_torch.ops import fft as tfft
from gnuradio4_tpu_torch.ops import fir as tfir
from gnuradio4_tpu_torch.ops import precision as tprec

torch.set_num_threads(2)

PEAK_TOL = 1e-6
RUNGS = ["default", "high", "highest", "bf16", "int8"]
CONTRACT_DB = {"high": 90.0, "bf16": 45.0, "default": 45.0}
INT8_DB = {False: 40.0, True: 38.0}     # by complex stream


def _stream(rng, n, cx, ch=0):
    shape = (n,) if ch == 0 else (ch, n)
    x = rng.standard_normal(shape)
    if cx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if cx else np.float32)


def _taps(rng, k, cx):
    t = rng.standard_normal(k) / np.sqrt(k)
    if cx:
        t = t + 1j * rng.standard_normal(k) / np.sqrt(k)
    return t.astype(np.complex64 if cx else np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= PEAK_TOL * peak, \
        np.abs(got - want).max() / peak


def _direct(x, taps, hist, decim):
    """float64 direct-form FIR over [hist, x], decimated."""
    k = taps.shape[-1]
    xc = np.concatenate([hist, x], axis=-1).astype(np.complex128)
    h = taps.astype(np.complex128)
    t = x.shape[-1]
    rows = xc.reshape(-1, xc.shape[-1])
    y = np.stack([np.convolve(r, h)[k - 1:k - 1 + t] for r in rows])
    return y.reshape(*x.shape[:-1], t)[..., ::decim]


def _snr_db(y, ref):
    err = np.sum(np.abs(np.asarray(y, np.complex128) - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("cx_x,cx_t", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_apply_rungs_agree(rung, cx_x, cx_t, decim):
    rng = np.random.default_rng(17)
    k = 31
    x = _stream(rng, 1024, cx_x, ch=2)
    taps = _taps(rng, k, cx_t)
    hist = _stream(rng, k - 1, cx_x, ch=2)
    yj, sj = jfir.fir_apply(jnp.asarray(x), taps, jnp.asarray(hist),
                            decim=decim, precision=rung)
    yt, stt = tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                             decim=decim, precision=rung)
    _close(yt.numpy(), yj)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))


@pytest.mark.parametrize("cx", [False, True])
def test_int8_integers_equal(cx):
    """The row quantization of the frames (and so every int32 sum) is the
    JAX package's, integer for integer."""
    rng = np.random.default_rng(23)
    frames = (rng.standard_normal((3, 40, 191)) * np.exp(
        rng.standard_normal((3, 40, 1)))).astype(np.float32)
    if cx:
        frames[:, 5] = 0.0                      # an all-zero row
    row_max = jnp.max(jnp.abs(frames), axis=-1, keepdims=True)
    row_scale = jnp.maximum(row_max / 127.0, 1e-20)
    want = np.asarray(jnp.round(frames / row_scale).astype(jnp.int8))
    q, s = tprec.quant_rows(torch.from_numpy(frames))
    np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(s.numpy(), np.asarray(row_scale))
    w = rng.integers(-127, 128, (191, 24)).astype(np.int8)
    acc = tprec.int8_mm(q.reshape(-1, 191), torch.from_numpy(w))
    np.testing.assert_array_equal(
        acc.numpy(), want.reshape(-1, 191).astype(np.int64) @ w)


@pytest.mark.parametrize("method", ["matmul", "matmul_int8"])
@pytest.mark.parametrize("cx", [False, True])
def test_matmul_methods_agree(method, cx):
    rng = np.random.default_rng(29)
    x = _stream(rng, 2048, cx)
    taps = _taps(rng, 63, False)
    hist = np.zeros(62, x.dtype)
    yj, _ = jfir.fir_apply(jnp.asarray(x), taps, jnp.asarray(hist), decim=8,
                           method=method)
    yt, _ = tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                           decim=8, method=method)
    _close(yt.numpy(), yj)


@pytest.mark.parametrize("env", ["bf16", "default", "highest", "int8"])
def test_process_wide_mode_is_read_live(monkeypatch, env):
    """GR4TPU_FIR_PRECISION sets the rung of ``method='matmul'`` with no
    explicit rung, read when the call runs, in both packages."""
    monkeypatch.setenv("GR4TPU_FIR_PRECISION", env)
    rng = np.random.default_rng(31)
    x = _stream(rng, 1024, True)
    taps = _taps(rng, 31, False)
    hist = np.zeros(30, np.complex64)
    yj, _ = jfir.fir_apply(jnp.asarray(x), taps, jnp.asarray(hist),
                           method="matmul")
    yt, _ = tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                           method="matmul")
    _close(yt.numpy(), yj)
    rung = {"int8": "highest"}.get(env, env)
    ye, _ = tfir.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist),
                           method="matmul", precision=rung)
    np.testing.assert_array_equal(yt.numpy(), ye.numpy())


def test_default_process_wide_rung_is_highest(monkeypatch):
    """The port's default rung is ``highest`` (the JAX package's is
    ``high``, the same numbers on the CPU): nothing an earlier path ran
    changes precision on the card."""
    monkeypatch.delenv("GR4TPU_FIR_PRECISION", raising=False)
    assert tfir._live_mode() == "highest"
    assert tfir._rung(None) == tfir._rung("auto") == "highest"


@pytest.mark.parametrize("taps_kind", ["long", "tensor"])
def test_unsatisfiable_rung_raises_the_reference_message(taps_kind):
    rng = np.random.default_rng(37)
    x = _stream(rng, 2048, False)
    k = 600 if taps_kind == "long" else 31
    taps = _taps(rng, k, False)
    hist = np.zeros(k - 1, np.float32)
    tj = jnp.asarray(taps) if taps_kind == "tensor" else taps
    tt = torch.from_numpy(taps) if taps_kind == "tensor" else taps
    with pytest.raises(JGrError) as ej:
        jfir.fir_apply(jnp.asarray(x), tj, jnp.asarray(hist), precision="bf16")
    with pytest.raises(TGrError) as et:
        tfir.fir_apply(torch.from_numpy(x), tt, torch.from_numpy(hist),
                       precision="bf16")
    # the reference's message; its advice names the port's own default
    # lowering (the banded kernel, where the JAX package names fft/conv)
    cut = "Drop the explicit precision setting"
    assert et.value.args[0].split(cut)[0] == ej.value.args[0].split(cut)[0]
    assert cut in et.value.args[0]


# FreqXlatingFir rotates its input first, where the two packages' NCOs differ
# in the last float32 bit; a bf16 or int8 rung would round that difference up
# to its own quantum, so the rotating case runs the float32-class rungs
_BLOCK_CASES = [(r, c) for r in ["auto"] + RUNGS
                for c in ("config1", "audio")] + [
    (r, "xlating") for r in ("auto", "default", "high", "highest")]


@pytest.mark.parametrize("rung,cfg", _BLOCK_CASES)
def test_fir_filter_blocks_agree(rung, cfg):
    """FirFilter / FreqXlatingFir with ``precision=rung`` through both
    schedulers: config 1's c64 × f32 K 127 filter (cut to 2^13 samples), the
    chain's audio FIR (f32, K 63, ÷8), and a rotating FreqXlatingFir."""
    rng = np.random.default_rng(41)
    if cfg == "config1":
        x = _stream(rng, 1 << 13, True)
        taps = _taps(rng, 127, False)
        kw = dict(decim=1)
        btype = "FirFilter"
    elif cfg == "xlating":
        x = _stream(rng, 1 << 13, True)
        taps = _taps(rng, 127, False)
        kw = dict(center_freq=0.1, sample_rate_in=1.0, decim=1)
        btype = "FreqXlatingFir"
    else:
        x = _stream(rng, 1 << 13, False)
        taps = _taps(rng, 63, False)
        kw = dict(decim=8)
        btype = "FirFilter"
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=x)
        fir = g.emplace(btype, taps=taps, precision=rung, **kw)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fir, snk)
        skw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=2048, **skw).run_and_wait()
        outs.append(snk.data())
    _close(outs[1], outs[0])


@pytest.mark.parametrize("engine", ["matmul", "matmul_exact", "matmul_bf16"])
@pytest.mark.parametrize("block", ["FFT", "IFFT"])
def test_fft_engines_agree(engine, block):
    rng = np.random.default_rng(43)
    x = _stream(rng, 4 * 1024, True)
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=x)
        kw = dict(window="none", output="complex", calibrate=False) \
            if block == "FFT" else {}
        f = g.emplace(block, fft_size=1024, engine=engine, **kw)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, f, snk)
        skw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=2048, **skw).run_and_wait()
        outs.append(snk.data())
    _close(outs[1], outs[0])


@pytest.mark.parametrize("mode", ["highest", "high", "bf16"])
@pytest.mark.parametrize("real", [False, True])
def test_matmul_fft_rungs_agree(mode, real):
    rng = np.random.default_rng(47)
    x = _stream(rng, 3 * 4096, not real).reshape(3, 4096)
    yj = jfft.matmul_fft(jnp.asarray(x), 4096, mode=mode)
    yt = tfft.matmul_fft(torch.from_numpy(x), 4096, mode=mode)
    _close(yt.numpy(), yj)


# -- the card's formulation, emulated on the CPU, at the dB contracts --------

@pytest.mark.parametrize("rung", ["default", "high", "bf16", "int8"])
@pytest.mark.parametrize("shape", ["config1", "audio"])
def test_card_formulation_meets_contract(monkeypatch, rung, shape):
    monkeypatch.setattr(tck, "rung_dot", tprec.card_dot)
    rng = np.random.default_rng(53)
    if shape == "config1":       # c64 × f32 K 127 (config 1, cut to 2^14)
        x, taps, decim = _stream(rng, 1 << 14, True), _taps(rng, 127, False), 1
    else:                        # the chain's audio FIR: f32, K 63, ÷8
        x, taps, decim = _stream(rng, 1 << 14, False), _taps(rng, 63, False), 8
    hist = _stream(rng, taps.shape[-1] - 1, x.dtype == np.complex64)
    ref = _direct(x, taps, hist, decim)
    xt, ht = torch.from_numpy(x), torch.from_numpy(hist)
    if rung == "int8":
        y, _ = tfir.fir_apply(xt, taps, ht, decim=decim, precision="int8")
        bound = INT8_DB[x.dtype == np.complex64]
    else:
        y = tck.fir_banded_ref(xt, ht, taps, decim, mode=rung)
        bound = CONTRACT_DB[rung]
    assert _snr_db(y.numpy(), ref) > bound


@pytest.mark.parametrize("mode,bound", [("high", 90.0), ("bf16", 45.0)])
def test_card_fft_formulation_meets_contract(monkeypatch, mode, bound):
    monkeypatch.setattr(tfft, "rung_dot", tprec.card_dot)
    rng = np.random.default_rng(59)
    x = _stream(rng, 8 * 4096, True).reshape(8, 4096)
    y = tfft.matmul_fft(torch.from_numpy(x), 4096, mode=mode)
    assert _snr_db(y.numpy(), np.fft.fft(x.astype(np.complex128))) > bound


def test_high_card_form_is_not_float32():
    """bf16×3 differs from the exact float32 product (the card runs three
    bf16 passes, never a float32 matmul under another name), and one pass
    differs from three."""
    rng = np.random.default_rng(61)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 32)).astype(np.float32))
    exact = (a.double() @ w.double()).numpy()
    hi = tprec.card_dot(a, w, "high").numpy()
    one = tprec.card_dot(a, w, "bf16").numpy()
    f32 = tprec.rung_dot(a, w, "high").numpy()
    assert not np.array_equal(hi, f32)
    assert np.abs(one - exact).max() > 10 * np.abs(hi - exact).max()


# c = 1 + 2^-9 splits into bf16 hi = 1 and lo = 2^-9; over K = 16 every
# partial sum of every pass is exact in float32, in any order, so each rung
# has one exact value: full float32 (TF32 too) 16·c², bf16×3 16·(1 + 2^-8),
# one bf16 pass 16
PROBE_K = 16
PROBE_C = 1.0 + 2.0 ** -9
PROBE = {"highest": 16.0 + 2.0 ** -4 + 2.0 ** -14, "high": 16.0 + 2.0 ** -4,
         "default": 16.0, "bf16": 16.0}


def _probe(device):
    a = torch.full((32, PROBE_K), PROBE_C, dtype=torch.float32, device=device)
    w = torch.full((PROBE_K, 16), PROBE_C, dtype=torch.float32, device=device)
    return a, w


@pytest.mark.parametrize("rung", list(PROBE))
def test_card_form_probe_values(rung):
    a, w = _probe("cpu")
    y = tprec.card_dot(a, w, rung)
    assert torch.all(y == PROBE[rung]), (rung, y[0, 0].item())
    cpu = {"default": PROBE["highest"], "high": PROBE["highest"]}
    assert torch.all(tprec.rung_dot(a, w, rung) == cpu.get(rung, PROBE[rung]))


@pytest.mark.cuda
@pytest.mark.parametrize("rung", list(PROBE))
def test_card_rungs_give_their_probe_values(rung):
    """On the card each rung gives its own exact value: none runs at full
    float32 (or TF32) in another rung's place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, w = _probe("cuda")
    y = tprec.rung_dot(a, w, rung).cpu()
    assert torch.all(y == PROBE[rung]), (rung, y[0, 0].item())


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["default", "high", "bf16"])
def test_card_rungs_match_their_emulation(rung):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(67)
    a = torch.from_numpy(rng.standard_normal((256, 192)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((192, 64)).astype(np.float32))
    got = tprec.rung_dot(a.cuda(), w.cuda(), rung).cpu().numpy()
    emu = tprec.card_dot(a, w, rung).numpy()
    np.testing.assert_allclose(got, emu, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("env", ["bf16", "default", "high", "highest", "int8"])
@pytest.mark.parametrize("cx", [False, True])
def test_resampler_matmul_reads_the_live_rung(monkeypatch, env, cx):
    """The one-matmul rational resampler multiplies at GR4TPU_FIR_PRECISION's
    rung, read when the call runs, as the JAX package's ``_banded_dot``
    does: RationalResamplerKernel(3, 2) with 48 N(0, 1) taps on 4096
    samples, two calls with the state carried, within PEAK_TOL of the JAX
    package's peak (before the repair ``bf16`` differed by 3.0e-3)."""
    from gnuradio4_tpu.ops.resample import RationalResamplerKernel as JR
    from gnuradio4_tpu_torch.ops.resample import RationalResamplerKernel as TR
    monkeypatch.setenv("GR4TPU_FIR_PRECISION", env)
    rng = np.random.default_rng(41)
    taps = rng.standard_normal(48)
    jr, tr = JR(3, 2, taps), TR(3, 2, taps)
    sj, st = jr.init_state(0, np.complex64 if cx else np.float32), \
        tr.init_state(0, np.complex64 if cx else np.float32)
    for _ in range(2):
        x = _stream(rng, 4096, cx)
        yj, sj = jr.apply(jnp.asarray(x), sj, method="matmul")
        yt, st = tr.apply(torch.from_numpy(x), st, method="matmul")
        _close(yt.numpy(), yj)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
