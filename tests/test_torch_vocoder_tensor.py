"""The port's CVSD vocoder (``blocks/vocoder.py``) and tensor helpers
(``ops/tensor.py``) against the JAX package's, on the CPU: every case of
``tests/test_vocoder.py`` runs the same seeded input through both packages,
and the JAX test's assertions hold on the port's result; the recursion's bits,
audio and state against the JAX scan; every helper of ``ops/tensor.py`` on
seeded inputs. Also the registry names and settings of the slice's 18 block
types, and that importing its modules loads neither ``jax`` nor the JAX
package.

Tolerances: CVSD bits and the carried ``run`` are exact, the audio and the
float32 state within 1e-6 (measured equal: the port computes
``est·accum_decay ± delta`` with one rounding, as XLA's fused multiply-add
does). The tensor helpers are float32 products and factorizations in both
packages: within 1e-5 of max(1, |y|), ``solve`` and ``lstsq`` within 1e-4
(LAPACK's pivoting and the SVD differ between the two libraries)."""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import vocoder as jvoc
from gnuradio4_tpu.ops import tensor as jten
from gnuradio4_tpu_torch.blocks import vocoder as voc
from gnuradio4_tpu_torch.ops import tensor as ten

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FS = 8000.0
AUDIO_ATOL = 1e-6
TENSOR_ATOL = 1e-5
SOLVE_ATOL = 1e-4
KW = dict(min_step=0.01, max_step=0.1, step_decay=0.98, accum_decay=0.97,
          runlength=3)


def _speech(band_hz, n=64000, seed=0):
    from scipy import signal as sig
    rng = np.random.default_rng(seed)
    b, a = sig.butter(4, band_hz / (FS / 2))
    x = sig.lfilter(b, a, rng.standard_normal(n))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _roundtrip(pkg, speech, block_len=8000):
    g = pkg.Graph()
    reg = pkg.global_registry
    enc = reg.create("CvsdEncoder")
    v, vb = reg.create("VectorSink"), reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=speech), enc,
                    reg.create("CvsdDecoder"), v)
    g.connect(enc, vb)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=FS, **kw).run_and_wait()
    return np.asarray(v.data()), np.asarray(vb.data())


def _both_roundtrip(speech, block_len=8000):
    """The round trip in both packages: bits exact, audio within AUDIO_ATOL."""
    out, bits = _roundtrip(gt, speech, block_len)
    want_out, want_bits = _roundtrip(gr, speech, block_len)
    assert out.dtype == bits.dtype == np.float32
    np.testing.assert_array_equal(bits, want_bits)
    assert out.shape == want_out.shape
    assert np.max(np.abs(out - want_out)) <= AUDIO_ATOL
    return out, bits


@functools.lru_cache(maxsize=None)
def _speech_roundtrip(band_hz, n=64000, block_len=8000):
    """:func:`_both_roundtrip` of ``_speech(band_hz, n)``, computed once for
    the cases that share it."""
    return _both_roundtrip(_speech(band_hz, n=n), block_len)


def _snr(ref, out, skip=2000):
    e = ref[skip:] - out[skip:len(ref)]
    return 10 * np.log10(np.mean(ref[skip:] ** 2) / np.mean(e ** 2))


class _S(dict):
    def get(self, k):
        return self[k]


def _scans(x, **kw):
    """The encoder then the decoder on ``x`` from the initial state, in both
    packages: (port bits, audio, states), (JAX's)."""
    import jax.numpy as jnp
    kw = {**KW, **kw}
    bt, st_e = voc.cvsd_encode_scan(torch.from_numpy(x), voc._init(_S(**kw)), **kw)
    at, st_d = voc.cvsd_decode_scan(bt, voc._init(_S(**kw)), **kw)
    bj, sj_e = jvoc.cvsd_encode_scan(jnp.asarray(x), jvoc._init(_S(**kw)), **kw)
    aj, sj_d = jvoc.cvsd_decode_scan(bj, jvoc._init(_S(**kw)), **kw)
    return (bt.numpy(), at.numpy(), st_e, st_d), \
        (np.asarray(bj), np.asarray(aj), sj_e, sj_d)


def _same_state(a, b):
    est, delta, run = a
    assert (est.dtype, delta.dtype, run.dtype) == (torch.float32, torch.float32,
                                                  torch.int32)
    assert est.shape == delta.shape == run.shape == ()
    assert abs(float(est) - float(b[0])) <= AUDIO_ATOL
    assert abs(float(delta) - float(b[1])) <= AUDIO_ATOL
    assert int(run) == int(b[2]) and np.asarray(b[2]).dtype == np.int32


@pytest.mark.parametrize("settings", [{}, {"runlength": 4, "max_step": 0.2},
                                      {"accum_decay": 0.995, "step_decay": 0.9,
                                       "min_step": 0.003}])
def test_scans_equal_bit_for_bit(settings):
    """Both directions on 6000 samples of speech, with three settings: the
    bits exact, the audio and the final states of both directions equal."""
    (bt, at, st_e, st_d), (bj, aj, sj_e, sj_d) = _scans(_speech(500.0, n=6000, seed=3),
                                                        **settings)
    np.testing.assert_array_equal(bt, bj)
    assert np.max(np.abs(at - aj)) <= AUDIO_ATOL
    np.testing.assert_array_equal(at, aj)     # measured: one rounding, as XLA
    _same_state(st_e, sj_e)
    _same_state(st_d, sj_d)


def test_scans_on_a_ramp_and_silence():
    """A slow ramp and digital silence (the estimate hunting by ±min_step):
    the inputs where a second rounding of ``est`` would flip a bit."""
    x = np.concatenate([np.linspace(-0.9, 0.9, 3000), np.zeros(1000),
                        np.full(500, 0.3)]).astype(np.float32)
    (bt, at, st_e, _), (bj, aj, sj_e, _) = _scans(x)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(at, aj)
    _same_state(st_e, sj_e)


class TestCvsd:
    def test_bits_binary_and_snr(self):
        speech = _speech(300.0)
        out, bits = _speech_roundtrip(300.0)
        assert set(np.unique(bits)) <= {0.0, 1.0}
        assert _snr(speech, out) > 10.0

    def test_snr_scales_with_oversampling(self):
        wide, _ = _speech_roundtrip(800.0)
        narrow, _ = _speech_roundtrip(300.0)
        assert _snr(_speech(300.0), narrow) > _snr(_speech(800.0), wide) + 3

    def test_decoder_mirrors_encoder_estimate(self):
        (_, audio, st_e, _), (_, aj, sj_e, _) = _scans(_speech(300.0, n=4000))
        assert abs(float(st_e[0]) - float(sj_e[0])) <= AUDIO_ATOL
        np.testing.assert_allclose(float(st_e[0]), audio[-1], atol=1e-6)
        np.testing.assert_allclose(np.asarray(sj_e[0]), aj[-1], atol=1e-6)

    def test_chunking_invariance(self):
        a, _ = _speech_roundtrip(300.0, n=24000, block_len=8000)
        b, _ = _speech_roundtrip(300.0, n=24000, block_len=1000)
        np.testing.assert_array_equal(a, b)

    def test_step_adapts_on_slope(self):
        x = np.concatenate([np.zeros(100), 0.8 * np.ones(400)]).astype(np.float32)
        out, bits = _both_roundtrip(x, block_len=500)
        assert out[160] > 0.5
        assert np.all(bits[100:110] == 1.0)


def test_state_dtypes_and_device():
    blk = gt.global_registry.create("CvsdEncoder")
    ctx = gt.BlockCtx(in_len={"in": 8}, out_len={"out": 8}, sample_rate=FS,
                      params={}, device=torch.device("cpu"))
    est, delta, run = blk.init_state(ctx)
    assert (est.dtype, delta.dtype, run.dtype) == (torch.float32, torch.float32,
                                                  torch.int32)
    assert float(delta) == np.float32(0.01) and int(run) == 1 and float(est) == 0.0
    st, out = blk.apply((est, delta, run), {"in": torch.zeros(0)}, ctx)
    assert out["out"].shape == (0,) and st[2] is run


# -- ops/tensor.py ---------------------------------------------------------------------

def _close(got, want, atol=TENSOR_ATOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.all(np.abs(got - want) <= atol * np.maximum(1.0, np.abs(want)))


def _arrs(*shapes, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s)
        if dtype == np.complex64:
            a = a + 1j * rng.standard_normal(s)
        out.append(a.astype(dtype))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_gemm_gemv_equal(dtype):
    import jax.numpy as jnp
    a, b, c, x, y = _arrs((5, 7), (7, 3), (5, 3), (7,), (5,), dtype=dtype)
    T = torch.from_numpy
    J = jnp.asarray
    if dtype == np.float32:
        _close(ten.gemm(T(a), T(b), alpha=0.5, beta=2.0, c=T(c)),
               jten.gemm(J(a), J(b), alpha=0.5, beta=2.0, c=J(c)))
        _close(ten.gemv(T(a), T(x), alpha=1.5, beta=-1.0, y=T(y)),
               jten.gemv(J(a), J(x), alpha=1.5, beta=-1.0, y=J(y)))
    _close(ten.gemm(T(a), T(b)), np.asarray(J(a) @ J(b)))
    _close(ten.gemv(T(a), T(x)), np.asarray(J(a) @ J(x)))
    # batched operands and an integer one (float32 accumulation)
    ab, bb = _arrs((2, 4, 6), (2, 6, 3), seed=1)
    _close(ten.gemm(T(ab), T(bb)), jten.gemm(J(ab), J(bb)))
    ai = np.arange(12, dtype=np.int32).reshape(3, 4)
    _close(ten.gemm(T(ai), T(ai.T.copy())), jten.gemm(J(ai), J(ai.T)))


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_norms_equal(axis):
    import jax.numpy as jnp
    for dtype in (np.float32, np.complex64):
        (a,) = _arrs((6, 5), seed=2, dtype=dtype)
        for name in ("norm_l1", "norm_l2", "norm_inf"):
            _close(getattr(ten, name)(torch.from_numpy(a), axis=axis),
                   getattr(jten, name)(jnp.asarray(a), axis=axis))
        _close(ten.frobenius(torch.from_numpy(a)), jten.frobenius(jnp.asarray(a)))


def test_outer_kron_power_equal():
    import jax.numpy as jnp
    x, y, a, b = _arrs((4,), (3,), (3, 3), (2, 2), seed=3)
    T, J = torch.from_numpy, jnp.asarray
    _close(ten.outer(T(x), T(y)), jten.outer(J(x), J(y)))
    _close(ten.outer(T(a), T(y)), jten.outer(J(a), J(y)))   # jnp.outer ravels
    _close(ten.kron(T(a), T(b)), jten.kron(J(a), J(b)))
    for n in (0, 1, 3, 6):
        _close(ten.matrix_power(T(a), n), jten.matrix_power(J(a), n))


def test_solve_lstsq_equal():
    import jax.numpy as jnp
    a, b, m, r = _arrs((5, 5), (5, 2), (8, 3), (8,), seed=4)
    a = a + 5 * np.eye(5, dtype=np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(ten.solve(T(a), T(b)), jten.solve(J(a), J(b)), SOLVE_ATOL)
    _close(ten.lstsq(T(m), T(r)), jten.lstsq(J(m), J(r)), SOLVE_ATOL)
    # rank-deficient: both give the minimum-norm solution
    md = np.concatenate([m, m[:, :1]], axis=1)
    _close(ten.lstsq(T(md), T(r)), jten.lstsq(J(md), J(r)), SOLVE_ATOL)


def test_float32_products_refuse_tf32():
    from gnuradio4_tpu_torch.core.errors import GrError
    a, b = _arrs((3, 3), (3, 3), seed=5)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for fn in (lambda: ten.gemm(torch.from_numpy(a), torch.from_numpy(b)),
                   lambda: ten.gemv(torch.from_numpy(a), torch.from_numpy(b[0])),
                   lambda: ten.lstsq(torch.from_numpy(a), torch.from_numpy(b)),
                   lambda: ten.matrix_power(torch.from_numpy(a), 2)):
            with pytest.raises(GrError, match="full float32"):
                fn()
    finally:
        torch.set_float32_matmul_precision(old)


# -- the slice's registry entries and imports ------------------------------------------

NEW_TYPES = {
    "reed_solomon": ("RsEncoder", "RsDecoder"),
    "ccsds": ("CcsdsFramer", "CcsdsDeframer"),
    "polar": ("PolarEncoder", "PolarDecoder"),
    "gnss": ("GnssAcquisition",),
    "ieee802154": ("Ieee802154Source", "Ieee802154Decoder"),
    "adsb": ("AdsbDecoder",),
    "pocsag": ("PocsagDecoder",),
    "apt": ("AptDecoder",),
    "dcf77": ("Dcf77Source", "Dcf77Decoder"),
    "wefax": ("WefaxSource", "WefaxDecoder"),
    "vocoder": ("CvsdEncoder", "CvsdDecoder"),
}
NEW_MODULES = ["gnuradio4_tpu_torch.blocks." + m for m in NEW_TYPES] + \
    ["gnuradio4_tpu_torch.ops." + m for m in ("polar", "gnss", "tensor")]


def _spec(blk):
    return {k: (s.kind, s.choices, s.unit, repr(s.default), s.limits)
            for k, s in blk.settings.spec.items()}


def test_new_types_carry_the_jax_names_and_settings():
    """The 18 block types of the slice: registered in both packages under the
    same module, with the same settings (kind, choices, unit, default,
    limits), current values, ports and port dtypes, ratio and alignment,
    FEED and WANTS_HOST_DATA (but GnssAcquisition, which keeps its IQ on the
    graph's device)."""
    names = [n for group in NEW_TYPES.values() for n in group]
    assert len(names) == 18
    for module, group in NEW_TYPES.items():
        mod = __import__(f"gnuradio4_tpu_torch.blocks.{module}", fromlist=["x"])
        for name in group:
            bj = gr.global_registry.create(name)
            bt = gt.global_registry.create(name)
            assert gt.global_registry.get(name) is getattr(mod, name)
            assert type(bt).__name__ == type(bj).__name__ == name
            assert _spec(bt) == _spec(bj), name
            assert {k: repr(bt.settings.get(k)) for k in bt.settings.spec} \
                == {k: repr(bj.settings.get(k)) for k in bj.settings.spec}, name
            for pt, pj in ((bt.in_ports, bj.in_ports), (bt.out_ports, bj.out_ports)):
                assert [(p.name, p.dtype) for p in pt] \
                    == [(p.name, p.dtype) for p in pj], name
            assert (bt.ratio, bt.alignment) == (bj.ratio, bj.alignment), name
            assert getattr(bt, "FEED", False) == getattr(bj, "FEED", False)
            if name != "GnssAcquisition":
                assert getattr(bt, "WANTS_HOST_DATA", True) \
                    == getattr(bj, "WANTS_HOST_DATA", True), name
    assert gt.global_registry.create("GnssAcquisition").WANTS_HOST_DATA is False


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, importlib\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'gnuradio4_tpu' or k.startswith('gnuradio4_tpu.'))\n"
            "assert not bad, bad\n"
            "import gnuradio4_tpu_torch as gt\n"
            "assert all(gt.global_registry.contains(n) for n in "
            f"{[n for g in NEW_TYPES.values() for n in g]!r})\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "clean", r.stderr
