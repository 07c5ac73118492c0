"""The port's polar codes (``ops/polar.py``, ``blocks/polar.py``) against the
JAX package's, on the CPU: every case of ``tests/test_polar.py`` runs the
same seeded input through both packages, and the JAX test's assertions hold
on the port's result; PolarEncoder (torch butterflies) and PolarDecoder (a
host call inside the step) through both schedulers at several block lengths
and on two-channel input.

Tolerance: none. Frozen masks, codewords and decoded bits are compared
exactly: the encoder adds 0/1 values mod 2 in float32, which is exact."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu.ops import polar as jpolar
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.ops import polar
from gnuradio4_tpu_torch.ops.polar import (encode, frozen_mask, polar_decode,
                                           polar_encode)

torch.set_num_threads(2)

PKGS = {"jax": (gr, jpolar), "port": (gt, polar)}


def _both(fn):
    got = {k: fn(*mods) for k, mods in PKGS.items()}
    a, b = got["port"], got["jax"]
    if isinstance(b, tuple):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
    return a


def _sched(pkg, g, block_len):
    kw = {"device": "cpu"} if pkg is gt else {}
    return pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw)


def _run(pkg, btype, data, block_len, **settings):
    g = pkg.Graph()
    reg = pkg.global_registry
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=data),
                    reg.create(btype, **settings), snk)
    _sched(pkg, g, block_len).run_and_wait()
    return np.asarray(snk.data())


@pytest.mark.parametrize("n, k", [(8, 4), (32, 8), (64, 32), (256, 128),
                                  (1024, 300)])
def test_frozen_masks_equal(n, k):
    m = frozen_mask(n, k)
    assert m.dtype == bool
    np.testing.assert_array_equal(m, jpolar.frozen_mask(n, k))


class TestConstruction:
    def test_butterfly_involution(self):
        u = np.random.default_rng(0).integers(0, 2, (4, 256)).astype(np.uint8)
        x = _both(lambda _, m: m.encode(u))
        np.testing.assert_array_equal(encode(x), u)

    def test_frozen_count_and_known_n8_set(self):
        fr = _both(lambda _, m: m.frozen_mask(8, 4))
        assert fr.sum() == 4
        np.testing.assert_array_equal(np.flatnonzero(~fr), [3, 5, 6, 7])

    def test_bad_params(self):
        for fm, err in ((frozen_mask, GrError), (jpolar.frozen_mask, JGrError)):
            with pytest.raises(err, match="power of two"):
                fm(100, 50)
            with pytest.raises(err, match="0 < K < N"):
                fm(64, 64)

    def test_sc_close_to_ml_n32(self):
        def f(_, m):
            N, K = 32, 8
            fr = m.frozen_mask(N, K)
            rng = np.random.default_rng(1)
            msgs = [np.array([(v >> i) & 1 for i in range(K)], np.uint8)
                    for v in range(256)]
            cws = np.stack([m.polar_encode(v, fr) for v in msgs])
            err_sc = err_ml = 0
            decs = []
            for _ in range(200):
                mi = rng.integers(256)
                y = 1.0 - 2.0 * cws[mi] + 0.9 * rng.standard_normal(N)
                dec = m.polar_decode(2 * y / 0.81, fr)
                decs.append(dec)
                err_sc += not np.array_equal(dec, msgs[mi])
                d = np.sum((y[None, :] - (1.0 - 2.0 * cws)) ** 2, axis=1)
                err_ml += int(np.argmin(d) != mi)
            return np.stack(decs), np.array([err_sc, err_ml])
        _, (err_sc, err_ml) = _both(f)
        assert err_sc <= err_ml + 0.05 * 200


class TestDecode:
    def test_clean_roundtrip(self):
        rng = np.random.default_rng(2)
        bits = rng.integers(0, 2, 10 * 128).astype(np.uint8)

        def f(_, m):
            fr = m.frozen_mask(256, 128)
            cw = m.polar_encode(bits, fr)
            return m.polar_decode(8.0 * (1.0 - 2.0 * cw.astype(np.float64)), fr)
        np.testing.assert_array_equal(_both(f), bits)

    @pytest.mark.parametrize("N", [64, 256])
    def test_coding_gain_at_3db(self, N):
        def f(_, m):
            rng = np.random.default_rng(0)
            K = N // 2
            fr = m.frozen_mask(N, K)
            bits = rng.integers(0, 2, 20 * K).astype(np.uint8)
            cw = m.polar_encode(bits, fr)
            sigma = np.sqrt(1.0 / (2 * 10 ** 0.3 * 0.5))
            y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(len(cw))
            dec = m.polar_decode(2 * y / sigma ** 2, fr)
            return bits, cw, y, dec
        bits, cw, y, dec = _both(f)
        raw = np.mean((y < 0) != cw)
        assert raw > 0.04 and np.mean(dec != bits) < raw / 2


class TestBlocks:
    def test_device_encoder_matches_host(self):
        rng = np.random.default_rng(2)
        N, K = 256, 128
        bits = rng.integers(0, 2, 8 * K).astype(np.float32)
        host = polar_encode(bits.astype(np.uint8), frozen_mask(N, K)).astype(np.float32)
        out = _both(lambda pkg, _: _run(pkg, "PolarEncoder", bits, 2 * K, n=N, k=K))
        np.testing.assert_array_equal(out, host)

    def test_decoder_block_cleans_channel(self):
        rng = np.random.default_rng(3)
        N, K = 256, 128
        fr = frozen_mask(N, K)
        bits = rng.integers(0, 2, 8 * K).astype(np.uint8)
        cw = polar_encode(bits, fr)
        sigma = 0.65
        y = 1.0 - 2.0 * cw + sigma * rng.standard_normal(len(cw))
        llr = (2 * y / sigma ** 2).astype(np.float32)
        assert np.mean((y < 0) != cw) > 0.03
        out = _both(lambda pkg, _: _run(pkg, "PolarDecoder", llr, 2 * N, n=N, k=K))
        np.testing.assert_array_equal(out, bits.astype(np.float32))

    def test_rate_properties(self):
        for pkg in (gt, gr):
            e = pkg.Graph().emplace("PolarEncoder", n=128, k=64)
            d = pkg.Graph().emplace("PolarDecoder", n=128, k=64)
            assert e.alignment == 64 and d.alignment == 128
            assert float(e.ratio) * float(d.ratio) == 1.0


@pytest.mark.parametrize("block_len", [64, 1000, 4096])
@pytest.mark.parametrize("n, k", [(64, 32), (256, 100)])
def test_encoder_decoder_equal_across_steps(block_len, n, k):
    """Encoder then a noisy decoder at block lengths below, across and above
    a frame, both packages: codewords and decoded bits equal."""
    rng = np.random.default_rng(n + block_len)
    bits = rng.integers(0, 2, 12 * k).astype(np.float32)
    cw = _both(lambda pkg, _: _run(pkg, "PolarEncoder", bits, block_len, n=n, k=k))
    llr = ((1.0 - 2.0 * cw) * 4.0 + 2.0 * rng.standard_normal(len(cw))).astype(np.float32)
    dec = _both(lambda pkg, _: _run(pkg, "PolarDecoder", llr, block_len, n=n, k=k))
    assert dec.shape == (len(cw) // n * k,)


def test_encoder_on_two_channels_equal():
    """The butterflies on a [2, T] stream (each channel its own frames)."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 6 * 64)).astype(np.float32)

    def f(pkg, _):
        blk = pkg.global_registry.create("PolarEncoder", n=128, k=64)
        if pkg is gt:
            _, out = blk.apply(None, {"in": torch.from_numpy(bits)}, None)
            return out["out"].numpy()
        import jax.numpy as jnp
        _, out = blk.apply(None, {"in": jnp.asarray(bits)}, None)
        return np.asarray(out["out"])
    out = _both(f)
    fr = frozen_mask(128, 64)
    for ch in range(2):
        np.testing.assert_array_equal(
            out[ch], polar_encode(bits[ch].astype(np.uint8), fr).astype(np.float32))
