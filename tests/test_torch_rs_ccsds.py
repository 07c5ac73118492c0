"""The port's Reed-Solomon codec and CCSDS link layer
(``blocks/reed_solomon.py``, ``ccsds.py``) against the JAX package's, on the
CPU: every case of ``tests/test_reed_solomon.py`` and ``tests/test_ccsds.py``
runs the same seeded input through both packages, and the JAX test's
assertions hold on the port's result; RsEncoder and RsDecoder through both
schedulers, with their counters after the run (the host call runs once per
step: a frame is never counted twice).

Tolerance: none. Codewords, bytes, frames, error counts and counters are
compared exactly."""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import ccsds as jccsds, reed_solomon as jrs
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu_torch.blocks import ccsds, reed_solomon as rs
from gnuradio4_tpu_torch.blocks.ccsds import (ASM_BITS, CcsdsCoder,
                                              CcsdsDeframer,
                                              randomizer_sequence)
from gnuradio4_tpu_torch.blocks.reed_solomon import GF256, ReedSolomon
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

PKGS = {"jax": (gr, jrs, jccsds), "port": (gt, rs, ccsds)}


def _sched(pkg, g, block_len):
    kw = {"device": "cpu"} if pkg is gt else {}
    return pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw)


def _chain(pkg, data, blocks, block_len, **settings):
    """VectorSource(data) → blocks… → VectorSink through ``pkg``'s scheduler;
    (sink data, the created blocks)."""
    g = pkg.Graph()
    reg = pkg.global_registry
    made = [reg.create(b, **settings) for b in blocks]
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=data), *made, snk)
    _sched(pkg, g, block_len).run_and_wait()
    return np.asarray(snk.data()), made


def _both(fn):
    """``fn(package modules)`` in both packages; the results must be equal."""
    got = {k: fn(*mods) for k, mods in PKGS.items()}
    _eq(got["port"], got["jax"])
    return got["port"]


def _eq(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _eq(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


# -- the field and the codec: both packages, exact -------------------------------

def test_field_tables_and_generators_equal():
    for poly in (0x11D, 0x187):
        t, j = GF256(poly), jrs.GF256(poly)
        _eq(t.exp, j.exp)
        _eq(t.log, j.log)
    for args in ((255, 223, {}), (64, 48, {}),
                 (255, 223, dict(prim_poly=0x187, fcr=112, prim=11))):
        _eq(ReedSolomon(args[0], args[1], **args[2]).genpoly,
            jrs.ReedSolomon(args[0], args[1], **args[2]).genpoly)


class TestField:
    def test_exp_log_inverse_tables(self):
        def f(_, m, __):
            gf = m.GF256()
            return [int(gf.mul(a, gf.inv(a))) for a in (1, 2, 77, 255)]
        assert _both(f) == [1, 1, 1, 1]

    def test_mul_distributes(self):
        def f(_, m, __):
            gf = m.GF256()
            rng = np.random.default_rng(0)
            a, b, c = rng.integers(0, 256, 3)
            return int(gf.mul(a, int(b) ^ int(c))), \
                int(gf.mul(a, b)) ^ int(gf.mul(a, c))
        left, right = _both(f)
        assert left == right

    def test_non_primitive_poly_rejected(self):
        with pytest.raises(GrError, match="not primitive"):
            GF256(0x101)        # x^8 + 1 is not primitive
        with pytest.raises(JGrError, match="not primitive"):
            jrs.GF256(0x101)

    def test_ccsds_poly_is_primitive(self):
        _eq(GF256(0x187).exp, jrs.GF256(0x187).exp)


class TestCodec:
    def test_encode_is_systematic_and_valid(self):
        def f(_, m, __):
            r = m.ReedSolomon(255, 223)
            cw = r.encode(np.arange(223) % 256)
            return cw, r.decode(cw)
        cw, (out, nc) = _both(f)
        data = np.arange(223) % 256
        assert len(cw) == 255
        np.testing.assert_array_equal(cw[:223], data)
        assert nc == 0
        np.testing.assert_array_equal(out, data)

    @pytest.mark.parametrize("ne", [1, 5, 16])
    def test_corrects_up_to_t(self, ne):
        def f(_, m, __):
            rng = np.random.default_rng(ne)
            r = m.ReedSolomon(255, 223)
            data = rng.integers(0, 256, 223)
            cw = r.encode(data).astype(np.int64)
            pos = rng.choice(255, ne, replace=False)
            cw[pos] ^= rng.integers(1, 256, ne)
            return data, r.decode(cw)
        data, (out, nc) = _both(f)
        assert nc == ne
        np.testing.assert_array_equal(out, data)

    def test_t_plus_one_rejected(self):
        for m, err in ((rs, GrError), (jrs, JGrError)):
            rng = np.random.default_rng(9)
            r = m.ReedSolomon(255, 223)
            cw = r.encode(rng.integers(0, 256, 223)).astype(np.int64)
            pos = rng.choice(255, 17, replace=False)
            cw[pos] ^= rng.integers(1, 256, 17)
            with pytest.raises(err, match="uncorrectable"):
                r.decode(cw)

    def test_erasures_double_capacity(self):
        # 2·errors + erasures ≤ 32: 30 erasures + 1 error corrects
        def f(_, m, __):
            rng = np.random.default_rng(4)
            r = m.ReedSolomon(255, 223)
            data = rng.integers(0, 256, 223)
            cw = r.encode(data).astype(np.int64)
            er = rng.choice(255, 30, replace=False)
            cw[er] = 0
            extra = [p for p in range(255) if p not in er][7]
            cw[extra] ^= 55
            return data, r.decode(cw, erasures=list(er))
        data, (out, nc) = _both(f)
        np.testing.assert_array_equal(out, data)
        assert nc >= 30

    def test_shortened_code(self):
        def f(_, m, __):
            rng = np.random.default_rng(5)
            r = m.ReedSolomon(64, 48)           # t = 8
            data = rng.integers(0, 256, 48)
            cw = r.encode(data).astype(np.int64)
            pos = rng.choice(64, 8, replace=False)
            cw[pos] ^= rng.integers(1, 256, 8)
            return data, r.decode(cw)
        data, (out, nc) = _both(f)
        assert nc == 8
        np.testing.assert_array_equal(out, data)

    def test_ccsds_parameters(self):
        def f(_, m, __):
            rng = np.random.default_rng(6)
            r = m.ReedSolomon(255, 223, prim_poly=0x187, fcr=112, prim=11)
            data = rng.integers(0, 256, 223)
            cw = r.encode(data).astype(np.int64)
            pos = rng.choice(255, 16, replace=False)
            cw[pos] ^= rng.integers(1, 256, 16)
            return data, r.decode(cw)
        data, (out, nc) = _both(f)
        assert nc == 16
        np.testing.assert_array_equal(out, data)

    def test_bad_shapes_raise(self):
        for m, err in ((rs, GrError), (jrs, JGrError)):
            r = m.ReedSolomon(255, 223)
            with pytest.raises(err, match="got 10 symbols"):
                r.encode(np.zeros(10))
            with pytest.raises(err, match="got 10 symbols"):
                r.decode(np.zeros(10))
            with pytest.raises(err, match="need 0 < k < n"):
                m.ReedSolomon(255, 255)


# -- the stream blocks through both schedulers ------------------------------------

class TestBlocks:
    def test_encode_decode_chain_roundtrip(self):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, 4 * 223).astype(np.float32)
        out = _both(lambda pkg, *_: _chain(pkg, data, ("RsEncoder", "RsDecoder"),
                                           2 * 223)[0])
        np.testing.assert_array_equal(out, data)

    def test_decoder_corrects_channel_errors(self):
        rng = np.random.default_rng(2)
        r = ReedSolomon()
        data = rng.integers(0, 256, 4 * 223)
        enc = np.concatenate([r.encode(f) for f in data.reshape(-1, 223)]
                             ).astype(np.int64)
        for fi in range(4):
            pos = rng.choice(255, 10, replace=False)
            enc[fi * 255 + pos] ^= rng.integers(1, 256, 10)

        def f(pkg, *_):
            out, (dec,) = _chain(pkg, enc.astype(np.float32), ("RsDecoder",),
                                 2 * 255)
            return out, dec.n_corrected, dec.n_failed
        out, n_corrected, n_failed = _both(f)
        np.testing.assert_array_equal(out, data.astype(np.float32))
        assert n_corrected == 40 and n_failed == 0

    def test_uncorrectable_frame_passes_through_and_counts(self):
        rng = np.random.default_rng(3)
        r = ReedSolomon()
        cw = r.encode(rng.integers(0, 256, 223)).astype(np.int64)
        pos = rng.choice(255, 40, replace=False)
        cw[pos] ^= rng.integers(1, 256, 40)

        def f(pkg, *_):
            out, (dec,) = _chain(pkg, cw.astype(np.float32), ("RsDecoder",), 255)
            return out, dec.n_failed, dec.n_corrected
        out, n_failed, _ = _both(f)
        assert n_failed == 1
        np.testing.assert_array_equal(out, (cw[:223] & 0xFF).astype(np.float32))

    def test_concatenated_with_viterbi(self):
        # RS outer + convolutional inner through both schedulers
        rng = np.random.default_rng(7)
        data = rng.integers(0, 256, 223).astype(np.float32)
        r = ReedSolomon()
        coded = r.encode(data.astype(np.int64))
        bits = ((coded[:, None] >> np.arange(8)) & 1).reshape(-1).astype(np.int32)
        tb = 64
        padded = np.concatenate([bits, np.zeros(tb, np.int32)])

        def f(pkg, *_):
            g = pkg.Graph()
            reg = pkg.global_registry
            snk = reg.create("VectorSink")
            g.connect_chain(reg.create("VectorSource", data=padded),
                            reg.create("ConvEncoder"),
                            reg.create("ViterbiDecoder", traceback=tb), snk)
            _sched(pkg, g, len(padded)).run_and_wait()
            return np.asarray(snk.data())
        out_bits = _both(f).astype(np.int64)[tb: tb + len(bits)]
        rebytes = (out_bits.reshape(-1, 8) << np.arange(8)).sum(axis=1)
        dec, _ = r.decode(rebytes)
        np.testing.assert_array_equal(dec, data.astype(np.uint8))


@pytest.mark.parametrize("block_len", [223, 3 * 255, 1000])
def test_rs_counters_equal_after_a_run(block_len):
    """A decoder fed frames with 0, 8, 16 and 40 byte errors (the last
    uncorrectable) at block lengths that split the stream unevenly and pad the
    last step: the output and ``n_corrected``/``n_failed`` equal the JAX
    package's after the run, and each frame is counted once."""
    rng = np.random.default_rng(11)
    r = ReedSolomon()
    data = rng.integers(0, 256, (8, 223))
    enc = np.stack([r.encode(f) for f in data]).astype(np.int64)
    for fi, ne in enumerate((0, 8, 16, 40, 0, 8, 16, 40)):
        pos = rng.choice(255, ne, replace=False)
        enc[fi, pos] ^= rng.integers(1, 256, ne)

    def f(pkg, *_):
        out, (dec,) = _chain(pkg, enc.reshape(-1).astype(np.float32),
                             ("RsDecoder",), block_len)
        return out, dec.n_corrected, dec.n_failed
    out, n_corrected, n_failed = _both(f)
    assert (n_corrected, n_failed) == (2 * (8 + 16), 2)
    np.testing.assert_array_equal(out[:223].astype(np.int64), data[0])


def test_host_call_keeps_dtype_shape_and_device():
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    y = rs.host_call(lambda a: a[..., :3] * 2, x)
    assert y.dtype == torch.float32 and y.device == x.device
    np.testing.assert_array_equal(y.numpy(), x.numpy()[..., :3] * 2)


# -- CCSDS ---------------------------------------------------------------------------

def test_ccsds_pieces_equal():
    _eq(ASM_BITS, jccsds.ASM_BITS)
    _eq(randomizer_sequence(1020), jccsds.randomizer_sequence(1020))
    rng = np.random.default_rng(3)
    for i in (1, 2, 5):
        payload = bytes(rng.integers(0, 256, 223 * i).tolist())
        _eq(CcsdsCoder(i).encode_frame(payload),
            jccsds.CcsdsCoder(i).encode_frame(payload))
        _eq(CcsdsCoder(i, ccsds_field=False).encode_frame(payload),
            jccsds.CcsdsCoder(i, ccsds_field=False).encode_frame(payload))


class TestPieces:
    def test_asm_bits(self):
        word = int("".join(map(str, ASM_BITS)), 2)
        assert word == 0x1ACFFC1D and len(ASM_BITS) == 32

    def test_randomizer_first_byte_and_period(self):
        seq = randomizer_sequence(512)
        _eq(seq, jccsds.randomizer_sequence(512))
        assert seq[0] == 0xFF
        assert np.array_equal(seq[:255], seq[255:510])

    def test_frame_geometry(self):
        payload = bytes(range(223)) * 4
        bits = _both(lambda _, __, m: m.CcsdsCoder(interleave=4).encode_frame(payload))
        assert len(bits) == 32 + 255 * 4 * 8
        np.testing.assert_array_equal(bits[:32], ASM_BITS)

    def test_wrong_payload_size_raises(self):
        with pytest.raises(GrError, match="payload must be 446 bytes"):
            CcsdsCoder(interleave=2).encode_frame(b"short")
        with pytest.raises(JGrError, match="payload must be 446 bytes"):
            jccsds.CcsdsCoder(interleave=2).encode_frame(b"short")


def _frame(m, interleave=1, seed=0):
    rng = np.random.default_rng(seed)
    coder = m.CcsdsCoder(interleave=interleave)
    payload = bytes(rng.integers(0, 256, coder.data_len).tolist())
    return payload, coder.encode_frame(payload)


def _deframe(m, chunks, interleave):
    d = m.CcsdsDeframer(interleave=interleave)
    for c in chunks:
        d.consume({"in": c}, {}, len(c), 0)
    d.stop()
    return d.frames, d.n_corrected


class TestDecode:
    def test_offset_and_inverted_polarity(self):
        def f(_, __, m):
            rng = np.random.default_rng(1)
            payload, bits = _frame(m, interleave=2)
            stream = np.concatenate([rng.integers(0, 2, 137), bits ^ 1,
                                     rng.integers(0, 2, 64)]).astype(np.float32)
            return payload, _deframe(m, [stream], 2)
        payload, (frames, _) = _both(f)
        assert frames == [payload]

    def test_interleaving_spreads_bursts(self):
        def f(_, __, m):
            payload, bits = _frame(m, interleave=4, seed=2)
            bits = bits.astype(np.uint8)
            bits[32 + 100 * 8: 32 + 160 * 8] ^= 1
            return payload, _deframe(m, [bits.astype(np.float32)], 4)
        payload, (frames, n_corrected) = _both(f)
        assert frames == [payload]
        assert n_corrected == 60

    def test_uncorrectable_frame_skipped(self):
        def f(_, __, m):
            payload, bits = _frame(m, interleave=1, seed=3)
            bits = bits.astype(np.uint8)
            bits[32: 32 + 100 * 8] ^= 1        # 100-byte burst >> t
            return _deframe(m, [bits.astype(np.float32)], 1)
        frames, _ = _both(f)
        assert frames == []

    def test_chunked_delivery(self):
        def f(_, __, m):
            payload, bits = _frame(m, interleave=1, seed=4)
            x = bits.astype(np.float32)
            return payload, _deframe(m, [x[i:i + 300] for i in range(0, len(x), 300)], 1)
        payload, (frames, _) = _both(f)
        assert frames == [payload]


class TestGraph:
    def test_framer_to_deframer_chain(self):
        msg = b"HELLO CCSDS " * 100

        def f(pkg, *_):
            g = pkg.Graph()
            src = g.emplace("CcsdsFramer", payload=msg, interleave=1)
            dec = g.emplace("CcsdsDeframer", interleave=1)
            g.connect(src, dec)
            _sched(pkg, g, 2048).run_and_wait()
            return dec.frames, dec.n_corrected
        frames, _ = _both(f)
        pad = (-len(msg)) % 223
        assert b"".join(frames) == msg + b"\x00" * pad

    def test_concatenated_with_viterbi_inner_code(self):
        # framer bits → conv(2,1,7) → 2% channel errors → Viterbi → deframer,
        # the channel errors drawn once and applied in both packages
        rng = np.random.default_rng(5)
        msg = bytes(rng.integers(0, 256, 223).tolist())
        tb = 64

        def coded_of(pkg):
            g = pkg.Graph()
            src = g.emplace("CcsdsFramer", payload=msg, interleave=1)
            toint = g.emplace("Convert", to="int32")
            enc = g.emplace("ConvEncoder")
            snk = g.emplace("VectorSink")
            g.connect_chain(src, toint, enc, snk)
            _sched(pkg, g, 2048).run_and_wait()
            return np.asarray(snk.data()).astype(np.int32)

        coded = _both(lambda pkg, *_: coded_of(pkg))
        flips = rng.random(len(coded)) < 0.02
        coded = np.concatenate([coded ^ flips.astype(np.int32),
                                np.zeros(2 * tb, np.int32)])

        def f(pkg, *_):
            g = pkg.Graph()
            reg = pkg.global_registry
            dec = reg.create("CcsdsDeframer", interleave=1)
            g.connect_chain(reg.create("VectorSource", data=coded),
                            reg.create("ViterbiDecoder", traceback=tb),
                            reg.create("Convert", to="float32"), dec)
            _sched(pkg, g, 2048).run_and_wait()
            return dec.frames, dec.n_corrected
        frames, _ = _both(f)
        assert frames == [msg]


def test_deframer_equal_on_a_noisy_multi_frame_stream():
    """Three frames at interleave 2 with random bit slips between them,
    inverted polarity on the second and byte errors in each, fed in chunks
    of 777 bits: the payloads and ``n_corrected`` equal the JAX package's."""
    def f(_, __, m):
        rng = np.random.default_rng(8)
        coder = m.CcsdsCoder(interleave=2)
        parts, payloads = [], []
        for i in range(3):
            payload = bytes(rng.integers(0, 256, coder.data_len).tolist())
            bits = coder.encode_frame(payload).astype(np.uint8)
            pos = 32 + 8 * rng.choice(coder.code_len, 12, replace=False)
            bits[pos] ^= 1
            parts += [rng.integers(0, 2, int(rng.integers(5, 90))).astype(np.uint8),
                      bits ^ (i == 1)]
            payloads.append(payload)
        x = np.concatenate(parts).astype(np.float32)
        return payloads, _deframe(m, [x[i:i + 777] for i in range(0, len(x), 777)], 2)
    payloads, (frames, n_corrected) = _both(f)
    assert frames == payloads and n_corrected == 36
