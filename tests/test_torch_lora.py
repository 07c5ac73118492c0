"""The port's LoRa-style CSS family (``blocks/lora.py``) against the JAX
package's, on the CPU: every host helper on seeded inputs, CssDemod (the
device block) through both schedulers at SF 7, 8 and 9 on noisy frames at
several timing offsets and on an all-zero input where every bin ties,
LoRaSource and LoRaDecoder through both schedulers, and
``examples/lora_link.yaml`` run by ``run_grc`` in both packages; and every
case of ``tests/test_lora.py`` run on the port.

Tolerance: none. The bit layer is host NumPy in both packages; CssDemod's
symbols are argmax indices (float32 holding integers) and are compared
exactly, as are decoded payloads."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import lora as jl
from gnuradio4_tpu_torch.blocks import lora as tl
from gnuradio4_tpu_torch.blocks.lora import (CssDemod, LoRaDecoder, base_chirp,
                                             css_demod_host, css_symbol,
                                             decode_payload, deinterleave,
                                             encode_payload, hamming_decode,
                                             hamming_encode, interleave,
                                             lora_modulate, whitening_sequence)
from gnuradio4_tpu_torch.blocks.testing import VectorSink, VectorSource

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261017


def _sched(g, **kw):
    return gt.Scheduler(g, device="cpu", **kw)


def _eq(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# -- host helpers: exact -------------------------------------------------------------

def test_host_helpers_equal():
    rng = np.random.default_rng(SEED)
    for sf in (7, 8, 9, 10):
        for down in (False, True):
            _eq(tl.base_chirp(sf, down=down), jl.base_chirp(sf, down=down))
        _eq(tl.css_symbol(37, sf), jl.css_symbol(37, sf))
        x = (rng.standard_normal(5 << sf) + 1j * rng.standard_normal(5 << sf)
             ).astype(np.complex64)
        _eq(tl.css_demod_host(x, sf), jl.css_demod_host(x, sf))
    v = rng.integers(0, 1 << 12, 500).astype(np.uint32)
    _eq(tl._gray(v), jl._gray(v))
    _eq(tl._gray_inv(v), jl._gray_inv(v))
    nib = rng.integers(0, 16, 64).astype(np.uint8)
    for cr in (1, 2, 3, 4):
        cw = tl.hamming_encode(nib, cr)
        _eq(cw, jl.hamming_encode(nib, cr))
        bad = cw ^ (1 << rng.integers(0, 4 + cr, len(cw))).astype(np.uint16)
        _eq(tl.hamming_decode(bad, cr), jl.hamming_decode(bad, cr))
        for sf in (7, 8, 9):
            words = rng.integers(0, 1 << (4 + cr), 2 * sf).astype(np.uint16)
            _eq(tl.interleave(words, sf, cr), jl.interleave(words, sf, cr))
            syms = rng.integers(0, 1 << sf, 2 * (4 + cr)).astype(np.uint32)
            _eq(tl.deinterleave(syms, sf, cr), jl.deinterleave(syms, sf, cr))
            p = bytes(rng.integers(0, 256, 23).astype(np.uint8))
            _eq(tl.encode_payload(p, sf, cr), jl.encode_payload(p, sf, cr))
            _eq(tl.decode_payload(syms, sf, cr), jl.decode_payload(syms, sf, cr))
    _eq(tl.whitening_sequence(300), jl.whitening_sequence(300))
    _eq(tl.lora_modulate(b"payload", sf=9, cr=2, amplitude=0.5),
        jl.lora_modulate(b"payload", sf=9, cr=2, amplitude=0.5))


# -- CssDemod and the blocks through both schedulers ----------------------------------

def _demod(pkg, x, sf, block_len):
    g = pkg.Graph()
    reg = pkg.global_registry
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=x),
                    reg.create("CssDemod", sf=sf), snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw).run_and_wait()
    return np.asarray(snk.data())


@pytest.mark.parametrize("sf", [7, 8, 9])
@pytest.mark.parametrize("offset", [0, 37])
def test_css_demod_equal_through_both_schedulers(sf, offset):
    """A frame at 0 or 37 samples of timing offset plus complex noise at
    0.3 per component, 4 steps: the symbols equal, and at offset 0 the
    payload's symbols are the transmitted ones."""
    rng = np.random.default_rng(SEED + sf + offset)
    syms = tl.encode_payload(b"CSS ON THE CARD", sf, 4)
    x = np.concatenate([np.zeros(offset, np.complex64)]
                       + [css_symbol(int(s), sf) for s in syms])
    n = 16 << sf
    x = np.concatenate([x, np.zeros(n - len(x) % n, np.complex64)])
    x = (x + 0.3 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    got = _demod(gt, x, sf, n // 4)
    want = _demod(gr, x, sf, n // 4)
    _eq(got, want)
    assert got.dtype == np.float32 and got.shape == (len(x) >> sf,)
    if offset == 0:
        np.testing.assert_array_equal(got[:len(syms)], syms)


def test_css_demod_ties_take_the_first_bin():
    """All-zero frames: every bin's magnitude is 0, and each frame's symbol
    is bin 0, as jnp.argmax gives."""
    x = np.zeros(8 << 8, np.complex64)
    got = _demod(gt, x, 8, 4 << 8)
    _eq(got, _demod(gr, x, 8, 4 << 8))
    assert np.all(got == 0)


@pytest.mark.parametrize("block_len", [2048, 3000])
def test_source_and_decoder_equal_through_both_schedulers(block_len):
    out = {}
    for pkg in (gr, gt):
        g = pkg.Graph()
        reg = pkg.global_registry
        src = reg.create("LoRaSource", payload="BOTH PACKAGES", sf=8, cr=3)
        snk = reg.create("VectorSink")
        dec = reg.create("LoRaDecoder", sf=8, cr=3)
        g.connect(src, snk)
        g.connect(src, dec)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=block_len, sample_rate=250e3, **kw).run_and_wait()
        out[pkg] = (np.asarray(snk.data()), dec.frames)
    _eq(out[gt][0], out[gr][0])
    assert out[gt][1] == out[gr][1] == [b"BOTH PACKAGES"]


def _flow(pkg):
    text = (ROOT / "examples" / "lora_link.yaml").read_text()
    kw = {"scheduler_kwargs": {"device": "cpu"}} if pkg is gt else {}
    return {b.name: b for b in pkg.run_grc(text, **kw).graph.blocks}["rx"]


def test_lora_link_example_runs_in_the_port_as_in_the_jax_package():
    """examples/lora_link.yaml through ``run_grc`` on the CPU: the frame of
    tests/test_examples.py, and the JAX package's."""
    rt = _flow(gt)
    assert rt.frames == [b"LoRa over TPU"]
    assert rt.frames == _flow(gr).frames


# -- tests/test_lora.py, on the port --------------------------------------------------

class TestChirps:
    def test_base_chirp_unit_modulus(self):
        c = base_chirp(8)
        np.testing.assert_allclose(np.abs(c), 1.0, atol=1e-6)

    def test_up_down_conjugate(self):
        np.testing.assert_allclose(base_chirp(7, down=True),
                                   np.conj(base_chirp(7)), atol=1e-6)

    @pytest.mark.parametrize("sf", [7, 8, 10])
    def test_demod_exact_all_symbols(self, sf):
        n = 1 << sf
        vals = np.array([0, 1, n // 3, n // 2, n - 1])
        x = np.concatenate([css_symbol(int(v), sf) for v in vals])
        np.testing.assert_array_equal(css_demod_host(x, sf), vals)


class TestBitLayer:
    @pytest.mark.parametrize("cr", [1, 2, 3, 4])
    def test_hamming_roundtrip(self, cr):
        nib = np.arange(16, dtype=np.uint8)
        np.testing.assert_array_equal(
            hamming_decode(hamming_encode(nib, cr), cr), nib)

    def test_hamming_corrects_single_bit_cr4(self):
        nib = np.arange(16, dtype=np.uint8)
        cw = hamming_encode(nib, 4)
        for bit in range(8):
            np.testing.assert_array_equal(
                hamming_decode(cw ^ (1 << bit), 4), nib,
                err_msg=f"bit {bit}")

    @pytest.mark.parametrize("sf,cr", [(7, 4), (8, 4), (9, 1), (10, 2)])
    def test_interleaver_roundtrip(self, sf, cr):
        rng = np.random.default_rng(1)
        cw = rng.integers(0, 1 << (4 + cr), size=3 * sf).astype(np.uint16)
        np.testing.assert_array_equal(
            deinterleave(interleave(cw, sf, cr), sf, cr), cw)

    def test_whitening_is_involution(self):
        w = whitening_sequence(32)
        data = np.arange(32, dtype=np.uint8)
        np.testing.assert_array_equal((data ^ w) ^ w, data)
        assert len(set(w.tolist())) > 16      # actually pseudorandom

    @pytest.mark.parametrize("sf,cr", [(7, 4), (8, 4), (9, 1)])
    def test_payload_roundtrip(self, sf, cr):
        p = bytes(range(1, 40))
        assert decode_payload(encode_payload(p, sf, cr), sf, cr) == p

    def test_symbol_errors_corrected_by_fec(self):
        # cr=4 corrects one bit flip per codeword — flip one bit in a few
        # distinct interleaved symbols
        p = b"FEC CHECK"
        syms = encode_payload(p, 8, 4)
        syms = syms.copy()
        syms[0] ^= 1
        syms[9] ^= 4
        assert decode_payload(syms, 8, 4) == p


class TestFrameSync:
    @pytest.mark.parametrize("offset", [0, 137, 777, 1000, 3333])
    def test_arbitrary_timing_offset(self, offset):
        wave = lora_modulate(b"OFFSET", sf=8)
        x = np.concatenate([np.zeros(offset, np.complex64), wave,
                            np.zeros(600, np.complex64)])
        d = LoRaDecoder(sf=8)
        d.consume({"in": x}, {}, len(x), 0)
        d.stop()
        assert d.frames == [b"OFFSET"]

    def test_integer_cfo_corrected(self):
        wave = lora_modulate(b"CFO", sf=8)
        x = np.concatenate([np.zeros(500, np.complex64), wave,
                            np.zeros(500, np.complex64)])
        cfo = np.exp(2j * np.pi * (5.0 / 256) * np.arange(len(x)))
        d = LoRaDecoder(sf=8)
        xc = (x * cfo).astype(np.complex64)
        d.consume({"in": xc}, {}, len(xc), 0)
        d.stop()
        assert d.frames == [b"CFO"]

    def test_two_frames(self):
        x = np.concatenate([np.zeros(300, np.complex64),
                            lora_modulate(b"ONE", sf=8),
                            np.zeros(2048, np.complex64),
                            lora_modulate(b"TWO", sf=8),
                            np.zeros(600, np.complex64)])
        d = LoRaDecoder(sf=8)
        for i in range(0, len(x), 4096):
            c = x[i:i + 4096]
            d.consume({"in": c}, {}, len(c), 0)
        d.stop()
        assert d.frames == [b"ONE", b"TWO"]

    @pytest.mark.parametrize("noise", [0.3, 0.7])
    def test_noise(self, noise):
        rng = np.random.default_rng(2)
        wave = lora_modulate(b"NOISY PAYLOAD", sf=8)
        x = np.concatenate([np.zeros(1024, np.complex64), wave,
                            np.zeros(1024, np.complex64)])
        x = (x + noise * (rng.standard_normal(len(x))
                          + 1j * rng.standard_normal(len(x)))
             / np.sqrt(2)).astype(np.complex64)
        d = LoRaDecoder(sf=8)
        d.consume({"in": x}, {}, len(x), 0)
        d.stop()
        assert d.frames == [b"NOISY PAYLOAD"]

    def test_pure_noise_no_false_frames(self):
        rng = np.random.default_rng(3)
        x = (rng.standard_normal(65536)
             + 1j * rng.standard_normal(65536)).astype(np.complex64)
        d = LoRaDecoder(sf=8)
        d.consume({"in": x}, {}, len(x), 0)
        d.stop()
        assert d.frames == []


class TestDeviceDemod:
    def test_css_demod_block_matches_host(self):
        syms = encode_payload(b"DEVICE SIDE", 8, 4)
        x = np.concatenate([css_symbol(int(s), 8) for s in syms])
        g = gt.Graph()
        src = g.add(VectorSource(x.astype(np.complex64)))
        dem = g.emplace("CssDemod", sf=8)
        snk = g.add(VectorSink())
        g.connect_chain(src, dem, snk)
        _sched(g, block_len=4096, sample_rate=250e3).run_and_wait()
        dev = np.asarray(snk.data()).astype(np.int64)
        host = css_demod_host(x, 8)
        np.testing.assert_array_equal(dev, host[:len(dev)])
        # and the symbol stream decodes
        assert decode_payload(dev.astype(np.uint32), 8, 4) == b"DEVICE SIDE"

    def test_ratio_and_alignment(self):
        d = CssDemod(sf=9)
        assert d.alignment == 512
        assert float(d.ratio) == 1.0 / 512


class TestGraphChain:
    @pytest.mark.parametrize("block_len", [2048, 8192])
    def test_source_to_decoder(self, block_len):
        g = gt.Graph()
        src = g.emplace("LoRaSource", payload=b"CHAIN PAYLOAD 123", sf=8)
        dec = g.emplace("LoRaDecoder", sf=8)
        g.connect(src, dec)
        _sched(g, block_len=block_len,
                     sample_rate=250e3).run_and_wait()
        assert dec.frames == [b"CHAIN PAYLOAD 123"]

    def test_sf7_chain(self):
        g = gt.Graph()
        src = g.emplace("LoRaSource", payload=b"SF7", sf=7)
        dec = g.emplace("LoRaDecoder", sf=7)
        g.connect(src, dec)
        _sched(g, block_len=2048, sample_rate=125e3).run_and_wait()
        assert dec.frames == [b"SF7"]
