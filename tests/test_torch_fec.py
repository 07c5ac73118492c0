"""The port's convolutional-FEC layer (``blocks/fec.py``) against the JAX
package's, on the CPU: the trellis tables and the host Golay/Hamming codecs;
every block through both schedulers over several steps, with its carried
state after each step; ViterbiDecoder hard and soft at three block lengths
and on a case built to tie; and every case of ``tests/test_fec.py`` and
``tests/test_golay_hamming.py`` run on the port. Also the registry names,
settings and defaults of the 26 block types of the slice (fec, wifi, lora,
ax25, ais, ble, sstv, rtty, cw, same).

Tolerance: none. Every output here is bits, symbols or 0/1 floats, and the
Viterbi path metrics are float32 sums computed in the JAX package's order:
all are compared exactly."""

from itertools import combinations

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import fec as jfec
from gnuradio4_tpu_torch.blocks import fec
from gnuradio4_tpu_torch.blocks.fec import (_GOLAY_B, _GOLAY_G, _GOLAY_H,
                                            golay_decode, golay_encode,
                                            hamming_decode, hamming_encode)

torch.set_num_threads(2)

SEED = 20261017
TB = 64


def _bits(n, seed=SEED):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)


def _graph(pkg, btype, data, settings):
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(btype, name="dut", **settings)
    snk = reg.create("VectorSink", name="snk")
    g.add(blk)
    g.connect(reg.create("VectorSource", data=data, name="src"), blk["in"])
    g.connect(blk["out"], snk)
    return g, blk, snk


def _sched(pkg, g, block_len):
    kw = {"device": "cpu"} if pkg is gt else {}
    return pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw)


def _run(pkg, btype, data, block_len, **settings):
    g, _, snk = _graph(pkg, btype, data, settings)
    _sched(pkg, g, block_len).run_and_wait()
    return np.asarray(snk.data())


def _np_tree(state):
    if isinstance(state, dict):
        return {k: _np_tree(v) for k, v in state.items()}
    return np.asarray(state.cpu() if torch.is_tensor(state) else state)


def _stepwise(pkg, btype, data, block_len, n_steps, **settings):
    """The block's output and its carried state after each of ``n_steps``."""
    g, blk, snk = _graph(pkg, btype, data, settings)
    s = _sched(pkg, g, block_len)
    states = []
    for _ in range(n_steps):
        s.step_once()
        states.append(_np_tree(s._states[blk.unique_name]))
    s._drain()
    return np.asarray(snk.data()), states


def _equal_trees(a, b, what=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _equal_trees(a[k], b[k], f"{what}/{k}")
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _both_stepwise(btype, data, block_len, n_steps, **settings):
    ot, st = _stepwise(gt, btype, data, block_len, n_steps, **settings)
    oj, sj = _stepwise(gr, btype, data, block_len, n_steps, **settings)
    assert ot.dtype == oj.dtype and ot.shape == oj.shape
    np.testing.assert_array_equal(ot, oj)
    for i, (a, b) in enumerate(zip(st, sj)):
        _equal_trees(a, b, f"{btype} step {i}")
    return ot


# -- host tables and codecs: exact --------------------------------------------

@pytest.mark.parametrize("k, polys", [(7, (0o171, 0o133)), (7, (0o133, 0o171)),
                                      (3, (0o7, 0o5)), (9, (0o753, 0o561))])
def test_trellis_tables_equal(k, polys):
    for a, b in zip(fec._tables(k, polys), jfec._tables(k, polys)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_golay_and_hamming_host_codecs_equal():
    rng = np.random.default_rng(SEED)
    np.testing.assert_array_equal(fec._golay_syndrome_table(),
                                  jfec._golay_syndrome_table())
    for a, b in ((_GOLAY_B, jfec._GOLAY_B), (_GOLAY_G, jfec._GOLAY_G),
                 (_GOLAY_H, jfec._GOLAY_H)):
        np.testing.assert_array_equal(a, b)
    msg = rng.integers(0, 2, (3, 12 * 20)).astype(np.uint8)
    cw = golay_encode(msg)
    np.testing.assert_array_equal(cw, jfec.golay_encode(msg))
    # up to four flips per frame: corrected, and detected-uncorrectable
    r = cw.reshape(-1, 24).copy()
    for row in r:
        row[rng.choice(24, rng.integers(0, 5), replace=False)] ^= 1
    for a, b in zip(golay_decode(r.reshape(3, -1)),
                    jfec.golay_decode(r.reshape(3, -1))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for m in (3, 4, 5):
        for a, b in zip(fec._hamming_matrices(m), jfec._hamming_matrices(m)):
            np.testing.assert_array_equal(a, b)
        n = (1 << m) - 1
        msg = rng.integers(0, 2, (n - m) * 30).astype(np.uint8)
        cw = hamming_encode(msg, m=m)
        np.testing.assert_array_equal(cw, jfec.hamming_encode(msg, m=m))
        cw = cw.reshape(-1, n)
        cw[np.arange(30), rng.integers(0, n, 30)] ^= rng.integers(0, 2, 30
                                                                  ).astype(np.uint8)
        for a, b in zip(hamming_decode(cw.reshape(-1), m=m),
                        jfec.hamming_decode(cw.reshape(-1), m=m)):
            np.testing.assert_array_equal(a, b)


# -- the stream blocks through both schedulers: exact, state after each step -------

@pytest.mark.parametrize("block_len", [256, 1000, 4096])
@pytest.mark.parametrize("settings", [{}, {"constraint": 5, "poly0": 0o23,
                                           "poly1": 0o35}], ids=["k7", "k5"])
def test_conv_encoder_equal_across_steps(block_len, settings):
    _both_stepwise("ConvEncoder", _bits(3 * block_len), block_len, 3,
                   **settings)


SCRAMBLERS = {
    "default": {},
    "wide_seed": {"length": 5},                   # 0x7F and 0x48 pass bit 4
    "x17": {"mask": 0x10800, "length": 17, "seed": 0x1ABCD},
}


@pytest.mark.parametrize("block_len", [256, 1000, 4096])
@pytest.mark.parametrize("cfg", sorted(SCRAMBLERS))
@pytest.mark.parametrize("btype", ["Scrambler", "Descrambler"])
def test_scramblers_equal_across_steps(btype, cfg, block_len):
    """One chunk (256), four (1000, the last one partial) and sixteen (4096)
    of the scrambler's affine form, and the descrambler's window, against the
    JAX package's bitwise scan, with the register carried across 3 steps."""
    _both_stepwise(btype, _bits(3 * block_len, SEED + 1), block_len, 3,
                   **SCRAMBLERS[cfg])


def _coded(n_bits, flip, seed=SEED):
    coded = _run(gr, "ConvEncoder", _bits(n_bits, seed), 4096)[:2 * n_bits]
    rng = np.random.default_rng(seed + 7)
    return coded ^ (rng.random(coded.size) < flip).astype(np.int32)


@pytest.mark.parametrize("block_len", [128, 1000, 4096])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_viterbi_equal_across_steps(block_len, soft):
    """Hard bits at 5% flips, or soft values (the coded bits plus Gaussian
    noise, clipped to [0, 1]): decoded bits and the carried metrics and
    decision tail after each of 3 steps, bit for bit."""
    n = 3 * block_len // 2
    if soft:
        rng = np.random.default_rng(SEED + 3)
        data = np.clip(_coded(n, 0.0) + rng.normal(0, 0.45, 2 * n), 0, 1
                       ).astype(np.float32)
    else:
        data = _coded(n, 0.05)
    out = _both_stepwise("ViterbiDecoder", data, block_len, 3, soft=soft,
                         traceback=TB)
    assert out.dtype == np.int32 and out.shape == (n,)


def _np_viterbi(r, tb, later_wins):
    """One-step reference decoder with the tie rule made explicit; also
    counts the add-compare-select ties."""
    enc_out, pred = jfec._tables(7, (0o171, 0o133))
    t = np.arange(64)
    br = np.stack([enc_out[pred[:, 0], t & 1], enc_out[pred[:, 1], t & 1]],
                  1).astype(np.float32)
    m = np.full(64, 1e6, np.float32)
    m[0] = 0
    decs, ties = [], 0
    for rp in np.asarray(r, np.float32).reshape(-1, 2):
        d = np.abs(br - rp)
        cand = m[pred] + (d[..., 0] + d[..., 1])
        ties += int(np.sum(cand[:, 0] == cand[:, 1]))
        decs.append((cand[:, 1] <= cand[:, 0]) if later_wins
                    else (cand[:, 1] < cand[:, 0]))
        m2 = cand.min(-1)
        m = m2 - m2.min()
    all_dec = np.concatenate([np.zeros((tb, 64), bool), decs]).astype(int)
    s, bits = int(np.argmin(m)), np.empty(len(all_dec), np.int32)
    for i in range(len(all_dec) - 1, -1, -1):
        bits[i] = s & 1
        s = pred[s, all_dec[i, s]]
    return bits[:len(decs)], ties


def test_viterbi_ties_take_the_first_candidate():
    """Hard decisions at 20% flips: integer metrics, so the add-compare-
    select meets thousands of equal candidates. The port equals the JAX
    package and a reference that keeps the first of equal candidates, and
    differs from one that keeps the later: the tie rule decides bits here."""
    data = _coded(512, 0.2)
    port = _run(gt, "ViterbiDecoder", data, 1024, traceback=TB)
    np.testing.assert_array_equal(port, _run(gr, "ViterbiDecoder", data, 1024,
                                             traceback=TB))
    first, ties = _np_viterbi(data, TB, later_wins=False)
    later, _ = _np_viterbi(data, TB, later_wins=True)
    assert ties > 1000
    np.testing.assert_array_equal(port, first)
    assert np.any(port != later)


def test_viterbi_all_erasures_tie_everywhere():
    """Soft 0.5 everywhere: every candidate pair ties at every symbol and
    every end metric is equal, so the path is the first state's, as in the
    JAX package."""
    half = np.full(2048, 0.5, np.float32)
    a, sa = _stepwise(gt, "ViterbiDecoder", half, 1024, 2, soft=True)
    b, sb = _stepwise(gr, "ViterbiDecoder", half, 1024, 2, soft=True)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(sa, sb):
        _equal_trees(x, y)


@pytest.mark.parametrize("btype, unit, m", [("GolayEncoder", 12, None),
                                            ("GolayDecoder", 24, None),
                                            ("HammingEncoder", 4, 3),
                                            ("HammingEncoder", 11, 4),
                                            ("HammingDecoder", 7, 3),
                                            ("HammingDecoder", 15, 4)])
def test_block_codes_equal_across_steps(btype, unit, m):
    """0/1 floats with up to three flips per 24-bit Golay frame and up to one
    per Hamming frame (decoders), over 3 steps of 2·unit·24 samples."""
    kw = {} if m is None else {"m": m}
    rng = np.random.default_rng(SEED + unit)
    bl = unit * 48
    data = rng.integers(0, 2, 3 * bl).astype(np.float32)
    if btype == "GolayDecoder":
        data = golay_encode(data[:3 * bl // 2].astype(np.uint8)
                            ).astype(np.float32).reshape(-1, 24)
        for row in data:
            pos = rng.choice(24, rng.integers(0, 4), replace=False)
            row[pos] = 1.0 - row[pos]
    elif btype == "HammingDecoder":
        data = data.reshape(-1, unit)
        rows, pos = np.arange(len(data)), rng.integers(0, unit, len(data))
        data[rows, pos] = 1.0 - data[rows, pos]
    _both_stepwise(btype, data.reshape(-1), bl, 3, **kw)


# -- tests/test_fec.py, on the port ---------------------------------------------

def _run_chain(bits, block_len=4096, corrupt=None, seed=9):
    g = gt.Graph()
    src = g.emplace("VectorSource")
    src.data = bits
    enc = g.emplace("ConvEncoder")
    k = g.emplace("VectorSink")
    g.connect_chain(src, enc, k)
    _sched(gt, g, block_len).run_and_wait()
    coded = np.asarray(k.data())[: 2 * len(bits)].astype(np.int32)
    if corrupt:
        rng = np.random.default_rng(seed)
        coded = (coded ^ (rng.random(len(coded)) < corrupt).astype(np.int32))
    g2 = gt.Graph()
    s2 = g2.emplace("VectorSource")
    s2.data = coded.astype(np.int32)
    d2 = g2.emplace("ViterbiDecoder", traceback=TB)
    k2 = g2.emplace("VectorSink")
    g2.connect_chain(s2, d2, k2)
    _sched(gt, g2, block_len).run_and_wait()
    return np.asarray(k2.data())


class TestFecMirror:
    def test_clean_channel_exact(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 32768).astype(np.int32)
        y = _run_chain(bits)
        np.testing.assert_array_equal(y[TB:32768], bits[: 32768 - TB])

    def test_corrects_5pct_channel_errors(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 32768).astype(np.int32)
        y = _run_chain(bits, corrupt=0.05)
        residual = np.mean(y[TB:32768] != bits[: 32768 - TB])
        assert residual < 0.01, residual

    def test_block_size_invariance(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, 8192).astype(np.int32)
        ya = _run_chain(bits, block_len=4096)
        yb = _run_chain(bits, block_len=256)
        np.testing.assert_array_equal(ya[:8192], yb[:8192])

    def test_scrambler_descrambler_self_sync(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 16384).astype(np.int32)
        g = gt.Graph()
        src = g.emplace("VectorSource")
        src.data = bits
        sc = g.emplace("Scrambler")
        de = g.emplace("Descrambler", seed=0x15)   # wrong seed: must self-sync
        snk = g.emplace("VectorSink")
        g.connect_chain(src, sc, de, snk)
        _sched(gt, g, 2048).run_and_wait()
        y = np.asarray(snk.data())[:16384]
        np.testing.assert_array_equal(y[7:], bits[7:])

    def test_scrambler_whitens(self):
        g = gt.Graph()
        src = g.emplace("VectorSource")
        src.data = np.zeros(8192, np.int32)
        sc = g.emplace("Scrambler")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, sc, snk)
        _sched(gt, g, 2048).run_and_wait()
        frac = float(np.mean(np.asarray(snk.data())[:8192]))
        assert 0.45 < frac < 0.55

    def test_soft_decision_beats_hard(self):
        rng = np.random.default_rng(3)
        msg = rng.integers(0, 2, 16384).astype(np.int32)
        g = gt.Graph()
        s = g.emplace("VectorSource")
        s.data = msg
        e = g.emplace("ConvEncoder")
        k = g.emplace("VectorSink")
        g.connect_chain(s, e, k)
        _sched(gt, g, 4096).run_and_wait()
        coded = np.asarray(k.data())[: 2 * len(msg)].astype(np.float64)
        noisy = coded + rng.normal(0, 0.45, len(coded))
        soft = np.clip(noisy, 0.0, 1.0).astype(np.float32)
        hard = (noisy > 0.5).astype(np.int32)

        def dec(x, **kw):
            g3 = gt.Graph()
            s3 = g3.emplace("VectorSource")
            s3.data = x
            d3 = g3.emplace("ViterbiDecoder", traceback=64, **kw)
            k3 = g3.emplace("VectorSink")
            g3.connect_chain(s3, d3, k3)
            _sched(gt, g3, 4096).run_and_wait()
            return np.asarray(k3.data())

        beh = np.mean(dec(hard)[TB:16384] != msg[: 16384 - TB])
        bes = np.mean(dec(soft, soft=True)[TB:16384] != msg[: 16384 - TB])
        assert bes < beh * 0.5, (bes, beh)


# -- tests/test_golay_hamming.py, on the port -------------------------------------

def _run_block(block_type, data, block_len=4096, **settings):
    g = gt.Graph()
    src = g.emplace("VectorSource")
    src.data = np.asarray(data, np.float32)
    blk = g.emplace(block_type, **settings)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, blk, snk)
    _sched(gt, g, block_len).run_and_wait()
    return np.asarray(snk.data())


class TestGolayStructureMirror:
    def test_min_distance_8_full_enumeration(self):
        msgs = ((np.arange(4096)[:, None] >> np.arange(12)) & 1
                ).astype(np.uint8)
        cw = msgs @ _GOLAY_G % 2
        w = cw.sum(axis=1)
        w[0] = 99
        assert w.min() == 8
        assert np.all(cw.sum(axis=1) % 4 == 0)

    def test_B_symmetric_and_H_orthogonal(self):
        assert np.array_equal(_GOLAY_B, _GOLAY_B.T)
        assert np.all((_GOLAY_G @ _GOLAY_H.T) % 2 == 0)

    def test_all_3bit_errors_corrected_sampled(self):
        rng = np.random.default_rng(1)
        msg = rng.integers(0, 2, 12).astype(np.uint8)
        cw = golay_encode(msg)
        pats = [list(p) for w in (1, 2)
                for p in combinations(range(24), w)]
        pats += [sorted(rng.choice(24, 3, replace=False).tolist())
                 for _ in range(400)]
        for pos in pats:
            r = cw.copy()
            r[pos] ^= 1
            dec, nerr = golay_decode(r)
            assert np.array_equal(dec, msg), pos
            assert nerr[0] == len(pos)

    def test_weight4_detected_uncorrectable(self):
        msg = np.zeros(12, np.uint8)
        cw = golay_encode(msg)
        detected = 0
        for pos in combinations(range(8), 4):
            r = cw.copy()
            r[list(pos)] ^= 1
            _, nerr = golay_decode(r)
            assert nerr[0] != 4
            detected += int(nerr[0] == -1)
        assert detected == len(list(combinations(range(8), 4)))


class TestGolayBlocksMirror:
    def test_encoder_matches_host(self):
        rng = np.random.default_rng(2)
        msg = rng.integers(0, 2, 12 * 64).astype(np.float32)
        out = _run_block("GolayEncoder", msg)[: 24 * 64]
        np.testing.assert_array_equal(out.astype(np.uint8),
                                      golay_encode(msg.astype(np.uint8)))

    @pytest.mark.parametrize("block_len", [4096, 1536])
    def test_roundtrip_through_scheduler_with_errors(self, block_len):
        rng = np.random.default_rng(3)
        msg = rng.integers(0, 2, 12 * 128).astype(np.uint8)
        frames = golay_encode(msg).astype(np.float32).reshape(-1, 24)
        for row in frames:
            pos = rng.choice(24, 3, replace=False)
            row[pos] = 1.0 - row[pos]
        out = _run_block("GolayDecoder", frames.reshape(-1),
                         block_len=block_len)[: 12 * 128]
        np.testing.assert_array_equal(out.astype(np.uint8), msg)


class TestHammingMirror:
    @pytest.mark.parametrize("m", [3, 4])
    def test_exhaustive_single_error_correction(self, m):
        n = (1 << m) - 1
        k = n - m
        rng = np.random.default_rng(4)
        for _ in range(20):
            msg = rng.integers(0, 2, k).astype(np.uint8)
            cw = hamming_encode(msg, m=m)
            dec, nerr = hamming_decode(cw, m=m)
            assert np.array_equal(dec, msg) and nerr[0] == 0
            for pos in range(n):
                r = cw.copy()
                r[pos] ^= 1
                dec, nerr = hamming_decode(r, m=m)
                assert np.array_equal(dec, msg), (m, pos)
                assert nerr[0] == 1

    @pytest.mark.parametrize("m", [3, 4])
    def test_blocks_match_host(self, m):
        n = (1 << m) - 1
        k = n - m
        rng = np.random.default_rng(5)
        msg = rng.integers(0, 2, k * 96).astype(np.float32)
        coded = _run_block("HammingEncoder", msg, m=m)[: n * 96]
        np.testing.assert_array_equal(
            coded.astype(np.uint8),
            hamming_encode(msg.astype(np.uint8), m=m))
        frames = coded.reshape(-1, n).copy()
        pos = rng.integers(0, n, len(frames))
        frames[np.arange(len(frames)), pos] = \
            1.0 - frames[np.arange(len(frames)), pos]
        out = _run_block("HammingDecoder", frames.reshape(-1), m=m)[: k * 96]
        np.testing.assert_array_equal(out.astype(np.uint8),
                                      msg.astype(np.uint8))


# -- the slice's registry ---------------------------------------------------------

NEW_TYPES = {
    "fec": ("ConvEncoder", "ViterbiDecoder", "Scrambler", "Descrambler",
            "GolayEncoder", "GolayDecoder", "HammingEncoder", "HammingDecoder"),
    "wifi": ("WifiSource", "WifiDecoder"),
    "lora": ("LoRaSource", "CssDemod", "LoRaDecoder"),
    "ax25": ("Ax25Decoder",),
    "ais": ("AisDecoder", "AisSource"),
    "ble": ("BleSource", "BleDecoder"),
    "sstv": ("SstvSource", "SstvDecoder"),
    "rtty": ("RttySource", "RttyDecoder"),
    "cw": ("CwSource", "CwDecoder"),
    "same": ("SameSource", "SameDecoder"),
}


def _spec(blk):
    return {k: (s.kind, s.choices, s.unit, repr(s.default), s.limits)
            for k, s in blk.settings.spec.items()}


def test_new_types_carry_the_jax_names_and_settings():
    """The 26 block types of the ten modules: registered in both packages
    under the same module, with the same settings (kind, choices, unit,
    default, limits), current values, ports and port dtypes, ratio and
    alignment."""
    names = [n for group in NEW_TYPES.values() for n in group]
    assert len(names) == 26
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
