"""The port's RDS layer (``blocks/rds.py``) and the receivers built on it,
against the JAX package's, on the CPU: every case of ``tests/test_rds.py``,
and the FM stereo + RDS capstone of ``tests/test_acceptance.py:74``.

Tolerances: the coding layer is host code and compared exactly (checkwords,
syndromes, group bits, the differential and biphase codes, the synthesized
multiplex, decoded groups). The receiver chains run the carrier and clock
loops in float32 in each package; what they must agree on is the decoded
group list, which is compared exactly, with PI, PTY, PS and radiotext.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.blocks import rds as jrds
from gnuradio4_tpu.ops.filter_design import design_fir
from gnuradio4_tpu_torch.blocks import rds

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PI, PTY, PS, RT = 0x52A1, 9, "GR4-TPU!", "HELLO FROM THE TPU SIDE"


# -- the coding layer: exact ------------------------------------------------------

def test_checkwords_and_syndromes_equal_for_every_word():
    rng = np.random.default_rng(0)
    for data in list(range(0, 1 << 16, 257)) + [0xFFFF]:
        assert rds.rds_checkword(data) == jrds.rds_checkword(data)
    for blk in rng.integers(0, 1 << 26, 2000):
        assert rds.block_syndrome(int(blk)) == jrds.block_syndrome(int(blk))
    assert (rds.OFFSET_A, rds.OFFSET_B, rds.OFFSET_C, rds.OFFSET_Cp,
            rds.OFFSET_D) == (jrds.OFFSET_A, jrds.OFFSET_B, jrds.OFFSET_C,
                              jrds.OFFSET_Cp, jrds.OFFSET_D)


def test_group_makers_and_line_codes_equal():
    for vb in (False, True):
        assert rds.encode_group(0x1234, 0x5678, 0x9ABC, 0xDEF0, version_b=vb) == \
            jrds.encode_group(0x1234, 0x5678, 0x9ABC, 0xDEF0, version_b=vb)
    assert rds.make_0a_groups(PI, PTY, "AB") == jrds.make_0a_groups(PI, PTY, "AB")
    for text in ("", "HI", "HELLO", RT, "x" * 70):
        assert rds.make_2a_groups(PI, PTY, text) == jrds.make_2a_groups(PI, PTY, text)
    bits = np.random.default_rng(1).integers(0, 2, 500).astype(np.uint8)
    d = rds.differential_encode(bits)
    np.testing.assert_array_equal(d, jrds.differential_encode(bits))
    np.testing.assert_array_equal(rds.biphase_halves(d), jrds.biphase_halves(d))


@pytest.mark.parametrize("fs, phase, amp", [(228000.0, 0.0, 1.0),
                                            (456000.0, 0.4, -0.5)])
def test_modulate_mpx_equal(fs, phase, amp):
    groups = rds.make_0a_groups(PI, PTY, PS)
    a = rds.modulate_mpx(groups, fs=fs, phase=phase, amplitude=amp)
    np.testing.assert_array_equal(a, jrds.modulate_mpx(groups, fs=fs, phase=phase,
                                                       amplitude=amp))
    with pytest.raises(ValueError):
        rds.modulate_mpx(groups, fs=100000.0)


def test_syndrome_of_valid_block_equals_offset():
    for data in (0x0000, 0x1234, 0xFFFF, 0xBEEF, 0x52A1):
        for off in (rds.OFFSET_A, rds.OFFSET_B, rds.OFFSET_C, rds.OFFSET_Cp,
                    rds.OFFSET_D):
            assert rds.block_syndrome(rds.encode_block(data, off)) == off


def test_single_bit_error_breaks_syndrome():
    blk = rds.encode_block(0x1234, rds.OFFSET_A)
    for i in range(26):
        assert rds.block_syndrome(blk ^ (1 << i)) != rds.OFFSET_A


def test_bit_level_loopback():
    groups = rds.make_0a_groups(0x1234, 5, PS) + rds.make_2a_groups(0x1234, 5, "HELLO")
    diff = rds.differential_encode(np.concatenate([np.asarray(g, np.uint8)
                                                   for g in groups]))
    data = np.concatenate([[diff[0]], diff[1:] ^ diff[:-1]])
    got = rds.decode_bits(data)
    assert got == jrds.decode_bits(data)
    assert len(got) == len(groups) and all(g[0] == 0x1234 for g in got)


def test_block_sync_recovers_after_garbage():
    bits = np.concatenate([np.asarray(g, np.uint8)
                           for g in rds.make_0a_groups(0x4444, 1, "ABCDEFGH")])
    rng = np.random.default_rng(0)
    noisy = np.concatenate([rng.integers(0, 2, 57).astype(np.uint8), bits,
                            rng.integers(0, 2, 31).astype(np.uint8)])
    got = rds.decode_bits(noisy)
    assert got == jrds.decode_bits(noisy)
    assert len(got) >= 3 and any(g[0] == 0x4444 for g in got)


def test_biphase_and_differential():
    np.testing.assert_array_equal(
        rds.differential_encode(np.array([1, 0, 1, 1, 0], np.uint8)), [1, 1, 0, 1, 1])
    np.testing.assert_array_equal(rds.biphase_halves(np.array([1, 0], np.uint8)),
                                  [1.0, -1.0, -1.0, 1.0])


def test_0b_ps_characters_from_block4():
    groups = []
    for addr in range(4):
        b2 = (0x0 << 12) | (1 << 11) | ((PTY & 0x1F) << 5) | addr
        b4 = (ord(PS[2 * addr]) << 8) | ord(PS[2 * addr + 1])
        groups.append(rds.encode_group(PI, b2, PI, b4, version_b=True))
    halves = rds.biphase_halves(rds.differential_encode(
        np.concatenate([np.asarray(g, np.uint8) for g in groups * 2])))
    decs = []
    for dec in (rds.RdsDecoder(), jrds.RdsDecoder()):
        dec._halves = [halves.astype(np.float64)]
        dec._process()
        decs.append(dec)
    assert decs[0].ps == PS and decs[0].pi == PI
    assert decs[0].groups == decs[1].groups


def test_rds_source_feeds_the_same_wave():
    kw = dict(pi=PI, pty=PTY, ps=PS, radiotext=RT)
    a, b = rds.RdsSource(**kw), jrds.RdsSource(**kw)
    np.testing.assert_array_equal(a._wave, b._wave)
    for abs_index, n in ((0, 9600), (len(a._wave) - 100, 300)):
        np.testing.assert_array_equal(a.host_feed(n, abs_index)[0]["out"],
                                      b.host_feed(n, abs_index)[0]["out"])
    limited = rds.RdsSource(n_samples=1000)
    assert limited.host_done(900, 200) == 100 and limited.host_done(0, 200) is None


# -- receiver chains: the same decoded groups in both packages ---------------------

def _run_chain(pkg, mpx, fs):
    taps = design_fir("lowpass", 241, sample_rate=fs, f_low=2400.0)
    g = pkg.Graph()
    reg = pkg.global_registry
    dec = reg.create("RdsDecoder")
    g.connect_chain(reg.create("VectorSource", data=mpx),
                    reg.create("Convert", to="complex64"),
                    reg.create("FreqXlatingFir", center_freq=57000.0, decim=24,
                               taps=tuple(taps.tolist())),
                    reg.create("CostasLoop", order=2, loop_bw=0.01),
                    reg.create("MMSymbolSync", sps=4, gain=0.05), dec)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=9600, sample_rate=fs, **kw).run_and_wait()
    return dec


def _groups():
    return rds.make_0a_groups(PI, PTY, PS) * 3 + rds.make_2a_groups(PI, PTY, RT) * 2


def test_full_chain_phase_offset_and_noise():
    fs = 228000.0
    rng = np.random.default_rng(7)
    mpx = rds.modulate_mpx(_groups(), fs=fs, phase=0.4)
    mpx = mpx + 0.05 * rng.standard_normal(len(mpx)).astype(np.float32)
    dec = _run_chain(gt, mpx, fs)
    assert dec.groups == _run_chain(gr, mpx, fs).groups
    assert dec.pi == PI and dec.pty == PTY
    assert dec.ps == PS and dec.radiotext == RT
    assert len(dec.groups) >= 14


def test_polarity_inversion_is_transparent():
    fs = 228000.0
    mpx = rds.modulate_mpx(_groups(), fs=fs, phase=0.0, amplitude=-1.0)
    dec = _run_chain(gt, mpx, fs)
    assert dec.groups == _run_chain(gr, mpx, fs).groups
    assert dec.pi == PI and dec.ps == PS


def test_rds_source_seamless_cyclic():
    """examples/rds_receiver.yaml through the port's ``run_grc`` (its
    ``meta:`` section is not read, in either package: steps of 65568
    samples, 2732 into the Costas loop). The JAX test runs 60 steps and asks
    for > 100 groups; on the CPU this runs 16 (about five cycles of the
    source's group schedule, each with its seam) and asks for every group
    the run's bits hold but the two the receiver's start-up takes, which a
    seam that corrupted its group would fail. ``chip_smoke.py`` phase 24
    runs the 60 steps on the card."""
    text = (ROOT / "examples" / "rds_receiver.yaml").read_text()
    sched = gt.run_grc(text, n_steps=16, scheduler_kwargs={"device": "cpu"})
    blocks = {b.name: b for b in sched.graph.blocks}
    assert sched.compiled.in_len[blocks["carrier"].unique_name] == 2732
    dec = blocks["rds"]
    dec._process()
    assert dec.pi == PI and dec.ps == PS and dec.radiotext == RT
    n_bits = 16 * sched.compiled.out_len[blocks["clock"].unique_name] // 2
    assert len(dec.groups) >= n_bits // 104 - 2


# -- the capstone: FM stereo + RDS in one flowgraph ---------------------------------

def _capstone(pkg):
    fs_if, dev = 456000.0, 75000.0
    rds_wave = rds.modulate_mpx(rds.make_0a_groups(PI, PTY, PS) * 4, fs=fs_if)
    t = np.arange(len(rds_wave)) / fs_if
    left, right = np.sin(2 * np.pi * 800.0 * t), np.sin(2 * np.pi * 1400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    mpx = (0.20 * (left + right) + 0.1 * np.sin(th)
           + 0.20 * (left - right) * np.sin(2 * th) + 0.08 * rds_wave)
    tx = np.exp(1j * 2 * np.pi * np.cumsum(dev * mpx) / fs_if).astype(np.complex64)
    reg = pkg.global_registry
    g = pkg.Graph()
    lp = reg.create("FirFilter", decim=2, taps=tuple(design_fir(
        "lowpass", 121, sample_rate=fs_if, f_low=80000.0).tolist()))
    st = reg.create("FmStereoDecoder", sample_rate_in=228000.0)
    kl, kr = reg.create("VectorSink"), reg.create("VectorSink")
    dec = reg.create("RdsDecoder")
    g.connect_chain(reg.create("VectorSource", data=tx),
                    reg.create("QuadratureDemod", gain=fs_if / (2 * np.pi * dev)), lp)
    g.connect(lp["out"], st["in"])
    g.connect(st["left"], kl["in"])
    g.connect(st["right"], kr["in"])
    cvt = reg.create("Convert", to="complex64")
    g.connect(lp["out"], cvt["in"])
    g.connect_chain(cvt, reg.create("FreqXlatingFir", center_freq=57000.0, decim=24,
                                    f_cut=2400.0, ntaps=241),
                    reg.create("CostasLoop", order=2, loop_bw=0.01),
                    reg.create("MMSymbolSync", sps=4, gain=0.05), dec)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=48000, sample_rate=fs_if, **kw).run_and_wait()
    return np.asarray(kl.data()), np.asarray(kr.data()), dec


def _tone(y, f0):
    seg = y[65536:65536 + 131072] * np.hanning(131072)
    spec = np.abs(np.fft.rfft(seg))
    return spec[np.argmin(np.abs(np.fft.rfftfreq(131072, 1 / 228000.0) - f0))]


def test_full_fm_broadcast_stereo_plus_rds():
    """The JAX capstone's assertions on the port: > 40 dB stereo separation
    on both sides and a full PI/PS decode; the decoded groups equal the JAX
    package's."""
    yl, yr, dec = _capstone(gt)
    sep_l = 20 * np.log10(_tone(yl, 800) / (_tone(yl, 1400) + 1e-12))
    sep_r = 20 * np.log10(_tone(yr, 1400) / (_tone(yr, 800) + 1e-12))
    assert sep_l > 40 and sep_r > 40, (sep_l, sep_r)
    assert dec.pi == PI and dec.ps == PS
    assert len(dec.groups) >= 12
    assert dec.groups == _capstone(gr)[2].groups
