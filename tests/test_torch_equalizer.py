"""The port's block-LMS equalizers (``blocks/equalizer.py``) against the JAX
package's, on the CPU: QPSK through a three-tap multipath channel, 3072
symbols over three steps (the taps carried across the seams), at several
update lengths including one that leaves a remainder.

Tolerance: the outputs and the final taps within ``SCAN_ATOL`` = 1e-4 (the
block-LMS scan's float32 matvecs sum in another order). The CMA case also
holds the reference's own check (``tests/test_equalizer.py``): the eye opens.
"""

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

SCAN_ATOL = 1e-4
CHANNEL = np.array([1.0, 0.35 * np.exp(1j * 0.9),
                    0.18 * np.exp(-1j * 1.7)], np.complex64)


def _rx(n, seed=0):
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    rx = np.convolve(syms, CHANNEL)[:n]
    rx = rx + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return rx.astype(np.complex64)


def _run(pkg, btype, settings, x, block_len):
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=x)
    eq = g.emplace(btype, name="eq", **settings)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, eq, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw)
    s.run_and_wait()
    return np.asarray(snk.data()), np.asarray(s._states[eq.unique_name]["taps"])


@pytest.mark.parametrize("btype, settings", [
    ("CmaEqualizer", {"num_taps": 11, "gain": 0.01}),
    ("CmaEqualizer", {"num_taps": 7, "gain": 0.02, "update_len": 100}),
    ("LmsDDEqualizer", {"num_taps": 11, "gain": 0.02}),
    ("LmsDDEqualizer", {"num_taps": 5, "gain": 0.01, "update_len": 32,
                        "constellation": "8psk"}),
])
def test_equalizer_matches_jax(btype, settings):
    x = _rx(3072)
    yj, wj = _run(gr, btype, settings, x, 1024)
    yt, wt = _run(gt, btype, settings, x, 1024)
    assert yt.shape == yj.shape == (3072,) and yt.dtype == yj.dtype
    assert np.max(np.abs(yt - yj)) <= SCAN_ATOL
    assert np.max(np.abs(wt - wj)) <= SCAN_ATOL


def test_cma_opens_the_eye():
    x = _rx(32768)
    assert np.std(np.abs(x)) > 0.2
    y, _ = _run(gt, "CmaEqualizer", {"num_taps": 11, "gain": 0.01}, x, 8192)
    tail = y[-8192:]
    assert np.std(np.abs(tail)) < 0.08 and abs(np.abs(tail).mean() - 1.0) < 0.1
