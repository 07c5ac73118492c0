"""The port's ``blocks/squelch.py`` (and DiffPhasor beside it) against the
JAX package's, on the CPU: every case of ``tests/test_squelch.py`` run
through both packages from the same inputs, the JAX test's own assertions
held on the port's output.

Tolerances: the gates are compared exactly (a sample passes in one package
iff it passes in the other) and the passed samples within ``ATOL`` = 1e-6
(they are the input times 1); the DiffPhasor outputs within 1e-6 of
max(1, |y|), a few float32 ulps.
"""

import time

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

FS = 48000.0
ATOL = 1e-6


def _chain(pkg, data, block_type, block_len=4096, fs=FS, **settings):
    g = pkg.Graph()
    reg = pkg.global_registry
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=np.asarray(data)),
                    reg.create(block_type, **settings), snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=fs, **kw).run_and_wait()
    return np.asarray(snk.data())[: len(data)]


def _both(data, block_type, **kw):
    """The port's output, after holding it to the JAX package's: the same
    gate, the same passed samples."""
    yt = _chain(gt, data, block_type, **kw)
    yj = _chain(gr, data, block_type, **kw)
    assert yt.shape == yj.shape and yt.dtype == yj.dtype
    np.testing.assert_array_equal(yt == 0, yj == 0)
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)
    return yt


class TestPowerSquelch:
    def _burst(self, n=16384, lo=1e-4, hi=0.5):
        x = np.exp(2j * np.pi * 0.01 * np.arange(n)).astype(np.complex64)
        amp = np.full(n, lo, np.float32)
        amp[4096:8192] = hi
        amp[12288:] = hi
        return (x * amp).astype(np.complex64)

    def test_mutes_noise_passes_bursts(self):
        y = _both(self._burst(), "PowerSquelch", threshold_db=-20.0, alpha=0.01)
        settle = 600
        assert np.all(np.abs(y[:4096 - settle]) == 0)
        assert np.all(np.abs(y[4096 + settle:8192]) > 0.4)
        assert np.all(np.abs(y[8192 + settle:12288]) == 0)
        assert np.all(np.abs(y[12288 + settle:]) > 0.4)

    def test_invert_flips_gate(self):
        y = _both(self._burst(), "PowerSquelch", threshold_db=-20.0, alpha=0.01,
                  invert=True)
        settle = 600
        assert np.all(np.abs(y[4096 + settle:8192]) == 0)
        assert np.all(np.abs(y[:4096 - settle]) > 0)

    def test_real_input_and_state_across_steps(self):
        """A real stream gated the same; the envelope carried across 1536-
        sample steps equals one 4096-sample run (the JAX test's 1e-6)."""
        x = np.abs(self._burst()).astype(np.float32)
        y1 = _both(x, "PowerSquelch", threshold_db=-20.0, alpha=0.01)
        y2 = _both(x, "PowerSquelch", threshold_db=-20.0, alpha=0.01,
                   block_len=1536)
        assert y1.dtype == np.float32
        np.testing.assert_allclose(y1, y2, atol=1e-6)

    def test_chunking_invariance(self):
        x = self._burst()
        y1 = _both(x, "PowerSquelch", threshold_db=-20.0, alpha=0.01, block_len=4096)
        y2 = _both(x, "PowerSquelch", threshold_db=-20.0, alpha=0.01, block_len=1536)
        np.testing.assert_allclose(y1, y2, atol=1e-6)

    def test_threshold_is_dynamic_no_recompile(self):
        """A live ``set`` of the threshold opens the gate mid-stream."""
        x = (0.05 * np.exp(2j * np.pi * 0.01 * np.arange(32768))).astype(np.complex64)
        g = gt.Graph()
        reg = gt.global_registry
        sq = reg.create("PowerSquelch", threshold_db=-10.0, alpha=0.01)
        snk = reg.create("VectorSink")
        g.connect_chain(reg.create("VectorSource", data=x), sq, snk)
        sched = gt.Scheduler(g, block_len=4096, sample_rate=FS, device="cpu")
        sched.start()
        deadline = time.time() + 10.0
        opened = False
        while time.time() < deadline:
            sq.settings.set({"threshold_db": -40.0})
            time.sleep(0.01)
            if len(snk.data()) and np.abs(np.asarray(snk.data())).max() > 0:
                opened = True
                break
        sched.request_stop()
        sched.wait_done(timeout=30.0)
        y = np.asarray(snk.data())
        assert opened or np.abs(y[-1024:]).max() > 0


class TestCtcssSquelch:
    def _audio(self, tone_hz, n=16384, tone_amp=0.15):
        t = np.arange(n) / FS
        return (0.3 * np.sin(2 * np.pi * 1100.0 * t)
                + tone_amp * np.sin(2 * np.pi * tone_hz * t)).astype(np.float32)

    def test_passes_matching_tone(self):
        y = _both(self._audio(88.5), "CtcssSquelch", frequency=88.5, level=0.05)
        assert np.abs(y).max() > 0.2

    def test_mutes_missing_and_wrong_tone(self):
        x0 = self._audio(88.5, tone_amp=0.0)
        assert np.all(_both(x0, "CtcssSquelch", frequency=88.5, level=0.05) == 0)
        x1 = self._audio(151.4)
        assert np.all(_both(x1, "CtcssSquelch", frequency=88.5, level=0.05) == 0)

    def test_gate_is_chunk_granular(self):
        n = 16384
        x = self._audio(88.5, n=n)
        x[: n // 2] = self._audio(88.5, n=n // 2, tone_amp=0.0)
        y = _both(x, "CtcssSquelch", frequency=88.5, level=0.05, chunk=2048)
        assert np.all(y[: n // 2] == 0)
        assert np.abs(y[n // 2:]).max() > 0.2

    @pytest.mark.parametrize("tone_amp", [0.01, 0.02, 0.04])
    def test_gate_near_the_level(self, tone_amp):
        """A tone in noise, the level set between two chunks' float64
        tone-to-power ratios around the median: the port opens exactly the
        chunks the JAX package opens, and some but not all."""
        n, chunk = 16384, 1024
        rng = np.random.default_rng(int(tone_amp * 1000))
        x = (self._audio(88.5, n=n, tone_amp=tone_amp)
             + 0.2 * rng.standard_normal(n)).astype(np.float32)
        c = x.astype(np.float64).reshape(-1, chunk)
        bin_ = c @ np.exp(-2j * np.pi * 88.5 / FS * np.arange(chunk))
        ratio = np.sort(np.abs(bin_) ** 2 / (chunk * chunk / 4.0)
                        / np.mean(c * c, axis=-1))
        k = len(ratio) // 2
        level = float(np.sqrt(ratio[k - 1] * ratio[k]))
        y = _both(x, "CtcssSquelch", frequency=88.5, level=level, chunk=chunk)
        open_ = np.any(y.reshape(-1, chunk) != 0, axis=-1)
        assert 0 < open_.sum() < len(open_)


class TestDiffPhasor:
    def test_matches_numpy_and_chunking_invariant(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
             ).astype(np.complex64)
        want = x * np.conj(np.concatenate([[1.0 + 0j], x[:-1]]))
        for bl in (4096, 1280):
            y = _chain(gt, x, "DiffPhasor", block_len=bl)
            np.testing.assert_allclose(y, want.astype(np.complex64), atol=1e-5)
            np.testing.assert_allclose(y, _chain(gr, x, "DiffPhasor", block_len=bl),
                                       atol=1e-6 * max(1.0, np.abs(want).max()))

    def test_dqpsk_identity(self):
        incs = np.pi / 2 * np.array([0, 1, 2, 3, 1, 0, 2] * 100)
        x = np.exp(1j * np.cumsum(incs)).astype(np.complex64)
        y = _chain(gt, x, "DiffPhasor")
        got = np.angle(y[1:]) % (2 * np.pi)
        np.testing.assert_allclose(got, incs[1:] % (2 * np.pi), atol=1e-4)
