"""The port's channel models (``blocks/channels.py``) against the JAX
package's, on the CPU: the same seeded input through each model over several
scheduler steps, then the carried states.

Tolerances: outputs within ``RTOL`` = 1e-5 of max(1, |y|) (the AWGN and the
phase walk are threefry draws through torch's erfinv, which differs from
XLA's by a few ulp; the rest is float32 trigonometry); the threefry keys and
the integer NCO phase exactly. The reference's statistical checks
(``tests/test_channels.py``) hold on the port's output too.
"""

import numpy as np
import pytest
import torch

import jax

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

RTOL = 1e-5
BLOCK = 2048
STEPS = 3


def _input(kind):
    n = BLOCK * STEPS
    if kind == "ones":
        return np.ones(n, np.complex64)
    rng = np.random.default_rng(11)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.7
            ).astype(np.complex64)


def _run(pkg, btype, settings, kind, block_len=BLOCK, steps=STEPS):
    g = pkg.Graph()
    src = pkg.global_registry.create("VectorSource", data=_input(kind))
    blk = pkg.global_registry.create(btype, name="ch", **settings)
    snk = pkg.global_registry.create("VectorSink")
    g.connect_chain(src, blk, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.Scheduler(g, block_len=block_len, sample_rate=1e6, **kw)
    s.run_and_wait(steps)
    state = s._states[blk.unique_name]
    return np.asarray(snk.data()), state


CASES = {
    "awgn": ("ChannelModel", {"noise_voltage": 0.5, "seed": 7}, "ones"),
    "cfo": ("ChannelModel", {"frequency_offset": 0.01}, "ones"),
    "cfo_negative_noise": ("ChannelModel", {"frequency_offset": -0.2371,
                                            "noise_voltage": 0.1, "seed": 3},
                           "noise"),
    "multipath": ("ChannelModel", {"taps": (1.0, 0.5j, -0.25)}, "noise"),
    "all": ("ChannelModel", {"taps": (1.0, -0.3 + 0.2j, 0.1j), "seed": 9,
                             "noise_voltage": 0.2, "frequency_offset": 0.123},
            "noise"),
    "rayleigh": ("FadingModel", {"fD": 5e-4, "seed": 3}, "ones"),
    "rician": ("FadingModel", {"fD": 5e-4, "seed": 3, "K": 10.0}, "noise"),
    "selective": ("SelectiveFadingModel", {"fD": 1e-3, "seed": 2}, "noise"),
    "selective_no_delay": ("SelectiveFadingModel", {"delays": (0,), "mags": (1.0,)},
                           "noise"),
    "phase_noise": ("PhaseNoise", {"std": 0.01, "seed": 4}, "noise"),
    "iq_imbalance": ("IqImbalanceGen", {"magnitude": 1.5, "phase": 7.0}, "noise"),
}


def _leaves(state, path=""):
    if isinstance(state, dict):
        for k in sorted(state):
            yield from _leaves(state[k], f"{path}[{k!r}]")
    elif torch.is_tensor(state):
        yield path, state.numpy()
    elif state is not None:
        if jax.dtypes.issubdtype(state.dtype, jax.dtypes.prng_key):
            state = jax.random.key_data(state)
        yield path, np.asarray(state)


@pytest.mark.parametrize("case", sorted(CASES))
def test_channel_matches_jax(case):
    btype, settings, kind = CASES[case]
    yj, sj = _run(gr, btype, settings, kind)
    yt, st = _run(gt, btype, settings, kind)
    assert yt.shape == yj.shape == (BLOCK * STEPS,) and yt.dtype == yj.dtype
    d = np.abs(yt.astype(np.complex128) - yj)
    assert np.all(d <= RTOL * np.maximum(1.0, np.abs(yj))), float(d.max())
    lj, lt = dict(_leaves(sj)), dict(_leaves(st))
    assert sorted(lt) == sorted(lj)
    for k, w in lj.items():
        g_ = lt[k]
        if w.dtype == np.uint32:            # keys and phases: the uint32 words
            assert g_.dtype == np.int64
            np.testing.assert_array_equal(g_, w.astype(np.int64), err_msg=k)
        else:
            assert g_.dtype == w.dtype and g_.shape == w.shape, k
            np.testing.assert_allclose(g_, w, rtol=RTOL, atol=RTOL, err_msg=k)


def test_channel_model_statistics():
    """tests/test_channels.py's AWGN and CFO checks on the port's output."""
    y, _ = _run(gt, "ChannelModel", {"noise_voltage": 0.5}, "ones",
                block_len=65536, steps=1)
    n = y - 1.0
    assert abs(np.std(n.real) - 0.5) < 0.01 and abs(np.std(n.imag) - 0.5) < 0.01
    assert abs(np.mean(n)) < 0.01
    assert abs(np.mean(n[1:] * np.conj(n[:-1])).real / np.var(n.real) / 2) < 0.02
    y, _ = _run(gt, "ChannelModel", {"frequency_offset": 0.01}, "ones")
    f = np.angle(y[1:] * np.conj(y[:-1])) / (2 * np.pi)
    np.testing.assert_allclose(np.mean(f), 0.01, atol=1e-6)
    assert np.max(np.abs(np.diff(f))) < 1e-4


def test_multipath_seamless_across_steps():
    taps = {"taps": (1.0, -0.3 + 0.2j, 0.1j)}
    a, _ = _run(gt, "ChannelModel", taps, "noise", block_len=BLOCK * STEPS, steps=1)
    b, _ = _run(gt, "ChannelModel", taps, "noise", block_len=256,
                steps=BLOCK * STEPS // 256)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_noise_key_advances_at_zero_voltage():
    """At noise_voltage 0 the draws are skipped but the key moves as the JAX
    package's two draws move it, so a later voltage change draws the same
    noise in both."""
    _, sj = _run(gr, "ChannelModel", {}, "ones")
    _, st = _run(gt, "ChannelModel", {}, "ones")
    np.testing.assert_array_equal(st["key"].numpy(), np.asarray(
        jax.random.key_data(sj["key"])).astype(np.int64))


def _bpsk_through_channel(pkg, x):
    g = pkg.Graph()
    reg = pkg.global_registry
    snk = reg.create("VectorSink")
    g.connect_chain(reg.create("VectorSource", data=x),
                    reg.create("ChannelModel", frequency_offset=0.002,
                               noise_voltage=0.05),
                    reg.create("CostasLoop", order=2, loop_bw=0.02), snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=4096, sample_rate=1e6, **kw).run_and_wait()
    return np.asarray(snk.data())


def test_costas_survives_channel_model():
    """tests/test_channels.py's BPSK through CFO + AWGN recovered by
    CostasLoop(order=2): the port's hard decisions after lock match the
    symbols up to a global sign (> 95%, the JAX test's bound), and its output
    follows the JAX package's per sample within 1e-4 · max(1, |y|) (the
    channel's draws differ by RTOL, the loop carries that)."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 4096)
    sym = (1.0 - 2.0 * bits).astype(np.complex64)
    x = np.repeat(sym, 4).astype(np.complex64)
    y = _bpsk_through_channel(gt, x)
    yj = _bpsk_through_channel(gr, x)
    assert y.shape == yj.shape and y.dtype == yj.dtype
    d = np.abs(y.astype(np.complex128) - yj)
    assert np.all(d <= 1e-4 * np.maximum(1.0, np.abs(yj))), float(d.max())
    tail = y[len(y) // 4:]
    ref = x[len(y) // 4: len(y) // 4 + len(tail)]
    agree = np.mean(np.sign(tail.real) == np.sign(ref.real))
    assert max(agree, 1 - agree) > 0.95
