"""The port's stream utility blocks (``blocks/util_blocks.py``) against the
JAX package's, on the CPU: the same seeded inputs over several scheduler
steps.

Tolerances: data movements, comparators, gates and holds exactly (bit for
bit); the moving average, DC blocker and integrator within ``RTOL`` = 1e-5
of max(1, |y|) (float32 sums in another order).
"""

import time

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

RTOL = 1e-5
N = 1024
STEPS = 3


def _inputs():
    rng = np.random.default_rng(2026)
    n = N * STEPS
    return {
        "f": (rng.standard_normal(n) + 0.3).astype(np.float32),
        "c": (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64),
        "i": rng.integers(-50, 50, n).astype(np.int32),
        "gate": np.where(rng.random(n) < 0.2, 1.0, -1.0).astype(np.float32),
        "f2": (rng.standard_normal((2, n)) + 2.0).astype(np.float32),
    }


def _run(pkg, btype, settings, ins, block_len=N, steps=STEPS):
    data = _inputs()
    g = pkg.Graph()
    reg = pkg.global_registry
    blk = reg.create(btype, name="dut", **settings)
    g.add(blk)
    for port, key in ins.items():
        g.connect(reg.create("VectorSource", data=data[key], name=f"src_{port}"),
                  blk[port])
    snk = reg.create("VectorSink")
    g.connect(blk["out"], snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, sample_rate=48e3, **kw).run_and_wait(steps)
    return np.asarray(snk.data())


CASES = {
    # name: (type, settings, inputs, exact)
    "Throttle": ("Throttle", {"sample_rate": 1e9}, {"in": "c"}, True),
    "MovingAverage": ("MovingAverage", {"length": 16}, {"in": "f"}, False),
    "MovingAverage_complex": ("MovingAverage", {"length": 31, "scale": 0.5},
                              {"in": "c"}, False),
    "MovingAverage_channels": ("MovingAverage", {"length": 9}, {"in": "f2"}, False),
    "MovingAverage_one": ("MovingAverage", {"length": 1}, {"in": "f"}, True),
    "MovingAverage_prefix": ("MovingAverage", {"length": 5000}, {"in": "f"}, False),
    "DcBlocker": ("DcBlocker", {"pole": 0.99}, {"in": "f"}, False),
    "DcBlocker_channels": ("DcBlocker", {}, {"in": "f2"}, False),
    "Threshold": ("Threshold", {"level": 0.25}, {"in": "f"}, True),
    "MuteSwitch_on": ("MuteSwitch", {"mute": True}, {"in": "c"}, True),
    "MuteSwitch_off": ("MuteSwitch", {}, {"in": "i"}, True),
    "KeepOneInN": ("KeepOneInN", {"n": 4, "offset": 5}, {"in": "c"}, True),
    "Repeat": ("Repeat", {"n": 3}, {"in": "i"}, True),
    "Integrate": ("Integrate", {"n": 8}, {"in": "f"}, False),
    "Integrate_int": ("Integrate", {"n": 16}, {"in": "i"}, True),
    "PeakDetector": ("PeakDetector", {"threshold": 0.5}, {"in": "f"}, True),
    "PeakDetector_channels": ("PeakDetector", {}, {"in": "f2"}, True),
    "SampleAndHold": ("SampleAndHold", {}, {"in": "f", "ctrl": "gate"}, True),
    "SampleAndHold_complex": ("SampleAndHold", {}, {"in": "c", "ctrl": "gate"}, True),
    "DiffPhasor": ("DiffPhasor", {}, {"in": "c"}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_util_block_matches_jax(case):
    btype, settings, ins, exact = CASES[case]
    want = _run(gr, btype, settings, ins)
    got = _run(gt, btype, settings, ins)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(got.astype(np.complex128) - want)
        assert np.all(d <= RTOL * np.maximum(1.0, np.abs(want))), float(d.max())


def test_sample_and_hold_carries_the_held_value():
    """A gate closed over a whole step holds the value sampled in the step
    before; the loop-free hold equals the sequential one."""
    x = np.arange(1.0, 3 * N + 1, dtype=np.float32)
    gate = -np.ones(3 * N, np.float32)
    gate[[5, N - 1, 2 * N + 7]] = 1.0
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        blk = g.emplace("SampleAndHold")
        g.connect(g.emplace("VectorSource", data=x), blk["in"])
        g.connect(g.emplace("VectorSource", data=gate), blk["ctrl"])
        snk = g.emplace("VectorSink")
        g.connect(blk["out"], snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=N, sample_rate=1e3, **kw).run_and_wait(3)
        outs.append(np.asarray(snk.data()))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1][N + 100] == N and outs[1][2 * N + 7] == 2 * N + 8
    assert outs[1][0] == 0.0


def test_sample_and_hold_refuses_channels():
    g = gt.Graph()
    blk = g.emplace("SampleAndHold")
    g.connect(g.emplace("VectorSource", data=np.zeros((2, 64), np.float32)),
              blk["in"])
    g.connect(g.emplace("VectorSource", data=np.zeros((2, 64), np.float32)),
              blk["ctrl"])
    g.connect(blk["out"], g.emplace("NullSink"))
    with pytest.raises(GrError, match="single-channel"):
        gt.Scheduler(g, block_len=64, device="cpu").run_and_wait(1)


def test_throttle_paces_the_pump():
    g = gt.Graph()
    g.connect_chain(g.emplace("NullSource"), g.emplace("Throttle", sample_rate=20480.0),
                    g.emplace("NullSink"))
    t0 = time.monotonic()
    gt.Scheduler(g, block_len=1024, device="cpu").run_and_wait(5)
    assert time.monotonic() - t0 >= 4 * 1024 / 20480.0
