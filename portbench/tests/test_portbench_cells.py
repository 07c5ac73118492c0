"""Each configuration through the port's Scheduler on the CPU (plain
paths, small steps) against its plain reference, and what must come out
wrong: the configuration's lower-precision control and a broken timed path."""

import time

import pytest
import torch

from portbench import harness

CELLS = ("fm_monitor.bulk", "pfb_channelizer.bulk")
# two small steps a cell: whole frames of its FFT and whole outputs of its
# decimations
SIZES = {"fm_monitor.bulk": (25600, 51200),
         "pfb_channelizer.bulk": (1 << 12, 1 << 14)}


def run(name, seed=2**31 + 17, *, trace=False, seconds=0.2, size=0, **kw):
    cell = harness.load_cell(name)
    bl = SIZES[name][size]
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            t_setup0=time.perf_counter(),
                            overrides={"block_len": bl, "replay_len": 4 * bl,
                                       "trace_steps": 6, "compare_steps": 3},
                            log=lambda _m: None, **kw)


@pytest.mark.parametrize("size", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_plain_reference(name, size):
    r = run(name, size=size)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    for v in r["checks"].values():
        assert 0.0 <= v["value"] <= v["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_fails(name):
    r = run(name, seed=5, control=True)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def _keep_state(block):
    inner = block.apply

    def apply(state, ins, ctx):
        _new, outs = inner(state, ins, ctx)
        return state, outs
    block.apply = apply


def _alter_one(block):
    inner = block.apply

    def apply(state, ins, ctx):
        st, outs = inner(state, ins, ctx)
        y = outs["out"].clone()
        flat = y.reshape(-1)
        flat[5] = flat[5] + 1e-3 * flat.abs().max()
        return st, {"out": y}
    block.apply = apply


def _drop_half(block):
    inner = block.apply

    def apply(state, ins, ctx):
        st, outs = inner(state, ins, ctx)
        y = outs["out"].clone()
        y[..., y.shape[-1] // 2:] = 0
        return st, {"out": y}
    block.apply = apply


FAULTS = {
    "state_unchanged": {"fm_monitor.bulk": ("xlating_fir", _keep_state),
                        "pfb_channelizer.bulk": ("pfb", _keep_state)},
    "answer_altered": {"fm_monitor.bulk": ("fft", _alter_one),
                       "pfb_channelizer.bulk": ("abs", _alter_one)},
    "half_left_out": {"fm_monitor.bulk": ("xlating_fir", _drop_half),
                      "pfb_channelizer.bulk": ("pfb", _drop_half)},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(name, fault):
    block, breaker = FAULTS[fault][name]
    r = run(name, mutate=lambda blocks: breaker(blocks[block]))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("block", ["demod", "audio_fir", "deemph"])
def test_the_fm_audio_check_sees_each_block_of_the_receiver(block):
    """A receiver block that drops its carried state is caught by the audio
    check alone: the spectrum does not go through the receiver."""
    r = run("fm_monitor.bulk", mutate=lambda b: _keep_state(b[block]))
    assert r["checks"]["spectrum_err"]["value"] <= r["checks"]["spectrum_err"]["limit"]
    assert r["checks"]["audio_err"]["value"] > r["checks"]["audio_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_correct_on_the_card_at_its_own_size(name, card):
    cell = harness.load_cell(name)
    r = harness.run_cell(cell, 2**31 + 99, 1.0, False, card,
                         t_setup0=time.perf_counter(), log=lambda _m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card_at_the_cells_own_size(name, card):
    cell = harness.load_cell(name)
    r = harness.run_cell(cell, 2**31 + 98, 1.0, False, card,
                         t_setup0=time.perf_counter(), control=True,
                         log=lambda _m: None)
    assert not r["correct"], r["checks"]
