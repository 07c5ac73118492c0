"""The program's spans against a trace (``progspans``), on synthetic event
lists, and ``progtrace`` on the CPU at a small size."""

from types import SimpleNamespace as NS

import pytest

from portbench import devtrace, harness, progspans

RP = "gr4t."
ORIGIN = 1_000_000.0            # the trace's origin on the Profiler's clock


def ev(name, start, end, device=False):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def span(name, start, end, step, **args):
    return {"name": name, "ph": "X", "ts": ORIGIN + start, "dur": end - start,
            "args": {"step": step, **args}}


def _trace(mirrors=True):
    """One step of a window [0, 200]: the harness's ranges, the runtime
    calls, two kernels, and (``mirrors``) the program's device ranges."""
    events = [ev("portbench.window", 0, 200),
              ev("portbench.step", 10, 150),
              ev("portbench.block.fir", 30, 60),
              ev("portbench.block.deemph", 70, 140),
              ev("portbench.block.fir", 32, 90, True),
              ev("portbench.wait", 150, 190),
              ev("cudaLaunchKernel", 35, 37),
              ev("cudaMemcpyAsync", 80, 130),      # waits, inside a block
              ev("cudaStreamSynchronize", 160, 185),   # inside portbench.wait
              ev("fir_kernel", 36, 90, True),
              ev("Memcpy HtoD (Pageable -> Device)", 128, 130, True),
              ev("abs_kernel", 135, 195, True)]
    if mirrors:
        events += [ev(RP + "scheduler.step", 20, 100, True),
                   ev(RP + "scheduler.dispatch", 30, 150, True),
                   ev(RP + "block.apply[fir]", 36, 90, True),
                   ev(RP + "block.apply[deemph]", 128, 195, True)]
    return events


SPANS = [span("scheduler.compile", -500, -300, 0),     # init()'s
         span("scheduler.step", -250, -100, 0),        # a warm-up step
         span("block.apply", -240, -200, 0, block="fir"),
         span("scheduler.step", 12, 148, 1),
         span("scheduler.tags", 14, 20, 1),
         span("scheduler.dispatch", 25, 145, 1),
         span("block.apply", 30, 60, 1, block="fir"),
         span("block.apply", 70, 140, 1, block="deemph"),
         span("scheduler.deliver", 150, 152, 1)]       # after the step (step_once)


def test_devtrace_reads_the_same_without_and_with_the_programs_mirrors():
    """``devtrace`` as the accepted benchmark has it: the program's device
    ranges are off in its traced run, so nothing of its reduction moves."""
    a = devtrace.reduce(_trace(mirrors=False), [], steps=1, first_step=0)
    b = devtrace.reduce(_trace(mirrors=False), SPANS, steps=1, first_step=1)
    for f in ("steps", "window_s", "busy_s", "kernels", "device_ops",
              "idle_gaps", "block_device_s", "outside_blocks_s"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("mirrors", [False, True])
def test_progspans_skips_the_mirrors_as_kernels(mirrors):
    red = progspans.reduce(_trace(mirrors), ORIGIN, SPANS, 1, 1, RP)
    # kernels [36, 90], [128, 130], [135, 195]: the gaps are the same
    assert [round(s * 1e6, 6) for _, s in red.idle_gaps] == [38.0, 36.0, 5.0, 5.0]


def test_host_blocked_counts_waits_inside_program_steps_only():
    red = progspans.reduce(_trace(), ORIGIN, SPANS, 1, 1, RP)
    # cudaMemcpyAsync [80, 130] lies in scheduler.step [12, 148]; the
    # synchronize in portbench.wait and the launch do not count
    assert red.host_blocked_ms == pytest.approx(50e-3)
    assert red.blocks["deemph"]["blocked_ms"] == pytest.approx(50e-3)
    assert red.blocks["fir"]["blocked_ms"] == 0.0


def test_self_times_subtract_the_nested_spans():
    red = progspans.reduce(_trace(), ORIGIN, SPANS, 1, 1, RP)
    # step 136 less tags 6 and dispatch 120 (deliver lies outside)
    assert red.sched_self_ms == pytest.approx(10e-3)
    # dispatch 120 less the blocks' 30 and 70
    assert red.dispatch_self_ms == pytest.approx(20e-3)


def test_setup_blocks_outside_share_and_device_ms():
    red = progspans.reduce(_trace(), ORIGIN, SPANS, 1, 1, RP)
    # compile 200 + the warm-up step 150 (its block's span inside it)
    assert red.program_setup_s == pytest.approx(350e-6)
    assert red.blocks["fir"]["host_ms"] == pytest.approx(30e-3)
    assert red.blocks["fir"]["device_ms"] == pytest.approx(54e-3)
    assert red.blocks["deemph"]["device_ms"] == pytest.approx(62e-3)
    # portbench.step [10, 150]: the program's spans cover [12, 148] and
    # nothing else inside it
    assert red.outside_share == pytest.approx(4 / 140)


def test_a_gap_label_names_the_harness_range_span_and_call():
    red = progspans.reduce(_trace(), ORIGIN, SPANS, 1, 1, RP)
    labels = dict((round(s * 1e6, 6), lbl) for lbl, s in red.idle_gaps)
    assert labels[38.0] == ("portbench.block.deemph > block.apply[deemph] > "
                            "cudaMemcpyAsync")
    assert labels[36.0].startswith("window start")
    assert labels[5.0] in ("portbench.block.deemph > block.apply[deemph]",
                           "window end (host: the closing synchronize)")


def test_a_gap_outside_every_span_names_the_last_span_closed():
    spans = [span("scheduler.step", 12, 60, 1)]
    red = progspans.reduce(_trace(mirrors=False), ORIGIN, spans, 1, 1, RP)
    labels = dict((round(s * 1e6, 6), lbl) for lbl, s in red.idle_gaps)
    assert labels[38.0] == ("portbench.block.deemph > outside the program's "
                            "spans, after scheduler.step > cudaMemcpyAsync")


def test_nothing_to_read_gives_none():
    """No ``scheduler.step`` or ``block.apply`` span in the window (the
    parent program's spans carry no step there) and no ``portbench.step``:
    the self times and the outside share are None, not zero."""
    events = [e for e in _trace(mirrors=False) if e.name != "portbench.step"]
    red = progspans.reduce(events, ORIGIN, SPANS[:1], 1, 1, RP)
    assert red.sched_self_ms is None and red.dispatch_self_ms is None
    assert red.outside_share is None and red.blocks == {}


def test_progtrace_runs_a_cell_on_the_cpu():
    from portbench import progtrace
    cell = harness.load_cell("pfb_channelizer.bulk")
    bl = 1 << 13
    out = progtrace.trace_cell(cell, 3, "cpu", steps=4,
                               overrides={"block_len": bl, "replay_len": 4 * bl,
                                          "compare_steps": 2})
    assert out["steps"] == 4
    assert out["blocks"] and all(v["host_ms"] > 0.0
                                 for v in out["blocks"].values())
    assert out["host_blocked_ms"] == 0.0          # no runtime calls on the CPU
    assert out["sched_self_ms"] > 0.0 and out["dispatch_self_ms"] > 0.0
    assert out["program_setup_s"] > 0.0
    assert out["kernels_built"] is None           # no kernel on the CPU path
    assert 0.0 <= out["outside_share"] < 1.0
