"""fm_allband through the port's Scheduler on the CPU (plain paths, small
steps) against its plain reference, what must come out wrong (the
lower-precision control, a bank without its circular shift, a bank at O 1),
its metric readers, and no JAX in its process."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness

CELL = "fm_allband.bulk"
ROOT = harness.ROOT
CHECKOUT = ROOT.parent
METRICS = ("pfb_device_ms", "pfb_roofline_share", "rx_bank_device_ms")
ACCEPTED = ("sched_host_ms", "dispatch_ms", "launches_per_step", "dsp_device_ms",
            "dsp_roofline_share", "device_idle_share")
# whole frames of the bank's phase period and whole outputs of the ÷8 audio
# FIR: steps of 51,200·k samples, as the cell's own
SIZES = (51200, 102400)


def small(bl: int = SIZES[0]) -> dict:
    return {"block_len": bl, "replay_len": 4 * bl, "trace_steps": 6,
            "compare_steps": 3}


def run(seed=2**31 + 17, *, size=0, trace=False, **kw):
    return harness.run_cell(harness.load_cell(CELL), seed, 0.2, trace, "cpu",
                            t_setup0=time.perf_counter(),
                            overrides=small(SIZES[size]), log=lambda _m: None,
                            **kw)


@pytest.mark.parametrize("size", [0, 1])
def test_the_cell_agrees_with_the_plain_reference(size):
    r = run(size=size)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {"channels_err", "audio_err"}
    for v in r["checks"].values():
        assert 0.0 <= v["value"] <= v["limit"]


def test_the_lower_precision_control_fails():
    r = run(seed=5, control=True)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def test_a_bank_without_its_circular_shift_is_not_correct(monkeypatch):
    from gnuradio4_tpu_torch.ops import channelizer as ch

    def no_shift(m, hop, device):
        period = ch.shift_period(m, hop)
        return torch.ones(period, period, m, dtype=torch.complex64, device=device)

    monkeypatch.setattr(ch, "_shift_phases", no_shift)
    r = run()
    assert not r["correct"], r["checks"]
    assert r["checks"]["channels_err"]["value"] > r["checks"]["channels_err"]["limit"]


def test_a_bank_at_o1_in_the_timed_graph_is_not_correct():
    """The timed bank computes the critically sampled channels and holds
    each frame for O output frames: the stream's shape is kept, its
    oversampling is not."""
    from gnuradio4_tpu_torch.ops.channelizer import pfb_analyze, pfb_init_state

    def at_o1(blocks):
        b = blocks["pfb"]
        m = int(b.settings.get("n_channels"))
        p = int(b.settings.get("taps_per_phase"))
        o = int(b.settings.get("oversample_rate"))
        rows = {}

        def apply(state, ins, ctx):
            x = ins["in"].to(torch.complex64)
            st = rows.get("state")
            if st is None:
                st = pfb_init_state(m, p, x.device)
            y, rows["state"] = pfb_analyze(x, b._device_taps(x.device), st)
            return state, {"out": y.repeat_interleave(o, dim=-1)}
        b.apply = apply

    r = run(mutate=at_o1)
    assert not r["correct"], r["checks"]


def test_the_audio_check_sees_the_receivers():
    """A receiver block that drops its carried state is caught by the audio
    check alone: the channels do not go through the receivers."""
    def keep_state(block):
        inner = block.apply

        def apply(state, ins, ctx):
            _new, outs = inner(state, ins, ctx)
            return state, outs
        block.apply = apply

    r = run(mutate=lambda b: keep_state(b["audio_fir"]))
    c = r["checks"]
    assert c["channels_err"]["value"] <= c["channels_err"]["limit"]
    assert c["audio_err"]["value"] > c["audio_err"]["limit"]


def test_each_channel_has_the_firdes_design_response():
    """The configuration hands the bank fm's 963-tap ``firdes.low_pass``
    design with each block of 100 taps reversed, against the port's
    commutator order (the other way round from GNU Radio's). Through the
    cell's PFBChannelizer a tone 75 kHz or 125 kHz off a channel's centre
    comes out at the design's own |H(f)|: −0.37 dB at ±75 kHz, the peak
    deviation, and −28 dB at ±125 kHz."""
    import numpy as np

    from gnuradio4_tpu_torch import Graph, Scheduler
    from gnuradio4_tpu_torch.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu_torch.blocks.testing import VectorSink, VectorSource
    from portbench import dsp

    cell = harness.load_cell(CELL)
    cfg, c = cell.cfg, cell.cfg["channelizer"]
    fs, m, p, o = (cfg["sample_rate"], c["n_channels"], c["taps_per_phase"],
                   c["oversample_rate"])
    design = dsp.firdes_lowpass(1.0, fs, c["cutoff_hz"], c["transition_hz"],
                                c["window"]).astype(np.float64)
    taps = cell.cfg_mod.constants(cfg)["prototype"]
    n, k = SIZES[0], 37
    for f in (75e3, -75e3, 125e3, -125e3):
        want = abs(np.sum(design * np.exp(-2j * np.pi * f / fs
                                          * np.arange(design.size))))
        tone = np.exp(2j * np.pi * (k / m + f / fs) * np.arange(n))
        g = Graph()
        snk = VectorSink()
        g.connect_chain(VectorSource(tone.astype(np.complex64)),
                        PFBChannelizer(n_channels=m, taps_per_phase=p,
                                       oversample_rate=o,
                                       taps=tuple(float(v) for v in taps)),
                        snk)
        Scheduler(g, block_len=n, device="cpu").run_and_wait()
        got = np.abs(np.asarray(snk.data())[k, 2 * p * o:])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        db = 20 * np.log10(want)
        assert (-0.5 < db < -0.2) if abs(f) == 75e3 else (-30 < db < -26), (f, db)


def test_the_new_metrics_are_found_by_name_and_read_the_trace():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cell = harness.load_cell(CELL)
    assert {m["name"] for m in cell.metrics("per_layer")} >= set(METRICS)
    for name in METRICS:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "throughput_msps"
    # the accepted metrics of the layers this cell runs are reported here too
    assert {m["name"] for m in cell.metrics("per_layer")} >= set(ACCEPTED)
    for old in ("fm_monitor.bulk", "pfb_channelizer.bulk"):
        assert not set(METRICS) & {m["name"] for m in
                                   harness.load_cell(old).metrics("per_layer")}
    readers = {n: harness.load_module(ROOT / "metrics" / f"{n}.py", "metric")
               for n in METRICS}
    steps = 4
    trace = SimpleNamespace(steps=steps, block_device_s={
        "pfb": 0.050, "demod": 0.008, "audio_fir": 0.002, "deemph": 0.001})
    bl = 52428800
    r = SimpleNamespace(cell=cell, block_len=bl, trace=trace)
    assert readers["pfb_device_ms"].read(r) == pytest.approx(12.5)
    assert readers["rx_bank_device_ms"].read(r) == pytest.approx(2.75)
    # the bank's bytes: 8 B a sample in, 16 B a sample out, over 3.35 TB/s
    least_ms = 24.0 * bl / 3.35e12 * 1e3
    assert readers["pfb_roofline_share"].read(r) == pytest.approx(
        100.0 * least_ms / 12.5)
    # nothing to read (no trace, or a parent whose bank has no range): None
    for t in (None, SimpleNamespace(steps=steps, block_device_s={})):
        nothing = SimpleNamespace(cell=cell, block_len=bl, trace=t)
        assert all(readers[n].read(nothing) is None for n in METRICS)


def test_the_traced_run_on_the_cpu_reports_no_device_metric():
    r = run(trace=True)
    assert r["correct"], r["checks"]
    assert not set(METRICS) & set(r["metrics"])


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "cell = harness.load_cell(%r)\n"
        "r = harness.run_cell(cell, 1, 0.1, False, 'cpu', "
        "t_setup0=time.perf_counter(), overrides=%r, log=lambda m: None)\n"
        "assert r['correct'], r['checks']\n"
        "assert 'gnuradio4_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n") % (str(CHECKOUT), CELL, small())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_the_cell_is_correct_on_the_card_at_its_own_size(card):
    cell = harness.load_cell(CELL)
    r = harness.run_cell(cell, 2**31 + 97, 1.0, False, card,
                         t_setup0=time.perf_counter(), log=lambda _m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
