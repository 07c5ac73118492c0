"""The port's tracing, on the CPU: the Profiler's clock against
``torch.profiler``'s, the ``block.apply`` span per block and step (plain
path, a feedback loop group, an ``sp`` mesh), the scheduler's spans and
their ``step``, the kernel library's record of whether ``nvcc`` built it,
and the device ranges, which only an enabled Profiler opens.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core import profiler as profmod
from gnuradio4_tpu_torch.ops import cuda_kernels
from gnuradio4_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

CLOCK_SLACK_US = 50.0
STEP_SPANS = ("scheduler.step", "scheduler.compile", "scheduler.tags",
              "scheduler.dispatch", "scheduler.retire", "scheduler.deliver",
              "scheduler.to_host", "block.apply", "block.host_feed",
              "block.consume")


def _spans(prof, name=None):
    return [e for e in prof.events() if e["ph"] == "X"
            and (name is None or e["name"] == name)]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _chain():
    g = gt.Graph()
    src = g.emplace("SignalGenerator", frequency=1000.0, n_samples=4096)
    de = g.emplace("FmDeemphasis", tau=75e-6, sample_rate_in=48000.0)
    mul = g.emplace("MultiplyConst", value=2.0)
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(src, de, mul, snk)
    return g, [src.name, de.name, mul.name, snk.name]


def _loop():
    rng = np.random.default_rng(3)
    x = (0.25 * rng.standard_normal(2048)).astype(np.float32)
    g = gt.Graph()
    src = g.emplace("VectorSource", data=x)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO",
                    expression="clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)")
    snk = gt.global_registry.create("VectorSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=64, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=64, fb_init=1.0)
    g.connect(mul, snk)
    return g, [src.name, f"loop[{mul.name},{upd.name}]", snk.name]


def test_span_contains_a_record_function_region_on_the_shared_clock():
    prof = gt.Profiler()
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with prof.duration("outer"):
            with record_function("inner"):
                torch.ones(4096).cumsum(0)
                x = 0
                for i in range(20000):
                    x += i
    origin = profmod.trace_origin_us(tp)
    ev = next(e for e in tp.events() if e.name == "inner")
    start, end = origin + ev.time_range.start, origin + ev.time_range.end
    (span,) = _spans(prof, "outer")
    assert span["ts"] <= start + CLOCK_SLACK_US
    assert span["ts"] + span["dur"] >= end - CLOCK_SLACK_US
    assert start - span["ts"] < 5000.0          # one clock, not two


@pytest.mark.parametrize("case", ["plain", "feedback", "sp"])
def test_one_block_apply_span_per_block_and_step(case):
    build = {"plain": _chain, "feedback": _loop, "sp": _chain}[case]
    g, names = build()
    kw = {"device": "cpu"}
    if case == "sp":
        kw = {"mesh": make_mesh((4,), ("sp",),
                                devices=[torch.device("cpu")] * 4)}
    prof = gt.Profiler()
    gt.Scheduler(g, block_len=1024, sample_rate=48000.0, profiler=prof,
                 pipeline_depth=1, **kw).run_and_wait(n_steps=3)
    dispatch = {e["args"]["step"]: e for e in _spans(prof, "scheduler.dispatch")}
    assert sorted(dispatch) == [0, 1, 2]
    applies = _spans(prof, "block.apply")
    for step, d in dispatch.items():
        mine = [e for e in applies if e["args"]["step"] == step]
        assert sorted(e["args"]["block"] for e in mine) == sorted(names)
        assert all(_inside(e, d) for e in mine)
    assert len(applies) == 3 * len(names)


def test_scheduler_spans_carry_their_step_and_nest():
    g, _ = _chain()
    prof = gt.Profiler()
    sched = gt.Scheduler(g, block_len=1024, sample_rate=48000.0,
                         device="cpu", profiler=prof, pipeline_depth=1)
    sched.init()
    for _ in range(3):
        sched.step_once()
    spans = _spans(prof)
    assert spans and all("step" in e["args"] for e in spans
                         if e["name"] in STEP_SPANS)
    assert {e["name"] for e in spans} >= {
        "scheduler.step", "scheduler.compile", "scheduler.tags",
        "scheduler.dispatch", "scheduler.deliver", "scheduler.to_host",
        "block.apply", "block.consume"}
    first_compile = _spans(prof, "scheduler.compile")[0]
    first_step = _spans(prof, "scheduler.step")[0]
    assert first_compile["args"]["step"] == 0
    assert first_compile["ts"] + first_compile["dur"] <= first_step["ts"]
    delivers = _spans(prof, "scheduler.deliver")
    for th in _spans(prof, "scheduler.to_host"):
        assert any(_inside(th, d) and d["args"]["step"] == th["args"]["step"]
                   for d in delivers)


def test_run_and_wait_retires_inside_the_step():
    """Under the pump the steps that leave the pipeline are delivered
    inside ``scheduler.step``, under ``scheduler.retire``."""
    g, _ = _chain()
    prof = gt.Profiler()
    gt.Scheduler(g, block_len=1024, sample_rate=48000.0, device="cpu",
                 profiler=prof, pipeline_depth=1).run_and_wait(n_steps=3)
    steps = _spans(prof, "scheduler.step")
    retires = _spans(prof, "scheduler.retire")
    assert retires
    for r in retires:
        assert any(_inside(r, s) for s in steps)
        assert any(_inside(d, r) for d in _spans(prof, "scheduler.deliver"))


def test_null_profiler_opens_no_device_range():
    g, _ = _chain()
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        gt.Scheduler(g, block_len=1024, sample_rate=48000.0,
                     device="cpu").run_and_wait(n_steps=2)
    assert not [e for e in tp.events()
                if e.name.startswith(profmod.RANGE_PREFIX)]


def test_device_ranges_mirror_the_spans():
    g, names = _chain()
    prof = gt.Profiler(device_ranges=True)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        gt.Scheduler(g, block_len=1024, sample_rate=48000.0, device="cpu",
                     profiler=prof).run_and_wait(n_steps=2)
    got = {e.name for e in tp.events()
           if e.name.startswith(profmod.RANGE_PREFIX)}
    assert {profmod.RANGE_PREFIX + f"block.apply[{n}]" for n in names} <= got
    assert profmod.RANGE_PREFIX + "scheduler.dispatch" in got


def test_device_trace_overlays_the_spans(tmp_path):
    g, _ = _chain()
    prof = gt.Profiler("overlay_case")
    sched = gt.Scheduler(g, block_len=1024, sample_rate=48000.0,
                         device="cpu", profiler=prof)
    sched.init()
    with prof.device_trace(str(tmp_path)):
        sched.step_once()
    assert not prof.device_ranges
    (path,) = tmp_path.glob("overlay_case.*.trace.json")
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    mine = [e for e in evs if e.get("pid") == "overlay_case spans"
            and e.get("ph") == "X"]
    assert {"scheduler.step", "block.apply"} <= {e["name"] for e in mine}
    rng = next(e for e in evs if e.get("name") == profmod.RANGE_PREFIX
               + "scheduler.step")
    step = next(e for e in mine if e["name"] == "scheduler.step")
    assert step["ts"] <= rng["ts"] + CLOCK_SLACK_US
    assert step["ts"] + step["dur"] >= rng["ts"] + rng["dur"] - CLOCK_SLACK_US


class _StandInLib:
    """Takes the C signatures ``build()`` sets, in place of a loaded
    library."""

    def __getattr__(self, name):
        fn = SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("cached", [False, True])
def test_the_kernel_library_records_whether_nvcc_built_it(monkeypatch,
                                                          tmp_path, cached):
    """``build()`` marks a library it compiled ``built`` and one it only
    loaded from the build directory not; a stand-in compile and load, so no
    ``nvcc`` is needed."""
    so = tmp_path / f"libgr4kernels_{cuda_kernels._source_hash()}.so"
    if cached:
        so.write_bytes(b"")
        so.with_suffix(".log").write_text("cached report")
    compiled = []

    def compile_(path):
        compiled.append(path)
        path.write_bytes(b"")
        return "fresh report"

    monkeypatch.setattr(cuda_kernels, "_library", None)
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_kernels, "_compile", compile_)
    monkeypatch.setattr(cuda_kernels.ctypes, "CDLL", lambda _p: _StandInLib())
    lib = cuda_kernels.build()
    assert lib.built is not cached and lib.path == so
    assert compiled == ([] if cached else [so])
    assert lib.log == ("cached report" if cached else "fresh report")
    assert lib.seconds >= 0.0
    assert cuda_kernels.build() is lib
