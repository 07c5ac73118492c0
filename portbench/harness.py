"""The benchmark's machinery: find a cell's files by name, make its inputs,
run the port's ``Scheduler`` over its graph for a measured window, check what
the window produced against the plain reference, and read the metrics.

Everything that belongs to one cell, configuration or metric is a file of its
own, found by name:

- ``workloads/<cell>.json``: the configuration's name and the traffic;
- ``configs/<config>.json``: the configuration as it is run (sizes,
  settings, source, assumed, reduced, the control, the comparison's limits);
- ``configs/<config>.py``: ``constants``, ``build``, ``make_input`` and
  ``least_work`` of that configuration;
- ``reference/<config>.py``: ``history`` and ``outputs``, the plain
  reference;
- ``metrics/<metric>.py``: ``read(run)``, one metric, or None where there is
  nothing to read.

Which metrics a cell reports, and their units, come from ``BENCHMARK.json``
beside the benchmark's folder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from portbench.blocks import StepSampler
from portbench.yardstick import bound_ms

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnuradio4_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str) -> ModuleType:
    """The module in ``path``, loaded under a name of its own."""
    name = f"portbench_{tag}_{path.stem.replace('.', '_')}_{abs(hash(str(path)))}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the cell's entry of BENCHMARK.json
    workload: dict              # workloads/<cell>.json
    cfg: dict                   # configs/<config>.json
    cfg_mod: ModuleType
    ref_mod: ModuleType
    bench: dict                 # BENCHMARK.json
    root: Path

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    wl = load_json(root / "workloads" / f"{name}.json")
    if wl["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config {wl['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    cname = wl["config"]
    return Cell(name=name, entry=entry, workload=wl,
                cfg=load_json(root / "configs" / f"{cname}.json"),
                cfg_mod=load_module(root / "configs" / f"{cname}.py", "config"),
                ref_mod=load_module(root / "reference" / f"{cname}.py", "reference"),
                bench=bench, root=root)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``gnuradio4_tpu_torch`` is not ``gnuradio4_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# -- the window ---------------------------------------------------------------

class _Marks:
    """Per-step completion marks: CUDA events on the card, the host clock
    after each (synchronous) step on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def interval_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _wrap_apply(block, tag: str) -> None:
    """Open a ``record_function`` range around ``block``'s ``apply``."""
    inner = block.apply

    def apply(state, ins, ctx):
        with torch.profiler.record_function(tag):
            return inner(state, ins, ctx)

    block.apply = apply


def drive(sched, marks: _Marks, depth: int, *, seconds: float | None = None,
          steps: int | None = None, trace: bool = False) -> dict:
    """The closed loop: ``step_once()`` again as soon as the step
    ``depth`` steps back has completed (the bound the scheduler's own pump
    keeps with ``pipeline_depth`` for a sink that waits for its data), for
    ``seconds`` of host time or ``steps`` steps. The window ends with a
    synchronize; every step's completion is marked."""
    rf = torch.profiler.record_function if trace else (lambda _n: contextlib.nullcontext())
    ms = []
    with rf("portbench.window"):
        t0 = time.perf_counter()
        start = marks.mark()
        k = 0
        while True:
            if k >= depth:
                with rf("portbench.wait"):
                    marks.wait(ms[k - depth])
            with rf("portbench.step"):
                if not sched.step_once():
                    raise RuntimeError("the graph ended inside the window")
            ms.append(marks.mark())
            k += 1
            if steps is not None and k >= steps:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        _sync(marks.cuda)
        t1 = time.perf_counter()
    intervals = [marks.interval_ms(start, ms[0])] + [
        marks.interval_ms(a, b) for a, b in zip(ms, ms[1:])]
    return {"steps": k, "seconds": t1 - t0, "intervals_ms": intervals}


# -- the comparison -----------------------------------------------------------

def step_input(replay: torch.Tensor, start: int, hist: int, t: int) -> torch.Tensor:
    """Input samples ``[start − hist, start + t)`` of the replayed stream."""
    n = replay.shape[-1]
    lo = (start - hist) % n
    if lo + hist + t <= n:
        return replay[lo:lo + hist + t]
    idx = torch.arange(lo, lo + hist + t, device=replay.device) % n
    return replay[idx]


def compare(prog: dict, ref: dict) -> dict[str, float]:
    """``<sink>_err``: the largest |program − reference| over the largest
    |reference|, for each sink."""
    out = {}
    for name, r in ref.items():
        p = prog[name].to(torch.float64)
        if p.shape != r.shape:
            raise ValueError(f"{name}: program shape {tuple(p.shape)}, "
                             f"reference {tuple(r.shape)}")
        out[f"{name}_err"] = float((p - r).abs().max() / r.abs().max())
    return out


def check_outputs(cell: Cell, replay, kept: dict, block_len: int,
                  control_dtype=None) -> dict:
    """Every kept step against the reference. ``kept``: sink → {step:
    tensor}. With ``control_dtype`` the reference computed in that precision
    stands in the program's place. Returns the worst number of each kind
    over the steps, the steps compared and the steps that failed."""
    consts = cell.cfg_mod.constants(cell.cfg)
    hist = cell.ref_mod.history(cell.cfg)
    limits = cell.cfg["limits"]
    steps = sorted(set.intersection(*(set(v) for v in kept.values())))
    worst: dict[str, float] = {}
    failed = 0
    for s in steps:
        x = step_input(replay, s * block_len, hist, block_len)
        ref = cell.ref_mod.outputs(x, cell.cfg, block_len, consts)
        if control_dtype is None:
            prog = {k: v[s] for k, v in kept.items()}
        else:
            prog = cell.ref_mod.outputs(x, cell.cfg, block_len, consts, control_dtype)
        nums = compare(prog, ref)
        failed += any(not (v <= limits[k]) for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v) if math.isfinite(v) else math.inf
        del ref, prog
    return {"numbers": worst, "steps": steps, "failed": failed}


# -- one run ------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             *, t_setup0: float, pre_setup_s: float = 0.0,
             overrides: dict | None = None, mutate=None,
             control: bool = False, log=print) -> dict:
    """One run of ``cell``: set-up, the measured (or traced) window, the
    comparison, the metrics. Returns the result object of the contract.
    ``t_setup0``: ``time.perf_counter()`` when the process's own set-up began
    (``pre_setup_s`` before that is added). ``overrides`` replaces traffic
    parameters (tests run small); ``mutate(blocks)`` may break the timed path
    (tests). ``control`` runs the configuration's control in place of the
    program (``calibrate.py`` and the tests): the program at its ``control``
    settings, or the reference computed in the control's type standing in
    for the program's outputs."""
    from gnuradio4_tpu_torch import Scheduler
    from gnuradio4_tpu_torch.core.profiler import Profiler

    wl = {**cell.workload, **(overrides or {})}
    cfg = cell.cfg
    ctl = cfg["control"]
    variant, control_dtype = {}, None
    if control and ctl["kind"] == "program":
        variant = ctl["settings"]
    elif control:
        control_dtype = getattr(torch, ctl["dtype"])
    cuda = torch.device(device).type == "cuda"
    t_len, n_replay = int(wl["block_len"]), int(wl["replay_len"])
    phases = {"import": time.perf_counter() - t_setup0}
    tp = time.perf_counter()
    replay = cell.cfg_mod.make_input(cfg, n_replay, seed, device)
    _sync(cuda)
    phases["replay"] = time.perf_counter() - tp
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sampler = StepSampler(int(wl["compare_steps"]), seed)
    graph, sinks, blocks = cell.cfg_mod.build(cfg, replay, sampler, **variant)
    if mutate is not None:
        mutate(blocks)
    port_prof = Profiler() if trace else None
    sched = Scheduler(graph, block_len=t_len, sample_rate=cfg["sample_rate"],
                      device=device, profiler=port_prof)
    if trace:
        for name, b in blocks.items():
            _wrap_apply(b, f"portbench.block.{name}")
    tp = time.perf_counter()
    sched.init()
    phases["compile"] = time.perf_counter() - tp
    tp = time.perf_counter()
    for _ in range(int(wl["warmup_steps"])):
        sched.step_once()
    _sync(cuda)
    phases["warmup"] = time.perf_counter() - tp
    marks = _Marks(cuda)
    depth = sched.pipeline_depth
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    first = sched.steps
    sampler.first = first
    setup_s = pre_setup_s + time.perf_counter() - t_setup0
    if trace:
        window = drive(sched, marks, depth, steps=int(wl["trace_steps"]), trace=True)
        prof.stop()
    else:
        window = drive(sched, marks, depth, seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in this process: {', '.join(found)}")
    red = None
    if trace:
        from portbench import devtrace
        red = devtrace.reduce(prof.events(), port_prof.events(),
                               window["steps"], first)
        del prof
    kept = {name: s.outputs() for name, s in sinks.items()}
    del sched, graph, blocks, sinks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = check_outputs(cell, replay, kept, t_len, control_dtype=control_dtype)
    del kept
    least_ms, bound_by = bound_ms(*cell.cfg_mod.least_work(cfg, t_len))
    run = SimpleNamespace(cell=cell, block_len=t_len, window=window,
                          setup_s=setup_s, trace=red, least_ms=least_ms)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        reader = load_module(cell.root / "metrics" / f"{m['name']}.py", "metric")
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cfg["limits"]
    numbers = checked["numbers"]
    correct = (bool(checked["steps"]) and checked["failed"] == 0
               and set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))
    result = {"correct": correct, "attempted": window["steps"],
              "failed": checked["failed"], "metrics": metrics,
              "device": device_record(cuda, peak, red)}
    if red is not None:
        result["breakdown"] = {"device_ops": red.device_ops,
                               "idle_gaps": red.idle_gaps}
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                        for k in limits}
    log(f"set-up {setup_s:.3f} s: before the script {pre_setup_s:.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    log(f"least time a step {least_ms:.6f} ms ({bound_by}); compared steps "
        f"{checked['steps']}")
    if red is not None:
        log(f"traced {red.steps} steps: window {red.window_s:.6f} s, device "
            f"busy {red.busy_s:.6f} s, {red.kernels} kernels; device s by "
            f"block {red.block_device_s}, outside every block's range "
            f"{red.outside_blocks_s}; host spans s {red.spans_s}")
    return result


def device_record(cuda: bool, peak: int, red) -> dict:
    if cuda:
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if red is not None:
        rec["busy_s"] = red.busy_s
        rec["window_s"] = red.window_s
    return rec


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or f"not read ({out.stderr.strip()})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def check_lines(result: dict) -> list[str]:
    """Each number compared beside its limit, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]


def emit(result: dict, out=None, err=None) -> int:
    """Print the run's result: the card's name and power limit, then each
    number compared beside its limit as the last lines of standard error
    and, as the last line of standard output, the result object. Prints no
    result, and returns 1, where JAX or the JAX package has been loaded
    since the window (by a metric's reader, say)."""
    out = out or sys.stdout
    err = err or sys.stderr
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=err, flush=True)
        return 1
    print(f"card: {power_limit()}", file=out, flush=True)
    for line in check_lines(result):
        print(line, file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
