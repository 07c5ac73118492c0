"""The harness's contract: the form of the result line, files found by name,
no JAX loaded, references that stand alone, and no result without a card."""

import ast
import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness

ROOT = harness.ROOT
CHECKOUT = ROOT.parent
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(config: str) -> dict:
    """Small steps of a cell of ``config``, on the CPU."""
    bl = 25600 if config == "fm_monitor" else 1 << 13
    return {"block_len": bl, "replay_len": 4 * bl, "trace_steps": 6,
            "compare_steps": 2}


def run(cell, trace=False):
    return harness.run_cell(cell, 3, 0.2, trace, "cpu",
                            t_setup0=time.perf_counter(),
                            overrides=small(cell.cfg["name"]),
                            log=lambda _m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_form(trace):
    cell = harness.load_cell("fm_monitor.bulk")
    r = json.loads(json.dumps(run(cell, trace)))
    keys = list(r)
    assert keys[:5] == TOP_KEYS
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == trace
    assert isinstance(r["correct"], bool)
    assert isinstance(r["attempted"], int) and isinstance(r["failed"], int)
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"] for m in cell.metrics(kind)}
    assert r["metrics"], "no metric read"
    for k, v in r["metrics"].items():
        assert names[k] == v["unit"] and isinstance(v["value"], float)
    if not trace:
        assert set(r["metrics"]) == set(names)
    else:
        # the CPU has no device trace: only the host spans' metrics read
        assert set(r["metrics"]) == {"sched_host_ms", "dispatch_ms"}
        for lst in r["breakdown"].values():
            assert len(lst) <= 10
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"}
    lines = harness.check_lines(r)
    assert len(lines) == len(r["checks"]) and all(" (limit " in ln for ln in lines)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A cell and a per-layer metric added as files, with their entries in
    BENCHMARK.json, run without an edit of any existing file."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "workloads" / "pfb_channelizer.bulk.json").read_text())
    wl["traffic"] = "tiny"
    (root / "workloads" / "pfb_channelizer.tiny.json").write_text(json.dumps(wl))
    (root / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else run.trace.steps\n")
    bench["workloads"].append({"name": "pfb_channelizer.tiny",
                               "config": "pfb_channelizer", "traffic": "tiny",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "throughput_msps",
                               "workloads": ["pfb_channelizer.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("pfb_channelizer.tiny", root)
    r = run(cell, trace=True)
    assert r["correct"]
    assert r["metrics"]["steps_traced"] == {"value": 6.0, "unit": "count"}
    # the old cells do not report the new metric
    old = harness.load_cell("pfb_channelizer.bulk", root)
    assert "steps_traced" not in {m["name"] for m in old.metrics("per_layer")}


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    """A cell's set-up and window in a fresh process load neither JAX nor
    the JAX package; the check compares whole top-level names."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('fm_monitor.bulk')\n"
        "r = harness.run_cell(cell, 1, 0.1, False, 'cpu', "
        "t_setup0=time.perf_counter(), overrides=%r, log=lambda m: None)\n"
        "assert 'gnuradio4_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n") % (str(CHECKOUT),
                                                   small("fm_monitor"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_where_a_metric_reader_loads_jax(tmp_path):
    """A module named ``jax`` that a metric's reader imports after the
    window has closed stops the result from being printed."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    (root / "metrics" / "reads_with_jax.py").write_text(
        "def read(run):\n"
        "    import jax  # noqa: F401\n"
        "    return 1.0\n")
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "reads_with_jax", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "throughput_msps",
                               "workloads": ["pfb_channelizer.bulk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "cell = harness.load_cell('pfb_channelizer.bulk', Path(%r))\n"
        "r = harness.run_cell(cell, 1, 0.1, True, 'cpu', "
        "t_setup0=time.perf_counter(), overrides=%r, log=lambda m: None)\n"
        "assert 'reads_with_jax' in r['metrics']\n"
        "sys.exit(harness.emit(r))\n") % (
            str(CHECKOUT), str(tmp_path / "stubs"), str(root),
            small("pfb_channelizer"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 1, out.stderr[-2000:]
    assert out.stdout == ""
    assert "loaded in this process: jax" in out.stderr


def test_a_clean_run_prints_its_result_last():
    import io
    cell = harness.load_cell("pfb_channelizer.bulk")
    r = run(cell)
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit(r, out=out, err=err) == 0
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(json.dumps(r))
    assert err.getvalue().splitlines()[-len(r["checks"]):] == harness.check_lines(r)


def test_device_time_outside_every_block_is_counted_and_listed():
    from types import SimpleNamespace as NS

    from portbench import devtrace

    def ev(name, start, end, device):
        return NS(name=name, time_range=NS(start=start, end=end),
                  device_type="DeviceType.CUDA" if device else "DeviceType.CPU")

    events = [ev("portbench.window", 0, 100, False),
              ev("portbench.block.fir", 10, 40, False),
              ev("portbench.block.fir", 12, 50, True),   # the range's device mirror
              ev("kernel_a", 12, 50, True),
              ev("kernel_b", 60, 80, True)]              # inside no block's range
    red = devtrace.reduce(events, [], steps=1, first_step=0)
    assert red.busy_s == pytest.approx(58e-6)
    assert red.block_device_s == {"fir": pytest.approx(38e-6)}
    assert red.outside_blocks_s == pytest.approx(20e-6)
    assert red.device_ops[-1] == [devtrace.OUTSIDE, pytest.approx(20e-6)]
    run = SimpleNamespace(trace=red, least_ms=0.029)
    dsp = harness.load_module(ROOT / "metrics" / "dsp_device_ms.py", "metric")
    roof = harness.load_module(ROOT / "metrics" / "dsp_roofline_share.py", "metric")
    assert dsp.read(run) == pytest.approx(0.058)
    assert roof.read(run) == pytest.approx(50.0)


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gnuradio4_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnuradio4_tpu.x", sys)
    assert harness.forbidden_modules() == ["gnuradio4_tpu.x"]


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "fm_monitor.bulk", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=CHECKOUT)
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "fm_monitor.bulk", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "gnuradio4_tpu_torch" in out.stderr


def test_every_metric_of_benchmark_json_has_its_reader():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.load_module(ROOT / "metrics" / f"{m['name']}.py", "metric")
        assert callable(mod.read)
    for w in bench["workloads"]:
        assert harness.load_cell(w["name"]).cfg["name"] == w["config"]


def test_benchmark_json_keeps_to_the_contracts_limits():
    import re
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    name_ok = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$").match
    unit_ok = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$").match

    def line_ok(s):
        return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s

    assert 1 <= bench["run_seconds"] <= 51
    assert all(line_ok(w) for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name_ok(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert (CHECKOUT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    names = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name_ok(w["name"]) and name_ok(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        names.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name_ok(m["name"]) and unit_ok(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
