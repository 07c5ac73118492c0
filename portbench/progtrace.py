#!/usr/bin/env python3
"""Trace one cell from inside the program: the traced run of
``portbench/run.py --trace 1``, with the port's ``Profiler`` built with
``device_ranges`` so that its spans are mirrored on the device, in place of
the harness's ranges around each block, reduced by
``portbench/progspans.py``. It reports no metric of ``BENCHMARK.json`` and
checks no output; it prints, as its last line of standard output, one JSON
object: the four readings of ``progspans`` (``host_blocked_ms``,
``sched_self_ms``, ``dispatch_self_ms``, ``program_setup_s``), the kernel
library's build (its seconds, and whether ``nvcc`` ran in this process), the
share of ``portbench.step``'s host time outside every program span, host,
device and blocked ms a step for each block, and the card's longest idle
gaps with what the host was in. From the root of a checkout, on a machine with a card:

    python3 portbench/progtrace.py --workload fm_monitor.bulk --seed 7
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)
# the scheduler's defaults, as in run.py: rotation absorption on
os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)


def trace_cell(cell, seed: int, device: str, *, steps: int | None = None,
               overrides: dict | None = None) -> dict:
    """Set up ``cell`` as the harness does, trace ``steps`` steps (the
    cell's ``trace_steps``) and reduce the program's spans against them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnuradio4_tpu_torch import Scheduler
    from gnuradio4_tpu_torch.core.profiler import (RANGE_PREFIX, Profiler,
                                                   trace_origin_us)
    from gnuradio4_tpu_torch.ops import cuda_kernels
    from portbench import harness, progspans
    from portbench.blocks import StepSampler

    wl = {**cell.workload, **(overrides or {})}
    cfg = cell.cfg
    cuda = torch.device(device).type == "cuda"
    t_len = int(wl["block_len"])
    replay = cell.cfg_mod.make_input(cfg, int(wl["replay_len"]), seed, device)
    sampler = StepSampler(int(wl["compare_steps"]), seed)
    graph, _sinks, _blocks = cell.cfg_mod.build(cfg, replay, sampler)
    prof_port = Profiler(device_ranges=True)
    sched = Scheduler(graph, block_len=t_len, sample_rate=cfg["sample_rate"],
                      device=device, profiler=prof_port)
    sched.init()
    for _ in range(int(wl["warmup_steps"])):
        sched.step_once()
    if cuda:
        torch.cuda.synchronize()
    first = sched.steps
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as tp:
        window = harness.drive(sched, harness._Marks(cuda), sched.pipeline_depth,
                               steps=steps or int(wl["trace_steps"]), trace=True)
    lib = cuda_kernels._library        # built on its first use, if at all
    red = progspans.reduce(tp.events(), trace_origin_us(tp), prof_port.events(),
                           window["steps"], first, RANGE_PREFIX)
    return {"workload": cell.name, "seed": seed, "steps": red.steps,
            "host_blocked_ms": red.host_blocked_ms,
            "sched_self_ms": red.sched_self_ms,
            "dispatch_self_ms": red.dispatch_self_ms,
            "program_setup_s": red.program_setup_s,
            "kernels_build_s": None if lib is None else lib.seconds,
            "kernels_built": None if lib is None else lib.built,
            "outside_share": red.outside_share,
            "blocks": red.blocks, "idle_gaps": red.idle_gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: progtrace needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = trace_cell(harness.load_cell(args.workload), args.seed, "cuda",
                     steps=args.steps)
    print(f"card: {harness.power_limit()}; {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    for b, v in sorted(out["blocks"].items(), key=lambda kv: -kv[1]["host_ms"]):
        print(f"block {b}: host {v['host_ms']:.4f} ms, device "
              f"{v['device_ms']:.4f} ms, blocked {v['blocked_ms']:.4f} ms a step",
              file=sys.stderr)
    for label, s in out["idle_gaps"]:
        print(f"idle {s * 1e3:.4f} ms: {label}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
