#!/usr/bin/env python3
"""Run one cell of the benchmark of gnuradio4_tpu_torch once, on the card.

From the root of a checkout, on a machine with a CUDA card:

    python3 portbench/run.py --workload fm_monitor.bulk --seed 7 --seconds 10 --trace 0

It makes the cell's inputs from ``--seed``, builds its graph, warms up,
drives the port's ``Scheduler`` for ``--seconds`` (with ``--trace 1``: for
the cell's ``trace_steps`` steps under ``torch.profiler``), checks what the
window produced against the plain reference, and prints as its last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit. The same checks are the
last lines of standard error. With no card, or fewer cards than the cell
asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def since_process_start() -> float:
    """Seconds between this process's start and now, from /proc (0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PRE_S = since_process_start()

# every cache a run keeps lies at a fixed path inside the checkout, so only
# the first run of a checkout builds (the port's own nvcc build goes to
# gnuradio4_tpu_torch/_build/ inside the checkout)
CACHE = CHECKOUT / ".portbench_cache"
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
# the configuration runs the scheduler's defaults: rotation absorption on
os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
# the checkout's root, not this folder, heads the import path
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(CHECKOUT)
else:
    sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_imp = time.perf_counter()
    import torch
    t_torch = time.perf_counter()
    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    torch.cuda.init()
    t_cuda = time.perf_counter()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(f"set-up so far: interpreter and script {t_imp - T0 + PRE_S:.3f} s, "
        f"import torch {t_torch - t_imp:.3f} s, CUDA context "
        f"{t_cuda - t_torch:.3f} s")

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_setup0=T0, pre_setup_s=PRE_S, log=log)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
