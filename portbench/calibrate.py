#!/usr/bin/env python3
"""Readings that the comparison's limits are set from, on the card, in one
process: the program on many seeds, and the configuration's control (its
lower-precision stand-in) on a few, each over a short window at the cell's
own sizes. The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload fm_monitor.bulk \
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2

Prints one JSON line a run: the seed, whether it is the control, each
number compared and whether the run came out correct; then, for each
number, the largest reading of the program and the smallest of the control.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)
else:
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell = harness.load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    worst: dict[str, float] = {}
    least: dict[str, float] = {}
    for seed, control in runs:
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                             t_setup0=time.perf_counter(), control=control,
                             log=lambda _m: None)
        found = harness.forbidden_modules()
        if found:
            print(f"calibrate: loaded in this process: {', '.join(found)}",
                  file=sys.stderr)
            return 1
        nums = {k: v["value"] for k, v in r["checks"].items()}
        print(json.dumps({"seed": seed, "control": control,
                          "correct": r["correct"], "numbers": nums,
                          "steps": r["attempted"]}), flush=True)
        book = least if control else worst
        for k, v in nums.items():
            pick = min if control else max
            book[k] = v if k not in book else pick(book[k], v)
    print(json.dumps({"program_largest": worst, "control_smallest": least,
                      "limits": cell.cfg["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
