"""What the traced run reads: ``torch.profiler``'s events of the traced
window, and the port's own ``Profiler`` spans, reduced to plain numbers that
the per-layer metric readers (``metrics/<name>.py``) take.

The harness opens, with ``torch.profiler.record_function`` and only in the
traced run:

- ``portbench.window`` around the whole traced window (its last
  ``torch.cuda.synchronize()`` included);
- ``portbench.step`` around each ``Scheduler.step_once()``;
- ``portbench.wait`` around each wait for the step ``pipeline_depth``
  steps back;
- ``portbench.block.<name>`` around each block's ``apply``.

Device intervals are the kernels and memory copies of the trace; a kernel
belongs to a block where it runs inside the device-side mirror of that
block's range. Device time inside the window that no block's range holds
is reported beside the blocks' (``outside_blocks_s``), and as an entry of
the breakdown's device operations, so that work moved out of a block's
``apply`` stays in sight.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

PREFIX = "portbench."
BLOCK_PREFIX = "portbench.block."
OUTSIDE = "portbench: device time outside every block's range"


@dataclasses.dataclass
class TraceReduction:
    steps: int                        # steps in the traced window
    window_s: float                   # the traced window's length
    busy_s: float                     # union of device intervals in it
    kernels: int                      # device kernels launched in it
    device_ops: list                  # [(name, seconds)], most time first
    idle_gaps: list                   # [(what the host was in, seconds)]
    block_device_s: dict              # block name → device seconds inside its range
    outside_blocks_s: float           # device seconds inside no block's range
    spans_s: dict                     # port Profiler span name → seconds


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_within(merged, s0: float, s1: float) -> float:
    """Length of the merged intervals' union inside [s0, s1]."""
    tot = 0.0
    for s, t in merged:
        if t <= s0:
            continue
        if s >= s1:
            break
        tot += min(t, s1) - max(s, s0)
    return tot


def reduce(events, port_spans, steps: int, first_step: int) -> TraceReduction:
    """``events``: ``torch.profiler.profile.events()`` of the traced window;
    ``port_spans``: the port ``Profiler``'s events; the spans of steps
    before ``first_step`` (the warm-up) are left out.

    A block's device time is the union of the device intervals inside the
    device-side mirror of its range (the profiler's GPU user annotation,
    first to last kernel launched inside the range on the host): that holds
    the kernels that the hand-written library launches through its own CUDA
    runtime as well as torch's (the profiler attaches only torch's to the
    range's host ops)."""
    window = next((e for e in events if e.name == PREFIX + "window"
                   and not _is_device(e)), None)
    if window is None:
        raise RuntimeError("the trace has no portbench.window range")
    w0, w1 = window.time_range.start, window.time_range.end
    dev_iv, per_name, n_kernels = [], defaultdict(float), 0
    host_ranges, dev_ranges = [], defaultdict(list)
    for e in events:
        name = e.name
        if _is_device(e):
            if name.startswith(BLOCK_PREFIX):
                dev_ranges[name[len(BLOCK_PREFIX):]].append(
                    (e.time_range.start, e.time_range.end))
                continue
            if name.startswith(PREFIX) or name.startswith("ProfilerStep"):
                continue                  # another range mirrored on the device
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                dev_iv.append((s, t))
            per_name[name] += (e.time_range.end - e.time_range.start) / 1e6
            if not name.startswith(("Memcpy", "Memset")):
                n_kernels += 1
        elif name.startswith(PREFIX) and name != PREFIX + "window":
            host_ranges.append((e.time_range.start, e.time_range.end, name))
    merged = _merge(dev_iv)
    busy_us = sum(t - s for s, t in merged)
    block_us = {b: sum(_union_within(merged, s, t) for s, t in _merge(r))
                for b, r in dev_ranges.items()}
    in_blocks_us = sum(_union_within(merged, s, t) for s, t in
                       _merge([iv for r in dev_ranges.values() for iv in r]))
    outside_us = max(0.0, busy_us - in_blocks_us)
    gaps = []
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t > s:
            gaps.append((s, t))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, t in gaps[:10]:
        if s == w0:
            what = "window start (host: first step's dispatch)"
        elif t == w1:
            what = "window end (host: the closing synchronize)"
        else:
            what = _host_at(host_ranges, 0.5 * (s + t))
        labelled.append((what, (t - s) / 1e6))
    spans = defaultdict(float)
    for ev in port_spans:
        if ev.get("ph") != "X":
            continue
        step = ev.get("args", {}).get("step")
        if step is not None and step < first_step:
            continue
        spans[ev["name"]] += ev["dur"] / 1e6
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])
    if dev_ranges:           # always listed, whatever its size
        ops = ops[:9] + [(OUTSIDE, outside_us / 1e6)]
    ops = ops[:10]
    return TraceReduction(
        steps=steps, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        kernels=n_kernels, device_ops=[[k[:120], v] for k, v in ops],
        idle_gaps=[[k, v] for k, v in labelled],
        block_device_s={k: v / 1e6 for k, v in block_us.items()},
        outside_blocks_s=outside_us / 1e6,
        spans_s=dict(spans))


def _host_at(ranges, t_us: float) -> str:
    """The innermost harness range the host was in at ``t_us``."""
    best = None
    for s, e, name in ranges:
        if s <= t_us <= e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "harness loop (outside the ranges)"
