"""The port's own spans against the ``torch.profiler`` trace of the traced
window, on one clock.

The port's ``Profiler`` stamps its spans in Unix-epoch µs, the clock of
``torch.profiler``; ``origin_us`` (the port's
``core.profiler.trace_origin_us`` of the finished profile) turns them into
the trace's own µs. Built with ``device_ranges``, the Profiler also opens
each span as a ``record_function`` range named ``RANGE_PREFIX + name[block]``,
which the trace mirrors on the device: a block's device time is the union
of the device intervals inside its ``block.apply`` range's mirror, as
``devtrace`` does for the harness's ``portbench.block.<name>`` ranges.

What it reads, over the traced window's steps:

- ``host_blocked_ms``: host ms a step inside CUDA runtime calls that wait
  for the card or allocate its memory (``BLOCKING``) and lie inside the program's
  ``scheduler.step`` spans (so not inside the harness's ``portbench.wait``
  nor the window's closing synchronize);
- ``sched_self_ms``: ``scheduler.step`` less the time the spans nested in it
  cover; ``dispatch_self_ms``: ``scheduler.dispatch`` less its
  ``block.apply`` spans;
- ``program_setup_s``: the union of the program's set-up spans before the
  window: ``scheduler.compile`` (``init()``'s included) and the warm-up
  steps' ``scheduler.step`` (the kernel library's build on its first use
  falls inside the first one);
- per block: host ms (its ``block.apply`` spans), device ms (its range's
  mirror) and blocked ms (``BLOCKING`` calls inside its spans);
- ``outside_share``: the share of the harness's ``portbench.step`` host time
  that lies outside every program span;
- ``idle_gaps``: the card's longest idle gaps, each labelled with the
  harness range, the innermost program span (with its block; or the last
  span that had closed) and the CUDA runtime call the host was in at the
  gap's middle.

A range of the harness's around a block's ``apply`` would take the kernels
from the program's range around it: the profiler mirrors a kernel only in
the innermost range. ``progtrace`` opens none.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from portbench.devtrace import PREFIX

# runtime calls that wait for the card or allocate its memory
BLOCKING = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMalloc", "cudaFree")
SETUP_SPANS = ("scheduler.compile", "scheduler.step")


@dataclasses.dataclass
class ProgSpans:
    steps: int
    host_blocked_ms: float
    sched_self_ms: float | None
    dispatch_self_ms: float | None
    program_setup_s: float
    blocks: dict           # block → {"host_ms", "device_ms", "blocked_ms"}
    outside_share: float | None
    idle_gaps: list        # [(label, seconds)], longest first


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


def _iv(e) -> tuple[float, float]:
    return e.time_range.start, e.time_range.end


def _overlap(a, b) -> float:
    """Length of the intersection of two interval lists' unions."""
    a, b = _merge(a), _merge(b)
    ends = [t for _, t in a]
    tot = 0.0
    for s, t in b:
        i = bisect.bisect_right(ends, s)
        while i < len(a) and a[i][0] < t:
            tot += min(t, a[i][1]) - max(s, a[i][0])
            i += 1
    return tot


def _self_us(outer, spans) -> float:
    """Summed length of ``outer`` less the time the ``spans`` nested in it
    cover."""
    return sum(t - s for s, t in outer) - _overlap(outer, spans)


def _label(span) -> str:
    block = span["args"].get("block")
    return span["name"] + (f"[{block}]" if block is not None else "")


def _innermost(items, t: float):
    """The item (start, end, payload) containing ``t`` that started last."""
    best = None
    for s, e, x in items:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, x)
    return None if best is None else best[1]


def reduce(events, origin_us: float, port_spans, steps: int, first_step: int,
           range_prefix: str) -> ProgSpans:
    """``events``: ``torch.profiler.profile.events()`` of the traced window;
    ``origin_us``: that trace's origin on the port Profiler's clock;
    ``port_spans``: the Profiler's events, set-up included;
    ``first_step``: the window's first step; ``range_prefix``: the port's
    ``core.profiler.RANGE_PREFIX``."""
    window = next(e for e in events
                  if e.name == PREFIX + "window" and not _is_device(e))
    w0, w1 = _iv(window)
    dev_iv, mirrors, harness, runtime = [], defaultdict(list), [], []
    for e in events:
        name = e.name
        if _is_device(e):
            if name.startswith(range_prefix + "block.apply["):
                mirrors[name[len(range_prefix) + len("block.apply["):-1]] \
                    .append(_iv(e))
            elif not name.startswith((PREFIX, range_prefix, "ProfilerStep")):
                s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
                if t > s:
                    dev_iv.append((s, t))
        elif name.startswith(PREFIX) and name != PREFIX + "window":
            harness.append((*_iv(e), name))
        elif name.startswith("cuda"):
            runtime.append((*_iv(e), name))
    merged = _merge(dev_iv)

    # the program's spans on the trace's clock; the window's and set-up's
    window_spans, setup = [], []
    for ev in port_spans:
        if ev.get("ph") != "X":
            continue
        s = ev["ts"] - origin_us
        span = (s, s + ev["dur"], ev)
        step = ev.get("args", {}).get("step")
        if step is not None and step >= first_step:
            window_spans.append(span)
        elif s < w0 and ev["name"] in SETUP_SPANS:
            setup.append((s, s + ev["dur"]))
    by_name = defaultdict(list)
    for s, t, ev in window_spans:
        by_name[ev["name"]].append((s, t))

    blocking = [(s, t) for s, t, n in runtime if n.startswith(BLOCKING)]

    def blocked_in(spans) -> float:
        return _overlap(spans, blocking)

    per_block = defaultdict(list)
    for s, t, ev in window_spans:
        if ev["name"] == "block.apply":
            per_block[ev["args"]["block"]].append((s, t))
    blocks = {}
    for b, spans in per_block.items():
        blocks[b] = {
            "host_ms": sum(t - s for s, t in spans) / steps / 1e3,
            "device_ms": _overlap(merged, mirrors.get(b, [])) / steps / 1e3,
            "blocked_ms": blocked_in(spans) / steps / 1e3}

    all_spans = [(s, t) for s, t, _ in window_spans]
    pstep = _merge([(s, t) for s, t, n in harness if n == PREFIX + "step"])
    step_us = sum(t - s for s, t in pstep)
    covered = _overlap(all_spans, pstep)
    nested = [iv for n, ivs in by_name.items() if n != "scheduler.step"
              for iv in ivs]

    gaps = []
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t > s:
            gaps.append((s, t))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, t in gaps[:10]:
        if s == w0:
            parts = ["window start (host: first step's dispatch)"]
        elif t == w1:
            parts = ["window end (host: the closing synchronize)"]
        else:
            mid = 0.5 * (s + t)
            parts = [_innermost(harness, mid)
                     or "harness loop (outside the ranges)"]
            span = _innermost(window_spans, mid)
            if span is not None:
                parts.append(_label(span))
            else:
                done = [x for x in window_spans if x[1] <= mid]
                if done:
                    last = max(done, key=lambda x: x[1])[2]
                    parts.append(f"outside the program's spans, after "
                                 f"{_label(last)}")
            call = _innermost(runtime, mid)
            if call is not None:
                parts.append(call)
        labelled.append([" > ".join(parts), (t - s) / 1e6])

    return ProgSpans(
        steps=steps,
        host_blocked_ms=blocked_in(by_name["scheduler.step"]) / steps / 1e3,
        sched_self_ms=(_self_us(by_name["scheduler.step"], nested) / steps / 1e3
                       if by_name["scheduler.step"] else None),
        dispatch_self_ms=(_self_us(by_name["scheduler.dispatch"],
                                   by_name["block.apply"]) / steps / 1e3
                          if by_name["block.apply"] else None),
        program_setup_s=sum(t - s for s, t in _merge(setup)) / 1e6,
        blocks=blocks,
        outside_share=(step_us - covered) / step_us if step_us > 0 else None,
        idle_gaps=labelled)
