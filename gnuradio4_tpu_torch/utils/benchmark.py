"""Micro-benchmark harness with Linux hardware perf counters.

≈ reference bench/benchmark.hpp: ops/s timing around a callable, optional
`perf_event` hardware counters (cycles, instructions, cache/branch misses —
benchmark.hpp:23-28), and `MarkerMap` latency markers. Host-side only: it
measures the Python/runtime data plane (rings, feeders, converters, schedulers);
device-side timing is the Profiler's job (`core/profiler.py` + torch.profiler).

Counters degrade gracefully: when `perf_event_open` is unavailable (container
seccomp, perf_event_paranoid, non-Linux) results simply omit them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import platform
import struct
import time
from typing import Callable

# perf_event_open syscall numbers per arch
_SYS_PERF_EVENT_OPEN = {"x86_64": 298, "aarch64": 241, "riscv64": 241}.get(
    platform.machine())

# PERF_TYPE_HARDWARE event configs (linux/perf_event.h)
_HW_EVENTS = {
    "cycles": 0,
    "instructions": 1,
    "cache_references": 2,
    "cache_misses": 3,
    "branches": 4,
    "branch_misses": 5,
}

_IOC_ENABLE = 0x2400
_IOC_DISABLE = 0x2401
_IOC_RESET = 0x2403


def _open_counter(config: int) -> int:
    """perf_event_open(attr, pid=0, cpu=-1, group=-1, flags=0) → fd or -1."""
    if _SYS_PERF_EVENT_OPEN is None or not hasattr(os, "read"):
        return -1
    attr = bytearray(128)
    # type u32 (0 = PERF_TYPE_HARDWARE), size u32, config u64
    struct.pack_into("<IIQ", attr, 0, 0, 128, config)
    # flags bitfield at offset 40: disabled(0) | exclude_kernel(5) | exclude_hv(6)
    struct.pack_into("<Q", attr, 40, (1 << 0) | (1 << 5) | (1 << 6))
    libc = ctypes.CDLL(None, use_errno=True)
    buf = (ctypes.c_char * 128).from_buffer(attr)
    fd = libc.syscall(_SYS_PERF_EVENT_OPEN, buf, 0, -1, -1, 0)
    return fd if fd >= 0 else -1


class PerfCounters:
    """A set of hardware counters around a measured region (RAII-ish)."""

    def __init__(self, names: tuple[str, ...] = ("cycles", "instructions",
                                                 "cache_misses",
                                                 "branch_misses")):
        self._fds: dict[str, int] = {}
        libc = ctypes.CDLL(None, use_errno=True)
        self._ioctl = libc.ioctl
        for name in names:
            fd = _open_counter(_HW_EVENTS[name])
            if fd >= 0:
                self._fds[name] = fd

    @property
    def available(self) -> bool:
        return bool(self._fds)

    def start(self) -> None:
        for fd in self._fds.values():
            self._ioctl(fd, _IOC_RESET, 0)
            self._ioctl(fd, _IOC_ENABLE, 0)

    def stop(self) -> dict[str, int]:
        out = {}
        for name, fd in self._fds.items():
            self._ioctl(fd, _IOC_DISABLE, 0)
            out[name] = struct.unpack("<Q", os.read(fd, 8))[0]
        return out

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@dataclasses.dataclass
class BenchResult:
    name: str
    n_ops: int
    wall_s: float
    cpu_s: float
    counters: dict[str, int]

    @property
    def ops_per_s(self) -> float:
        return self.n_ops / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def cycles_per_op(self) -> float | None:
        c = self.counters.get("cycles")
        return c / self.n_ops if c else None

    @property
    def ipc(self) -> float | None:
        c, i = self.counters.get("cycles"), self.counters.get("instructions")
        return i / c if c and i else None

    def __str__(self) -> str:
        parts = [f"{self.name}: {self.ops_per_s:,.0f} ops/s "
                 f"({self.wall_s * 1e9 / self.n_ops:,.1f} ns/op)"]
        if self.cycles_per_op is not None:
            parts.append(f"{self.cycles_per_op:,.0f} cyc/op")
        if self.ipc is not None:
            parts.append(f"IPC {self.ipc:.2f}")
        if "cache_misses" in self.counters:
            parts.append(f"{self.counters['cache_misses'] / self.n_ops:.2f} "
                         f"cache-miss/op")
        return "  ".join(parts)


def benchmark(fn: Callable[[], object], *, n: int | None = None,
              min_time: float = 0.2, warmup: int = 3, name: str = "",
              counters: bool = True) -> BenchResult:
    """Time ``fn`` (one call = one op). Auto-calibrates ``n`` to ``min_time``
    unless given. Hardware counters wrap ONLY the measured loop."""
    name = name or getattr(fn, "__name__", "bench")
    for _ in range(warmup):
        fn()
    if n is None:
        n, t = 1, 0.0
        while True:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = time.perf_counter() - t0
            if t >= min_time / 8 or n >= 1 << 24:
                break
            n *= 4
        n = max(1, int(n * min_time / max(t, 1e-9)))
    pc = PerfCounters() if counters else None
    if pc is not None:
        pc.start()
    c0 = time.process_time()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    ctrs = pc.stop() if pc is not None else {}
    if pc is not None:
        pc.close()
    return BenchResult(name=name, n_ops=n, wall_s=wall, cpu_s=cpu,
                       counters=ctrs)


class MarkerMap:
    """Named latency markers (≈ benchmark.hpp MarkerMap): ``mark(name)``
    stamps monotonic ns; ``intervals()`` gives consecutive deltas."""

    def __init__(self):
        self._events: list[tuple[str, int]] = []

    def mark(self, name: str) -> None:
        self._events.append((name, time.perf_counter_ns()))

    def intervals(self) -> list[tuple[str, float]]:
        """[('a→b', seconds), …] between consecutive marks."""
        out = []
        for (n0, t0), (n1, t1) in zip(self._events, self._events[1:]):
            out.append((f"{n0}→{n1}", (t1 - t0) / 1e9))
        return out

    def total_s(self) -> float:
        if len(self._events) < 2:
            return 0.0
        return (self._events[-1][1] - self._events[0][1]) / 1e9

    def clear(self) -> None:
        self._events.clear()
