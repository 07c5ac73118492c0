"""MemoryMonitor (≈ reference core thread/MemoryMonitor.hpp): samples host RSS /
device memory usage for observability."""

from __future__ import annotations

import threading
import time

import torch


def rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGESIZE")
    except Exception:
        return 0


def device_memory_stats(device: torch.device | str | None = None) -> dict:
    """The CUDA caching allocator's counters for ``device`` (default: the
    current card): ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_reserved`` (the names the JAX package's device stats use), then
    every key of ``torch.cuda.memory_stats``. ``{}`` for a CPU device,
    where no card is present, or before CUDA is initialised."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}      # nothing allocated yet (no CUDA context)
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            **stats}


class MemoryMonitor:
    """Background sampler of host RSS (and device stats when available)."""

    def __init__(self, interval_s: float = 1.0, maxlen: int = 600,
                 device: torch.device | str | None = None):
        self.interval = interval_s
        self.samples: list[tuple[float, int]] = []
        self.device_samples: list[tuple[float, dict]] = []
        self.maxlen = maxlen
        self.device = device
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "MemoryMonitor":
        if self._thread is None:
            from . import thread_pool
            self._thread = thread_pool.spawn(self._run, name="memory-monitor")
        return self

    def _run(self):
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(self.interval)

    def sample(self) -> None:
        """Take one sample now (the background thread calls this)."""
        now = time.monotonic()
        self.samples.append((now, rss_bytes()))
        del self.samples[:-self.maxlen]
        stats = device_memory_stats(self.device)
        if stats:
            self.device_samples.append((now, stats))
            del self.device_samples[:-self.maxlen]

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.interval))

    @property
    def peak_rss(self) -> int:
        return max((s for _, s in self.samples), default=rss_bytes())

    @property
    def peak_device_bytes(self) -> int:
        """The allocator's peak bytes in use over the samples (0 without a
        card)."""
        return max((d["peak_bytes_in_use"] for _, d in self.device_samples),
                   default=0)
