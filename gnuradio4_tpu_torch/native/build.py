"""``g++`` builds of the port's host libraries (``ringbuf.cpp``,
``convert.cpp``) at first use.

A library is built into ``gnuradio4_tpu_torch/_build/`` under a name keyed by a
hash of its sources and of the flag sets it may be built with, so an edited
source gets a new file and ``dlopen``'s cache by path never serves a stale one.
A flag set with ``-march=native`` also keys the name by the host's CPU, so a
``_build/`` carried to another machine builds anew there instead of loading
code for another instruction set.
Concurrent builders (threads, or test workers in other processes) each write a
file of their own and rename it into place.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
_lock = threading.Lock()


@lru_cache(maxsize=1)
def host_cpu() -> str:
    """What ``-march=native`` builds for: the machine, and the CPU's model
    and feature flags as ``/proc/cpuinfo`` states them."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") and \
                        not any(x.startswith(key) for x in lines):
                    lines.append(line.strip())
    except OSError:
        lines.append(platform.processor())
    return "\n".join([platform.machine(), *lines])


def library_path(stem: str, sources: tuple[str, ...],
                 flag_sets: tuple[tuple[str, ...], ...]) -> Path:
    """Where ``lib<stem>`` built from these sources and flags lives."""
    h = hashlib.sha256(repr(flag_sets).encode())
    if any("-march=native" in flags for flags in flag_sets):
        h.update(host_cpu().encode())
    for name in sources:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_library(stem: str, sources: tuple[str, ...],
                  flag_sets: tuple[tuple[str, ...], ...],
                  force: bool = False) -> Path | None:
    """Compile ``sources`` into a shared library with the first flag set
    that ``g++`` accepts; the library's path, or None when every flag set
    failed (no compiler, or the sources do not build here)."""
    so = library_path(stem, sources, flag_sets)
    with _lock:
        if so.exists() and not force:
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        for flags in flag_sets:
            try:
                subprocess.run(["g++", *flags, "-shared", "-fPIC", "-std=c++20",
                                *(str(HERE / s) for s in sources), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, so)
            return so
        tmp.unlink(missing_ok=True)
        return None
