"""Native (C++) host components of the port.

``ringbuf.cpp`` — the double-mmapped lock-free ring (the host data plane);
``convert.cpp`` — the wire-format converters. ``g++`` builds each at first use
into ``gnuradio4_tpu_torch/_build/`` (``build.py``); :mod:`.ring` and
:mod:`.convert` wrap them with ctypes, each with a pure-Python fallback.
"""

from .ring import HostRing, build_native, native_available
