"""Host-side utilities of the port (≈ reference meta/: UncertainValue,
HistoryBuffer, MemoryMonitor)."""

from .history import HistoryBuffer
from .memory import MemoryMonitor
from .uncertain import UncertainValue
