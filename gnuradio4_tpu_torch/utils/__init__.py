"""Host-side utilities of the port (≈ reference meta/: UncertainValue,
HistoryBuffer)."""

from .history import HistoryBuffer
from .uncertain import UncertainValue
