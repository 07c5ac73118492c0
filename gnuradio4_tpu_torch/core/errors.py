"""Structured errors and logging.

Analog of the reference's ``gr::Error`` / ``gr::exception`` record with
source-location and timestamp (reference: core/include/gnuradio-4.0/Logger.hpp:26-59).
We lean on Python's ``logging`` for transport but keep a structured ``Error`` record so
scheduler/message paths can carry errors as data (the reference uses ``std::expected``).
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time
from typing import Any

log = logging.getLogger("gnuradio4_tpu_torch")


class GrError(Exception):
    """Framework exception with captured source location + timestamp."""

    def __init__(self, message: str, *, block: str | None = None):
        super().__init__(message)
        frame = inspect.stack()[1]
        self.source = f"{frame.filename}:{frame.lineno}"
        self.timestamp = time.time()
        self.block = block

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        loc = f" [{self.block}]" if self.block else ""
        return f"{super().__str__()}{loc} ({self.source})"


@dataclasses.dataclass(frozen=True)
class Error:
    """Error-as-data record used on message/error paths (≈ gr::Error, Logger.hpp:59)."""

    message: str
    source: str = ""
    timestamp: float = dataclasses.field(default_factory=time.time)
    context: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def here(cls, message: str, **context: Any) -> "Error":
        frame = inspect.stack()[1]
        return cls(message=message, source=f"{frame.filename}:{frame.lineno}", context=context)


class ConnectionError_(GrError):
    """Port/edge connection failure."""


class SettingsError(GrError):
    """Invalid setting key/value or failed validation."""


class RateError(GrError):
    """Inconsistent resampling-rate algebra in a graph."""


class LifecycleError(GrError):
    """Invalid lifecycle state transition."""
