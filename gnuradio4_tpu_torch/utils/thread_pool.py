"""Named daemon threads (≈ reference thread/thread_pool.hpp Manager).

The scheduler's long-running host threads — its runner, its async delivery
worker and its watchdog — start through :func:`spawn`, named after the
scheduler, so they show up by name in thread dumps and debuggers.
"""

from __future__ import annotations

import threading
from typing import Callable


def spawn(target: Callable[[], None], *, name: str) -> threading.Thread:
    """Start a named daemon thread running ``target``."""
    t = threading.Thread(target=target, daemon=True, name=name)
    t.start()
    return t
