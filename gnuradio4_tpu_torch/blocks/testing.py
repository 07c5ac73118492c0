"""Deterministic sinks for tests and instrumentation (≈ reference blocks/testing/:
NullSink, CountingSink, VectorSink qa helpers)."""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.tags import Tag


@register_block("VectorSink")
class VectorSink(SinkBlock):
    """Captures everything on the host (list → np.concatenate)."""

    IN = (Port("in"),)

    def __init__(self, name: str | None = None, **settings):
        super().__init__(name=name, **settings)
        self._chunks: list[np.ndarray] = []
        self.tags: list[Tag] = []
        self._n = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        a = arrays["in"][..., :n_valid]
        if n_valid:
            self._chunks.append(a)
        for t in tags.get("in", []):
            if t.index <= n_valid:  # keep in-range tags incl. EOS at the boundary
                self.tags.append(t.shifted(abs_index))
        self._n += n_valid

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0)
        return np.concatenate(self._chunks, axis=-1)

    def clear(self):
        self._chunks.clear()
        self.tags.clear()
        self._n = 0


@register_block("NullSink")
class NullSink(SinkBlock):
    IN = (Port("in"),)
    WANTS_HOST_DATA = False  # count only — no device→host copy

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.count = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        self.count += n_valid


@register_block("CountingSink")
class CountingSink(NullSink):
    """Counts valid samples (≈ CountingSink)."""
