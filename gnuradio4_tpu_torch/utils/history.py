"""HistoryBuffer — host-side single-threaded ring with contiguous views
(≈ reference core HistoryBuffer.hpp:68: mirrored second half, newest-at-[0] or
oldest-at-[0] indexing). Device-side "history" is block state; this class serves
host tools (UI, pollers, estimators over recent samples).
"""

from __future__ import annotations

import numpy as np


class HistoryBuffer:
    def __init__(self, capacity: int, dtype=np.float32, *,
                 newest_first: bool = True):
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self.dtype = np.dtype(dtype)
        # mirrored storage: writes land at [pos] and [pos+cap] so any window of
        # ≤ cap samples is contiguous (HistoryBuffer.hpp mirror trick)
        self._buf = np.zeros(2 * cap, self.dtype)
        self._pos = 0
        self.size = 0
        self.newest_first = newest_first

    def push(self, samples) -> None:
        arr = np.asarray(samples, self.dtype).ravel()
        if len(arr) >= self.capacity:
            arr = arr[-self.capacity:]
        n = len(arr)
        p = self._pos
        end = p + n
        if end <= self.capacity:
            self._buf[p:end] = arr
            self._buf[p + self.capacity:end + self.capacity] = arr
        else:
            first = self.capacity - p
            self._buf[p:self.capacity] = arr[:first]
            self._buf[p + self.capacity:2 * self.capacity] = arr[:first]
            self._buf[0:n - first] = arr[first:]
            self._buf[self.capacity:self.capacity + n - first] = arr[first:]
        self._pos = end % self.capacity
        self.size = min(self.size + n, self.capacity)

    def view(self, n: int | None = None) -> np.ndarray:
        """Contiguous view of the most recent ``n`` samples (no copy)."""
        n = self.size if n is None else min(n, self.size)
        start = (self._pos - n) % self.capacity
        window = self._buf[start:start + n]
        return window[::-1] if self.newest_first else window

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i):
        return self.view()[i]
