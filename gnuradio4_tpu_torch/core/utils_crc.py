"""CRC32C (Castagnoli) — ≈ reference core CRC.hpp.

Table-driven software CRC32C (polynomial 0x1EDC6F41, reflected 0x82F63B78) for
pmt wire-format trailers and file integrity checks.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table[i] = c
    return table


_TABLE = _make_table()


def crc32c(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """Compute CRC32C of ``data`` (optionally continuing from a prior value)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    c = np.uint32(~crc & 0xFFFFFFFF)
    # vectorized-ish byte loop (numpy table lookup per byte)
    t = _TABLE
    cv = int(c)
    for b in arr.tolist():
        cv = (cv >> 8) ^ int(t[(cv ^ b) & 0xFF])
    return (~cv) & 0xFFFFFFFF
