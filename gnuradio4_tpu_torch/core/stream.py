"""Time-block stream model and sample dtypes.

A stream is a sequence of fixed-shape **time blocks** — tensors of shape
``[channels, block_len]`` (or ``[block_len]`` for single-channel) — that flow
through the compiled graph once per scheduler step. Rate changes are resolved
at compile time by the graph's rate algebra (core/graph.py).

Dtypes are named by their NumPy names, as in the JAX package, so settings and
graph files stay identical; :func:`torch_dtype` maps a resolved NumPy dtype onto
the torch dtype a tensor of that stream carries. ``uint32`` streams and states
(NCO phases) are carried as ``int64`` holding values in ``[0, 2³²)``: torch on
the CPU has no wrapping uint32 arithmetic.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "complex64": np.complex64,
    "int32": np.int32,
    "int16": np.int16,
    "int8": np.int8,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "bool": np.bool_,
}

_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def canonical_dtype(dtype: Any) -> np.dtype:
    """Stream dtype by name or dtype-like → NumPy dtype (the graph's type)."""
    if isinstance(dtype, str):
        try:
            return np.dtype(DTYPES[dtype])
        except KeyError as e:
            raise ValueError(f"unknown stream dtype {dtype!r}; known: {sorted(DTYPES)}") from e
    return np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype that carries a stream of (canonical) ``dtype``."""
    return _TORCH[canonical_dtype(dtype)]

