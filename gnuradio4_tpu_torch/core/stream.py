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

``bfloat16``, a stream dtype of the JAX package, is refused with a
:class:`~.errors.GrError`: NumPy has no bfloat16, and the graph's types are
NumPy dtypes.

``StreamSpec`` is the type that rides on ports/edges — the analog of the
sample type + ``PortMetaInfo`` (SI units etc., reference Port.hpp:178).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
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
    if isinstance(dtype, str) and dtype == "bfloat16":
        from .errors import GrError
        raise GrError("bfloat16 streams are not carried by this package (NumPy "
                      "has no bfloat16); use float32")
    if isinstance(dtype, str):
        try:
            return np.dtype(DTYPES[dtype])
        except KeyError as e:
            raise ValueError(f"unknown stream dtype {dtype!r}; known: {sorted(DTYPES)}") from e
    return np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype that carries a stream of (canonical) ``dtype``."""
    return _TORCH[canonical_dtype(dtype)]



_DTYPE_NAMES = {np.dtype(v): k for k, v in DTYPES.items()}


def dtype_name(dtype: Any) -> str:
    """The stream dtype's name (``"complex64"``), as graph files spell it."""
    return _DTYPE_NAMES.get(np.dtype(dtype), str(np.dtype(dtype)))


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of a stream riding an edge/port.

    ``dtype`` is the NumPy dtype, as the graph's types are. ``sample_rate`` is
    metadata (Hz at this point of the graph; rate-changing blocks scale it).
    ``channels`` is the leading batch axis; ``channels == 0`` denotes a 1-D
    stream shaped ``[block_len]``.
    """

    dtype: Any = np.float32
    channels: int = 0
    sample_rate: float = 1.0
    # SI metadata (≈ PortMetaInfo, reference Port.hpp:178)
    signal_name: str = ""
    signal_unit: str = ""
    signal_quantity: str = ""
    signal_min: float = float("-inf")
    signal_max: float = float("inf")

    def __post_init__(self):
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))

    def shape(self, block_len: int) -> tuple[int, ...]:
        return block_shape(self.channels, block_len)

    def zeros(self, block_len: int, *, device: torch.device | str
              ) -> torch.Tensor:
        """A zero time block of this stream on ``device`` (which the caller
        names: the JAX package's form has no device)."""
        return torch.zeros(self.shape(block_len), dtype=torch_dtype(self.dtype),
                           device=device)

    def with_rate(self, ratio: Fraction) -> "StreamSpec":
        return dataclasses.replace(self, sample_rate=float(self.sample_rate * ratio))

    def compatible(self, other: "StreamSpec") -> bool:
        return np.dtype(self.dtype) == np.dtype(other.dtype) and \
            self.channels == other.channels


def block_shape(channels: int, block_len: int) -> tuple[int, ...]:
    return (block_len,) if channels == 0 else (channels, block_len)
