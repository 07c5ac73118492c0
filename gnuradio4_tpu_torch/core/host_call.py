"""A host function inside a step: the counterpart of the JAX package's
``jax.pure_callback``.

The compiled step runs eagerly, so the call is direct: the input's values come
to the host, the NumPy function runs, and its result goes back to the input's
device. The copy to the host waits for the kernels that made the input, and
the step goes on only when the result is back: one stream synchronisation per
call. A step that holds a host call therefore cannot be captured into one
CUDA graph.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .errors import GrError


def numpy_dtype(dtype: Any) -> np.dtype:
    """A NumPy dtype from a NumPy dtype-like or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def host_call(fn: Callable[[np.ndarray], Any], x: torch.Tensor,
              shape: tuple[int, ...] | None = None,
              dtype: Any = None) -> torch.Tensor:
    """``fn`` (NumPy in, NumPy out) on the values of ``x``, its result on
    ``x``'s device.

    ``shape`` and ``dtype`` declare the result, as ``pure_callback``'s
    ``ShapeDtypeStruct`` does; a result of another shape or dtype raises
    :class:`GrError`. ``dtype`` takes a NumPy dtype-like or a ``torch.dtype``.
    Undeclared, the result keeps the callback's shape and is cast to
    float32."""
    y = np.asarray(fn(x.detach().cpu().numpy()))
    if shape is not None and tuple(y.shape) != tuple(shape):
        raise GrError(f"host function returned shape {tuple(y.shape)}, "
                      f"declared {tuple(shape)}")
    if dtype is None:
        y = y.astype(np.float32, copy=False)
    elif y.dtype != numpy_dtype(dtype):
        raise GrError(f"host function returned dtype {y.dtype}, declared "
                      f"{numpy_dtype(dtype)}")
    return torch.from_numpy(np.ascontiguousarray(y)).to(x.device)
