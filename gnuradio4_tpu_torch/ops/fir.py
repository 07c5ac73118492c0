"""FIR filtering (overlap-save, decimating, frequency-translating).

Reference capability: per-sample FIR with a HistoryBuffer of tap history
(blocks/filter/include/gnuradio-4.0/filter/time_domain_filter.hpp:24 ``fir_filter``;
history: core HistoryBuffer.hpp:68).

Overlap-save over time blocks: the carried state is the last ``ntaps-1`` input
samples (the exact analog of the HistoryBuffer tail); each step filters
``[state, x]`` "valid", producing ``len(x) // decim`` outputs. The filtering
itself is :func:`~.cuda_kernels.fir_banded`: the hand-written CUDA kernel for a
CUDA tensor, its plain banded-matmul version for a CPU tensor.
:func:`fir_quad_demod_fused` is the FIR fused with the quadrature demod
(:func:`~.cuda_kernels.fir_demod`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import GrError
from ..core.stream import torch_dtype
from .cuda_kernels import fir_banded, fir_demod

# the precision rungs a block may name; only full float32 is ported so far
PRECISIONS = ("auto", "default", "high", "highest", "bf16", "int8")


def fir_init_state(channels: int, ntaps: int, dtype,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Zero prehistory of ``ntaps-1`` samples (≈ HistoryBuffer zero-init)."""
    shape = (ntaps - 1,) if channels == 0 else (channels, ntaps - 1)
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


def fir_apply(x: torch.Tensor, taps, state: torch.Tensor, *, decim: int = 1,
              method: str = "auto", precision: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap-save FIR step.

    ``x``: [T] or [C, T] (complex64 or float32); ``taps``: [K] real or complex
    (host array, uploaded once per device); ``state``: prehistory [*, K-1].
    Returns ``(y, new_state)`` with ``y`` of length T//decim (on the decimated grid aligned to the first input
    sample) and new_state = last K-1 inputs. A real stream with complex taps
    stays real (its history too); its output is complex.
    """
    if method != "auto":
        raise GrError(f"fir_apply: method={method!r} is not ported to this "
                      f"package yet; only 'auto' (the banded FIR) exists")
    if precision not in (None, "auto", "highest"):
        raise GrError(f"fir_apply: precision rung {precision!r} is not ported "
                      f"to this package yet; only full float32 "
                      f"('auto'/'highest') exists")
    k = len(taps)
    x = x.contiguous()
    state = state.to(x.dtype).contiguous()
    y = fir_banded(x, state, taps, decim)
    t = x.shape[-1]
    if k == 1:
        new_state = x[..., :0].clone()
    elif t >= k - 1:
        new_state = x[..., t - (k - 1):].clone()
    else:
        new_state = torch.cat([state, x], dim=-1)[..., -(k - 1):]
    return y, new_state


def freq_xlating_taps(taps: np.ndarray, center_freq: float, sample_rate: float
                      ) -> np.ndarray:
    """Heterodyne low-pass taps up to ``center_freq`` (frequency-xlating FIR design)."""
    n = np.arange(len(taps), dtype=np.float64)
    rot = np.exp(1j * 2.0 * np.pi * center_freq / sample_rate * n)
    return (np.asarray(taps, dtype=np.float64) * rot).astype(np.complex64)


def fir_quad_demod_fused(xc: torch.Tensor, taps_np: np.ndarray, decim: int,
                         prev: torch.Tensor, gain: float) -> torch.Tensor:
    """Decimating FIR fused with the quadrature demod: only the float32 demod
    output is written, the complex FIR output never reaches device memory.
    ``xc``: [1, T + K - 1] (or [C, T + K - 1]) history-prefixed complex64
    stream; ``prev``: the last FIR output of the previous chunk, v[-1]
    (complex scalar, or [C]). Returns [1, T // decim] float32. No carry is
    returned: the caller keeps the FIR history and v[-1] itself.

    A CUDA tensor launches the ``fir_demod`` kernel, which takes every shape;
    a CPU tensor takes its plain version (FIR then demod)."""
    xc = xc.to(torch.complex64).contiguous()
    prev = torch.as_tensor(prev, dtype=torch.complex64, device=xc.device)
    if prev.shape != xc.shape[:-1]:
        prev = prev.reshape(()).expand(xc.shape[:-1])
    return fir_demod(xc, taps_np, int(decim), prev.contiguous(), gain)
