"""Gain-control loops of the JAX package's ``ops/farrow.py``.

Only :func:`agc_apply` is ported; the Farrow resampler and the Goertzel
detector of that module are not ported yet.
"""

from __future__ import annotations

import torch


def agc_apply(x: torch.Tensor, gain0: torch.Tensor, *, reference: float,
              rate: float, max_gain: float = 65536.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Automatic gain control (≈ GNU Radio agc_cc): per-sample gain loop
    g[n+1] = clip(g[n] + rate·(ref − |x[n]|·g[n]), 1e-6, max_gain), channels
    in parallel. The clip makes the recurrence non-associative, so it runs as
    a loop over samples (a handful of small launches per sample on the card).
    ``x``: [T] or [C, T]; ``gain0``: [] or [C] float32. Returns (y, final
    gain)."""
    mag = torch.abs(x).to(torch.float32)
    g = gain0.to(torch.float32)
    gains = []
    for n in range(mag.shape[-1]):
        gains.append(g)
        g = torch.clamp(g + rate * (reference - mag[..., n] * g),
                        1e-6, max_gain)
    if not gains:
        return x.clone(), g
    gain = torch.stack(gains, dim=-1)
    y = x * gain.to(x.real.dtype if x.is_complex() else x.dtype)
    return y.to(x.dtype), g
