"""Demodulation (≈ reference blocks/filter FrequencyEstimator.hpp IQDemodulator)."""

from __future__ import annotations

import torch


def quadrature_demod(x: torch.Tensor, last: torch.Tensor, *, gain: float,
                     rot: complex | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FM discriminator: y[n] = gain · arg(x[n]·conj(x[n−1])·rot).

    x: [..., T] complex64; last: [...] carried x[−1]. ``rot`` (host complex, unit
    modulus) folds a constant phase into the arg — the rotation-absorption
    correction, applied INSIDE arg so the (−π, π] wrap matches the de-rotated
    stream exactly. Returns ``(y float32, x[..., -1])``.
    """
    prev = torch.cat([last[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    d = x * prev.conj()
    if rot is not None:
        d = d * complex(rot)    # rounded to complex64 like the JAX package's
    y = torch.atan2(d.imag, d.real)
    if gain != 1.0:
        y = y * gain
    return y, x[..., -1].clone()
