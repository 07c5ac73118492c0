"""Demodulation (≈ reference blocks/filter FrequencyEstimator.hpp IQDemodulator)."""

from __future__ import annotations

import numpy as np
import torch


def quadrature_demod(x: torch.Tensor, last: torch.Tensor, *,
                     gain: float | torch.Tensor, rot: complex | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FM discriminator: y[n] = gain · arg(x[n]·conj(x[n−1])·rot).

    x: [..., T] complex64; last: [...] carried x[−1]; ``gain`` a float or a
    per-sample float32 tensor [T] (a tag-accurate gain ramp). ``rot`` (host
    complex, unit modulus) folds a constant phase into the arg — the
    rotation-absorption correction, applied INSIDE arg so the (−π, π] wrap
    matches the de-rotated stream exactly. Returns ``(y float32, x[..., -1])``.
    """
    prev = torch.cat([last[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    d = x * prev.conj()
    if rot is not None:
        d = d * complex(rot)    # rounded to complex64 like the JAX package's
    y = torch.atan2(d.imag, d.real)
    if torch.is_tensor(gain) or gain != 1.0:
        y = y * gain
    return y, x[..., -1].clone()


def am_demod(x: torch.Tensor, *, gain: float = 1.0) -> torch.Tensor:
    """Envelope detector |x|·gain."""
    return (x.abs() * gain).to(torch.float32)


def fm_deemphasis_coeffs(sample_rate: float, tau: float = 75e-6
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Single-pole de-emphasis (75 µs US / 50 µs EU) via bilinear transform."""
    w_c = 1.0 / tau
    w_ca = 2.0 * sample_rate * np.tan(w_c / (2.0 * sample_rate))
    k = -w_ca / (2.0 * sample_rate)
    z1 = -1.0
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    b = np.array([b0, -z1 * b0])
    a = np.array([1.0, -p1])
    return b, a
