"""Demodulation (≈ reference blocks/filter FrequencyEstimator.hpp IQDemodulator)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .iir import _f32

_PI = _f32(np.pi)
_TWO_PI = _f32(2.0 * np.pi)


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


def pll_gains(loop_bw: float) -> tuple[float, float]:
    """(α, β) of the 2nd-order loop at damping 1/√2, computed in float64 and
    rounded to float32 as the JAX package casts them."""
    damp = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damp * loop_bw + loop_bw * loop_bw
    return _f32(4.0 * damp * loop_bw / denom), _f32(4.0 * loop_bw * loop_bw / denom)


def carrier_loop(x: torch.Tensor, phase: torch.Tensor, freq: torch.Tensor, *,
                 alpha: float, beta: float,
                 detector: Callable[[torch.Tensor], torch.Tensor],
                 max_freq: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2nd-order carrier loop shared by the PLLs and the Costas loop:
    y[n] = x[n]·e^{−jφ[n]}, e = detector(y[n]), f ← clip(f + β·e),
    φ ← mod(φ + f + α·e + π, 2π) − π (floor modulo, as ``jnp.mod``).

    The feedback is per sample, so this is a loop over samples: ten launches
    each on the card (nine and the detector's), none reading back to the host.
    The loop carries ν = −φ, so e^{−jφ} is one ``polar`` and the wrap's
    φ = r − π is ν = π − r, both exact. x: [T] or [C, T] complex64; phase,
    freq: [] or [C] float32. ``max_freq`` None leaves f unclamped. Returns
    (y, e, φ, f)."""
    fr = freq.to(torch.float32)
    nph = -phase.to(torch.float32)
    one = torch.ones_like(nph)
    pi = torch.full_like(nph, _PI)
    two_pi = torch.full_like(nph, _TWO_PI)
    ys, errs = [], []
    for xn in x.unbind(-1):
        yn = xn * torch.polar(one, nph)
        err = detector(yn)
        fr = torch.add(fr, err, alpha=beta)
        if max_freq is not None:
            fr = torch.clamp(fr, -max_freq, max_freq)
        nph = pi - torch.remainder(torch.add(fr - nph, err, alpha=alpha) + pi,
                                   two_pi)
        ys.append(yn)
        errs.append(err)
    if not ys:
        return x.clone(), x.real.clone(), -nph, fr
    return torch.stack(ys, dim=-1), torch.stack(errs, dim=-1), -nph, fr


def polar_discriminator_pll(x: torch.Tensor, phase: torch.Tensor,
                            freq: torch.Tensor, *, loop_bw: float, fs: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Carrier-tracking PLL: returns (phase error stream, phase, freq).

    2nd-order loop, damping 1/√2; used for coherent AM/PSK paths.
    """
    alpha, beta = pll_gains(loop_bw)
    _, errs, phase, freq = carrier_loop(
        x, phase, freq, alpha=alpha, beta=beta,
        detector=lambda y: torch.atan2(y.imag, y.real))
    return errs.to(torch.float32), phase, freq
