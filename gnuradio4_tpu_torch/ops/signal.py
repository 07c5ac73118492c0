"""Waveform generation and the integer NCO (≈ reference SignalGeneratorCore.hpp).

Phase tracking uses the classic **integer NCO**: a 32-bit phase accumulator with
increment ``round(f/fs · 2³²)`` computed on the host in float64, so phase never
drifts regardless of stream length. torch on the CPU has no wrapping uint32
arithmetic, so phases are carried as int64 holding ``[0, 2³²)`` and every sum is
masked with ``& 0xFFFFFFFF`` — the same values the JAX package's uint32 wrap
produces. Start phases and increments are host ints; the per-sample phase grid
is built on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

WAVEFORMS = ("Const", "Sin", "Cos", "Square", "Saw", "Triangle",
             # FastSin/FastCos are the reference's reduced-precision recursive
             # phasors (SignalGenerator.hpp:34) — the integer NCO is already
             # drift-free AND exact here, so they alias Sin/Cos
             "FastSin", "FastCos")
NOISE_WAVEFORMS = ("UniformNoise", "TriangularNoise", "GaussianNoise")

MASK32 = 0xFFFFFFFF
_TWO_PI = 2.0 * np.pi
_PHASE_SCALE = 1.0 / 4294967296.0   # 2^-32, exact in float32
_RAMP_TILE = 1024                    # factored-ramp tile B (fixed: see complex_exp_ramp)


def phase_increment(frequency: float, sample_rate: float) -> np.uint32:
    """Host-side (float64) NCO increment: frac(f/fs) · 2³² as uint32."""
    frac = np.float64(frequency) / np.float64(sample_rate)
    frac = frac - np.floor(frac)
    return np.uint32(np.round(frac * 4294967296.0) % 4294967296.0)


def nco_phases(phase0: int, dphi: int, n: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Phase ramp ``(phase0 + k·dphi) mod 2³²`` for k in [0, n), as int64 [n]."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx * (int(dphi) & MASK32) + (int(phase0) & MASK32)) & MASK32


def phase_to_frac(phase_u32: torch.Tensor) -> torch.Tensor:
    """Phase in [0, 2³²) → fractional cycles in [0, 1) as f32 (keeps top 24 bits)."""
    return phase_u32.to(torch.float32) * _PHASE_SCALE


def waveform(kind: str, frac_phase: torch.Tensor, *, amplitude: float,
             offset: float) -> torch.Tensor:
    """Evaluate a waveform from fractional phase in [0,1)."""
    k = kind.lower()
    if k == "const":
        return torch.full_like(frac_phase, 1.0) * amplitude + offset
    if k in ("sin", "fastsin"):
        return amplitude * torch.sin(frac_phase * _TWO_PI) + offset
    if k in ("cos", "fastcos"):
        return amplitude * torch.cos(frac_phase * _TWO_PI) + offset
    if k == "square":
        return amplitude * torch.where(frac_phase < 0.5, 1.0, -1.0) + offset
    if k == "saw":
        return amplitude * (2.0 * frac_phase - 1.0) + offset
    if k == "triangle":
        return amplitude * (4.0 * torch.abs(frac_phase - 0.5) - 1.0) + offset
    raise ValueError(f"unknown waveform {kind!r}; known: {WAVEFORMS}")


def complex_exp(frac_phase: torch.Tensor, *, amplitude: float = 1.0) -> torch.Tensor:
    """amplitude · e^{j2πφ} — the complex NCO used by rotators/mixers (complex64)."""
    ang = frac_phase * _TWO_PI
    c, s = torch.cos(ang), torch.sin(ang)
    if amplitude != 1.0:
        c, s = c * amplitude, s * amplitude
    return torch.complex(c, s)


def complex_exp_ramp(phase0: int, dphi: int, n: int, *, amplitude: float = 1.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """amplitude · e^{j2π·(phase0 + k·dphi)/2³²} for k in [0, n), factored so
    transcendentals cost O(√n) instead of O(n).

    Phase splits exactly: phase(k·B+i) = (phase0 + kB·dphi) + (i·dphi) mod 2³²,
    and e^{j(a+b)} = e^{ja}·e^{jb}, so the [K,B] ramp is a complex OUTER PRODUCT
    of a K-vector (coarse rotators, amplitude folded in) and a B-vector (fine
    ramp). The tile B is a FIXED constant, so the (coarse, fine) split of any
    sample depends only on its offset from the segment start modulo B: different
    block lengths that are multiples of B give bit-identical streams. Other
    lengths take the direct per-sample form, exactly as the JAX package does."""
    B = _RAMP_TILE
    if n % B:
        return complex_exp(phase_to_frac(nco_phases(phase0, dphi, n, device)),
                           amplitude=amplitude)
    coarse = nco_phases(phase0, (int(dphi) * B) & MASK32, n // B, device)
    fine = nco_phases(0, dphi, B, device)
    rot = complex_exp(phase_to_frac(coarse), amplitude=amplitude)
    base = complex_exp(phase_to_frac(fine))
    return (rot[:, None] * base[None, :]).reshape(n)


def nco_rotate(x: torch.Tensor, phase0: int, dphi: int, n: int | None = None
               ) -> torch.Tensor:
    """``x · complex_exp_ramp(phase0, dphi, n)`` over the last axis (``n``
    defaults to its length), with the ramp kept factored through the multiply
    (same uint32 phase grid as complex_exp_ramp; lengths that are not a
    multiple of B, and an ``x`` that broadcasts against the ramp, take the
    direct form)."""
    m = x.shape[-1] if n is None else int(n)
    B = _RAMP_TILE
    if m % B or x.shape[-1] != m:
        ramp = complex_exp(phase_to_frac(nco_phases(phase0, dphi, m, x.device)))
        return x * ramp
    coarse = complex_exp(phase_to_frac(
        nco_phases(phase0, (int(dphi) * B) & MASK32, m // B, x.device)))
    fine = complex_exp(phase_to_frac(nco_phases(0, dphi, B, x.device)))
    lead = x.shape[:-1]
    y = (x.reshape(*lead, m // B, B) * coarse[:, None]) * fine
    return y.reshape(*lead, m)
