"""Spectrum post-processing over ``torch.fft`` (≈ reference blocks/fourier/fft.hpp:33).

The transform itself is ``torch.fft.fft`` (cuFFT on the card); this module holds
the views the FFT block emits (magnitude, dB, shift, the calibration scale) and
the four-step matmul FFT (:func:`matmul_fft`) behind the FFT/IFFT blocks'
``matmul``, ``matmul_exact`` and ``matmul_bf16`` engines (the precision rungs
``high``, ``highest`` and ``bf16`` of ``ops/precision.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.errors import GrError
from .cuda_kernels import device_constant, frozen
from .precision import rung_dot
from .windows import enbw, make_window  # noqa: F401  (the JAX package's re-export)

# the matmul FFT's precision rungs by engine name
MATMUL_ENGINES = {"matmul": "high", "matmul_exact": "highest",
                  "matmul_bf16": "bf16"}


def chunked_fft(x: torch.Tensor, fft_size: int, *,
                window: torch.Tensor | np.ndarray | None = None) -> torch.Tensor:
    """Reshape the trailing time axis into ``[-1, fft_size]`` chunks, window,
    FFT: x [..., T] with T % fft_size == 0 → complex spectra
    [..., T // fft_size, fft_size]."""
    lead = x.shape[:-1]
    xr = x.reshape(*lead, -1, fft_size)
    if window is not None:
        real_dt = xr.real.dtype if xr.is_complex() else xr.dtype
        w = torch.as_tensor(window).to(device=xr.device, dtype=real_dt)
        xr = xr * w
    return torch.fft.fft(xr, dim=-1)


def magnitude(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.abs(spectrum)


def magnitude_db(spectrum: torch.Tensor, *, floor: float = 1e-20) -> torch.Tensor:
    p = spectrum.real ** 2 + spectrum.imag ** 2
    return 10.0 * torch.log10(torch.clamp(p, min=floor))


def phase(spectrum: torch.Tensor, *, unwrap: bool = False) -> torch.Tensor:
    """The spectrum's phase in radians, unwrapped along the last axis on
    request."""
    ph = torch.angle(spectrum)
    if unwrap:
        d = torch.diff(ph, dim=-1)
        d = torch.remainder(d + np.pi, 2 * np.pi) - np.pi
        ph = torch.cat([ph[..., :1], ph[..., :1] + torch.cumsum(d, dim=-1)],
                       dim=-1)
    return ph


def fftshift(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(x, dim=-1)


def freq_axis(fft_size: int, sample_rate: float, *, shifted: bool = False,
              one_sided: bool = False) -> np.ndarray:
    """The bins' frequencies in Hz (NumPy, host side)."""
    f = np.fft.fftfreq(fft_size, d=1.0 / sample_rate)
    if one_sided:
        return f[: fft_size // 2 + 1].copy()
    if shifted:
        return np.fft.fftshift(f)
    return f


def spectrum_scale(fft_size: int, window: np.ndarray | None, *, power: bool,
                   density: bool, sample_rate: float) -> float:
    """Scale factor for calibrated amplitude/power spectra (coherent/noise gain)."""
    if window is None:
        cg = 1.0
        nbw = 1.0
    else:
        w = np.asarray(window, dtype=np.float64)
        cg = float(np.mean(w))
        nbw = enbw(w)
    if power and density:
        return 1.0 / (fft_size * cg * np.sqrt(nbw * sample_rate))
    return 1.0 / (fft_size * cg)


# ---------------------------------------------------------------------------
# Matmul FFT — a four-step Cooley-Tukey alternative to cuFFT.
#
# N = N1·N2 splits the transform into two dense [N1,N1]/[N2,N2] matmul stages
# plus an elementwise twiddle:
#
#   X[k1 + N1·k2] = Σ_{n2} W_N^{n2·k1} W_{N2}^{n2·k2} (Σ_{n1} x[n1,n2] W_{N1}^{n1·k1})
#
# (x reshaped [n1, n2] row-major).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _fft_mats(fft_size: int, n1: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(F1[n1,k1], TW[k1,n2], F2[n2,k2]) as float64 complex host constants."""
    n2 = fft_size // n1
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    f1 = np.exp(-2j * np.pi * np.outer(i1, i1) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(i2, i2) / n2)
    tw = np.exp(-2j * np.pi * np.outer(i1, i2) / fft_size)
    return f1, tw, f2


@lru_cache(maxsize=32)
def _fft_rails(fft_size: int, n1: int) -> tuple[np.ndarray, ...]:
    """The float32 rails (re, im) of F1ᵀ, TW and F2, read-only host arrays."""
    f1, tw, f2 = _fft_mats(fft_size, n1)
    return frozen(*(np.ascontiguousarray(a, np.float32) for a in
                    (f1.T.real, f1.T.imag, tw.real, tw.imag, f2.real, f2.imag)))


def matmul_fft(x: torch.Tensor, fft_size: int, *, n1: int | None = None,
               mode: str = "highest") -> torch.Tensor:
    """FFT over the trailing axis as two matmul stages: the JAX package's
    rail-decomposed four-step FFT.

    x: [..., fft_size] (real or complex) → complex64 [..., fft_size]. ``n1``
    picks the split (default ≈ √N, a power of two); ``mode`` is the precision
    rung of both stages (:func:`~.precision.rung_dot`): 'highest' (full
    float32 products, checked by ``check_f32_matmul``), 'high' (bf16×3 on the
    card, exact float32 on the CPU) or 'bf16' (one bf16 pass; bf16-rounded
    operands with float32 sums on the CPU)."""
    if mode not in ("highest", "high", "bf16"):
        raise GrError(f"matmul_fft: unknown precision rung {mode!r}; known: "
                      f"'highest', 'high', 'bf16'")
    if n1 is None:
        n1 = 1 << ((fft_size.bit_length() - 1) // 2)   # ~sqrt, power of two
    n2 = fft_size // n1
    if n1 * n2 != fft_size:
        raise GrError(f"matmul_fft: n1={n1} does not divide {fft_size}")
    lead = x.shape[:-1]
    a = x.reshape(*lead, n1, n2)
    f1r, f1i, twr, twi, f2r, f2i = (device_constant(a, x.device)
                                    for a in _fft_rails(fft_size, n1))

    def cx_dot(ar, ai, wr, wi):
        dot = lambda v, w: rung_dot(v, w, mode)
        if ai is None:
            return dot(ar, wr), dot(ar, wi)
        return dot(ar, wr) - dot(ai, wi), dot(ar, wi) + dot(ai, wr)

    # stage 1 contracts n1 (einsum '...ns,nk->...ks'): rows over n2
    ar = (a.real if a.is_complex() else a).to(torch.float32).transpose(-1, -2)
    ai = a.imag.to(torch.float32).transpose(-1, -2) if a.is_complex() \
        else None
    yr, yi = cx_dot(ar, ai, f1r.T, f1i.T)            # [..., n2, k1]
    # twiddle (elementwise, float32 constants)
    yr, yi = yr.transpose(-1, -2), yi.transpose(-1, -2)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    # stage 2 contracts n2 → Z[..., k1, k2]
    zr, zi = cx_dot(zr, zi, f2r, f2i)
    # output index k = k1 + N1·k2 → lay out k2-major then flatten
    return torch.complex(zr.transpose(-1, -2).reshape(*lead, fft_size),
                         zi.transpose(-1, -2).reshape(*lead, fft_size))
