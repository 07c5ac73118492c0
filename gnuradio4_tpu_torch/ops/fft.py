"""Spectrum post-processing over ``torch.fft`` (≈ reference blocks/fourier/fft.hpp:33).

The transform itself is ``torch.fft.fft`` (cuFFT on the card); this module holds
the views the FFT block emits: magnitude, dB, shift, and the calibration scale.
"""

from __future__ import annotations

import numpy as np
import torch

from .windows import enbw


def magnitude(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.abs(spectrum)


def magnitude_db(spectrum: torch.Tensor, *, floor: float = 1e-20) -> torch.Tensor:
    p = spectrum.real ** 2 + spectrum.imag ** 2
    return 10.0 * torch.log10(torch.clamp(p, min=floor))


def fftshift(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(x, dim=-1)


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
