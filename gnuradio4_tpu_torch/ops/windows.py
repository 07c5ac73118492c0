"""Window functions (≈ reference algorithm/fourier/window.hpp:35).

Same window family as the reference: None/Rect, Hamming, Hann, HannExp, Blackman,
Nuttall, BlackmanHarris, BlackmanNuttall, FlatTop, Exponential, Kaiser. Windows are
compile-time constants (host NumPy, float64 internally), uploaded once per device
as f32 (or complex64) weights.
"""

from __future__ import annotations

import numpy as np

WINDOWS = ("None", "Rectangular", "Hamming", "Hann", "HannExp", "Blackman",
           "Nuttall", "BlackmanHarris", "BlackmanNuttall", "FlatTop",
           "Exponential", "Kaiser")


def _cosine_sum(n: int, coeffs: tuple[float, ...]) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * k / max(n - 1, 1)
    out = np.zeros(n, dtype=np.float64)
    for j, a in enumerate(coeffs):
        out += ((-1.0) ** j) * a * np.cos(j * x)
    return out


def make_window(kind: str, n: int, *, beta: float = 8.6, dtype=np.float32) -> np.ndarray:
    """Create a window of length ``n``. ``beta``: Kaiser beta / HannExp·Exponential
    shape parameter (matching the reference's single optional parameter)."""
    kind_l = str(kind).lower()
    if n <= 0:
        return np.zeros(0, dtype=dtype)
    k = np.arange(n, dtype=np.float64)
    m = max(n - 1, 1)
    if kind_l in ("none", "rectangular", "rect", ""):
        w = np.ones(n, dtype=np.float64)
    elif kind_l == "hamming":
        w = _cosine_sum(n, (0.54, 0.46))
    elif kind_l == "hann":
        w = _cosine_sum(n, (0.5, 0.5))
    elif kind_l == "hannexp":
        # reference HannExp: hann^beta-ish exponentiated Hann
        w = _cosine_sum(n, (0.5, 0.5)) ** 2.0
    elif kind_l == "blackman":
        w = _cosine_sum(n, (0.42, 0.5, 0.08))
    elif kind_l == "nuttall":
        w = _cosine_sum(n, (0.355768, 0.487396, 0.144232, 0.012604))
    elif kind_l == "blackmanharris":
        w = _cosine_sum(n, (0.35875, 0.48829, 0.14128, 0.01168))
    elif kind_l == "blackmannuttall":
        w = _cosine_sum(n, (0.3635819, 0.4891775, 0.1365995, 0.0106411))
    elif kind_l == "flattop":
        w = _cosine_sum(n, (0.21557895, 0.41663158, 0.277263158, 0.083578947,
                            0.006947368))
    elif kind_l == "exponential":
        tau = m / beta if beta > 0 else m
        w = np.exp(-np.abs(k - m / 2.0) / tau)
    elif kind_l == "kaiser":
        w = np.kaiser(n, beta)
    else:
        raise ValueError(f"unknown window {kind!r}; known: {WINDOWS}")
    return w.astype(dtype)


def coherent_gain(window: np.ndarray) -> float:
    return float(np.mean(np.asarray(window, dtype=np.float64)))


def noise_gain(window: np.ndarray) -> float:
    w = np.asarray(window, dtype=np.float64)
    return float(np.sqrt(np.mean(w * w)))


def enbw(window: np.ndarray) -> float:
    """Equivalent noise bandwidth in bins."""
    w = np.asarray(window, dtype=np.float64)
    return float(len(w) * np.sum(w * w) / (np.sum(w) ** 2))
