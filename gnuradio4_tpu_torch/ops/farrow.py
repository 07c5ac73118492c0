"""Farrow (cubic polynomial) fractional-delay resampler, the Goertzel
single-bin detector and the AGC loop of the JAX package's ``ops/farrow.py``.

For output index m, the source position is p = m·ratio + φ0; sample index
i = ⌊p⌋, fractional μ = p − i. Output = cubic interpolation over x[i−1..i+2]
(Lagrange basis), all positions computed at once and the four taps gathered.

Static shapes: outputs-per-step is fixed by the rate algebra
(out = round(in / ratio) with the fractional phase carried in state).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_kernels import device_constant, frozen
from .iir import _f32
from .precision import check_f32_matmul


def farrow_init_state(channels: int, dtype: torch.dtype,
                      device: torch.device | str = "cpu") -> dict:
    hist_shape = (3,) if channels == 0 else (channels, 3)
    return {"hist": torch.zeros(hist_shape, dtype=dtype, device=device),
            "mu0": torch.zeros((), dtype=torch.float32, device=device)}


def farrow_apply(x: torch.Tensor, state: dict, *, ratio: float, n_out: int
                 ) -> tuple[torch.Tensor, dict]:
    """Resample ``x`` ([T] or [C, T]) by source-step ``ratio`` (in-samples per
    out-sample), producing exactly ``n_out`` samples.

    Caller guarantees n_out·ratio ≤ T (the rate algebra picks n_out =
    floor(T/ratio) with the residual phase carried in ``mu0``, float32 as in
    the JAX package). The interpolator is causal with a fixed latency of 2
    input samples (group delay), like any streaming fractional-delay filter.
    """
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    hist = state["hist"]
    h2 = hist[None, :] if squeeze else hist
    xc = torch.cat([h2.to(x2.dtype), x2], dim=-1)     # 3 prehistory samples
    t_in = x2.shape[-1]
    step = _f32(ratio)

    m = torch.arange(n_out, dtype=torch.float32, device=x.device)
    p = state["mu0"].to(torch.float32) + m * step
    i = torch.floor(p).to(torch.int32)                # 0-based into x2
    mu = p - i.to(torch.float32)
    # causal window: interpolate at source position (p − 2) using
    # x[i−3..i] ⇔ xc[i..i+3] (xc[j] = x[j−3]). Indices are taken as
    # jnp.take_along_axis(mode="clip") takes them: a negative one counts from
    # the end first, then all clamp to the buffer. After a step whose n_out·
    # ratio fell short of T the carried μ0 is negative, i = −1 for the first
    # output, and its x[i−3] tap reads the block's last sample in both
    # packages
    size = xc.shape[-1]

    def tap(k):
        j = i.to(torch.int64) + k
        return xc[..., torch.where(j < 0, j + size, j).clamp(0, size - 1)]

    xm1, x0, x1, x2_ = tap(0), tap(1), tap(2), tap(3)
    mu = mu[None, :]
    # cubic Lagrange basis
    c_m1 = -mu * (mu - 1.0) * (mu - 2.0) / 6.0
    c_0 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) / 2.0
    c_1 = -(mu + 1.0) * mu * (mu - 2.0) / 2.0
    c_2 = (mu + 1.0) * mu * (mu - 1.0) / 6.0
    y = c_m1 * xm1 + c_0 * x0 + c_1 * x1 + c_2 * x2_
    # carry: next step's phase offset and last 3 samples; n_out·ratio is a
    # float32 product on the host, as the JAX package's float32 scalars
    new_mu0 = state["mu0"] + float(np.float32(n_out) * np.float32(step))
    new_mu0 = new_mu0 - float(t_in)   # relative to the next block's start
    new_hist = xc[..., -3:]
    if squeeze:
        y = y[0]
        new_hist = new_hist[0]
    return y.to(x.dtype), {"hist": new_hist.clone(), "mu0": new_mu0}


@functools.lru_cache(maxsize=64)
def _goertzel_weights(n: int, coeff: float) -> np.ndarray:
    """[n, 2] weights of the Goertzel recurrence's final carry: with
    c = coeff/2 and U_k the Chebyshev polynomials of the second kind
    (U_{−1} = 0, U_0 = 1, U_{k+1} = 2c·U_k − U_{k−1}), s[m] = Σ_{j≤m}
    x[j]·U_{m−j}(c), so s1 = s[n−1] takes U_{n−1−j} and s2 = s[n−2] takes
    U_{n−2−j}. Built in float64 from the float32 coefficient the recurrence
    uses."""
    u = np.zeros(n + 1, np.float64)       # u[k + 1] = U_k(c)
    u[1] = 1.0
    for k in range(1, n):
        u[k + 1] = coeff * u[k] - u[k - 1]
    w = np.stack([u[n:0:-1], u[n - 1::-1]], axis=1)
    return frozen(np.ascontiguousarray(w, np.float32))


def goertzel_power(x: torch.Tensor, *, freq: float, sample_rate: float
                   ) -> torch.Tensor:
    """Single-bin DFT power of the Goertzel recurrence s0 = x + coeff·s1 − s2.

    x: [..., T] → power per leading index, normalized like an FFT bin:
    |Σ x[n]·e^{-j2πfn/fs}|² / T²·4. The recurrence is linear, so its final
    carry (s1, s2) is one [..., T] × [T, 2] float32 product with the
    Chebyshev weights of :func:`_goertzel_weights` — no loop over samples.
    """
    t = x.shape[-1]
    w = 2.0 * np.pi * freq / sample_rate
    coeff = _f32(2.0 * np.cos(w))
    check_f32_matmul("goertzel_power")
    s = x.to(torch.float32) @ device_constant(_goertzel_weights(t, coeff),
                                              x.device)
    s1, s2 = s[..., 0], s[..., 1]
    power = s1 * s1 + s2 * s2 - coeff * s1 * s2
    return power / _f32(t * t / 4.0)


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
