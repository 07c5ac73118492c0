"""Rational polyphase resampling (≈ reference Decimator/interpolation
capabilities; GR4 expresses rate change via Resampling<in,out> chunk policy,
Block.hpp:1611 — the polyphase math is what this module provides).

Two forms of the L/M resampler, both exact across block boundaries (the state
carries the FIR history, overlap-save):

- ``interleave``: up-by-L as L phase FIRs through ``fir_apply`` (the banded
  kernel on the card), interleaved, then every M-th sample;
- ``matmul``: one banded matmul over overlapping frames
  (``fir.fir_resample_matmul``), when M divides the step.

``auto`` decides from the tensor's device: on the CPU it is the JAX package's
CPU choice (``interleave``); on CUDA it is ``matmul``, the faster form at suite
config 2's shape on the H100 (timed by ``chip_smoke.py``). L == 1 is a
decimating FIR.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from . import filter_design as fd
from .fir import (fir_apply, fir_init_state, fir_interpolate,
                  fir_resample_matmul)

def design_resampler_taps(interp: int, decim: int, *, ntaps_per_phase: int = 16,
                          beta: float = 8.6, rolloff: float = 0.8) -> np.ndarray:
    """Kaiser low-pass at min(fs/2L, fs/2M) on the upsampled grid."""
    L, M = interp, decim
    ntaps = ntaps_per_phase * max(L, 1)
    if ntaps % 2 == 0:
        ntaps += 1
    fs_up = float(L)
    fc = 0.5 * rolloff / max(L, M)  # cycles/sample on the upsampled grid
    return fd.design_fir("lowpass", ntaps, sample_rate=fs_up, f_low=fc * fs_up,
                         window="Kaiser", beta=beta)


class RationalResamplerKernel:
    """Taps and shapes of an L/M polyphase resampler (stateless: the caller
    carries the history)."""

    def __init__(self, interp: int, decim: int, taps: np.ndarray | None = None,
                 ntaps_per_phase: int = 16):
        frac = Fraction(interp, decim)
        self.interp = frac.numerator
        self.decim = frac.denominator
        if taps is None:
            taps = design_resampler_taps(self.interp, self.decim,
                                         ntaps_per_phase=ntaps_per_phase)
        self.taps = np.asarray(taps)
        self.k_per_phase = -(-len(self.taps) // max(self.interp, 1))

    @property
    def ratio(self) -> Fraction:
        return Fraction(self.interp, self.decim)

    def init_state(self, channels: int, dtype,
                   device: torch.device | str = "cpu") -> torch.Tensor:
        ntaps_eff = self.k_per_phase if self.interp > 1 else len(self.taps)
        return fir_init_state(channels, ntaps_eff, dtype, device)

    def apply(self, x: torch.Tensor, state: torch.Tensor, *,
              method: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
        L, M = self.interp, self.decim
        # complex taps only for a complex stream (as the JAX package); real
        # taps stay real there: the same sums without the zero imaginary rail
        cx_taps = x.is_complex() and np.iscomplexobj(self.taps)
        taps = self.taps.astype(np.complex64 if cx_taps else np.float32)
        if L == 1:
            return fir_apply(x, taps, state, decim=M)
        t = x.shape[-1]
        if method == "auto":
            # suite config 2's shape (3/2, 2^22 real samples per step) on an
            # NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6): matmul 0.2886 ms
            # against interleave 0.4323
            method = "matmul" if x.is_cuda else "interleave"
        if method == "matmul" and t % M == 0:
            squeeze = x.ndim == 1
            x2 = x[None] if squeeze else x
            st2 = state[None] if squeeze else state
            xc = torch.cat([st2.to(x2.dtype), x2], dim=-1)
            y = fir_resample_matmul(xc, taps, L, M)
            kp = self.k_per_phase
            new_state = xc[:, xc.shape[-1] - (kp - 1):].clone()
            if squeeze:
                return y[0], new_state[0]
            return y, new_state
        y_up, new_state = fir_interpolate(x, taps, state, L)
        if M > 1:
            y_up = y_up[..., ::M]
        return y_up, new_state
