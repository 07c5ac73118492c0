"""Polyphase filter-bank (PFB) channelizer / synthesizer.

Critically sampled M-channel analysis bank:

    X[n, p] = x[nM + p]                                  (corner turn, reshape)
    v[n, p] = Σ_j h[jM + p] · X[n−j, p]                  (M branch FIRs of P taps)
    y[n, m] = FFT_p(v[n, ·])[m]                          (batched FFT)

Channel m is centered at m·fs/M, output rate fs/M. The branch FIRs are P
elementwise multiply-adds over the corner-turned rows (the JAX package's
``branch_fir_macs``; real taps act on the float32 view of the complex rows),
and the FFT across the branch axis is ``torch.fft`` (cuFFT on the card). The
weighted overlap-add synthesis bank inverts it (channel → wideband).
"""

from __future__ import annotations

import numpy as np
import torch

from . import filter_design as fd


def design_pfb_taps(n_channels: int, taps_per_phase: int = 8, *,
                    beta: float = 9.6, rolloff: float = 1.0) -> np.ndarray:
    """Prototype low-pass for an M-channel PFB: cutoff fs/(2M), length M·P."""
    m = n_channels
    ntaps = m * taps_per_phase
    if ntaps % 2 == 0:
        ntaps += 1
    h = fd.design_fir("lowpass", ntaps, sample_rate=float(m),
                      f_low=0.5 * rolloff, window="Kaiser", beta=beta)
    return np.pad(h, (0, m * taps_per_phase + m - len(h)))[: m * taps_per_phase]


def branch_fir_macs(xc: torch.Tensor, hp: torch.Tensor, r: int) -> torch.Tensor:
    """Per-branch FIR via shift-multiply-accumulate.

    xc: [..., P−1+R, M] rows-with-history; hp: [P, M] real branch taps →
    [..., R, M]: ``v[n, p] = Σ_j hp[j, p]·xc[n + (P−1) − j, p]``, summed in j
    order."""
    p = hp.shape[0]
    cplx = xc.is_complex()
    xr = torch.view_as_real(xc) if cplx else xc
    h = hp.to(xr.dtype)
    if cplx:
        h = h[..., None]                  # real taps on both rails
    acc = None
    for j in range(p):
        seg = xr[..., (p - 1 - j): (p - 1 - j) + r, :, :] if cplx \
            else xr[..., (p - 1 - j): (p - 1 - j) + r, :]
        term = seg * h[j]
        acc = term if acc is None else acc.add_(term)
    return torch.view_as_complex(acc) if cplx else acc


def pfb_init_state(n_channels: int, taps_per_phase: int,
                   device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Branch FIR history: [taps_per_phase-1, M] previous corner-turn rows."""
    return torch.zeros((taps_per_phase - 1, n_channels), dtype=dtype,
                       device=device)


def _branch_taps(taps, p: int, m: int, device: torch.device,
                 scale: float = 1.0) -> torch.Tensor:
    """Prototype taps h[j·M + p] → [P, M] float32 on ``device``."""
    if torch.is_tensor(taps):
        t = taps.to(device=device, dtype=torch.float32)
    else:
        t = torch.from_numpy(np.asarray(taps, np.float32)).to(device)
    hp = t.reshape(p, m)
    return hp * scale if scale != 1.0 else hp


def pfb_analyze(x: torch.Tensor, taps, state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analysis channelizer step.

    x: [T] complex with T % M == 0; taps: [M·P] prototype (host or tensor);
    state: [P-1, M]. Returns (channels [M, T//M], new_state)."""
    m = state.shape[-1]
    p = state.shape[0] + 1
    rows = x.reshape(-1, m)                           # [T/M, M] corner turn
    r = rows.shape[0]
    xc = torch.cat([state.to(rows.dtype), rows], dim=0)   # [P-1+T/M, M]
    v = branch_fir_macs(xc, _branch_taps(taps, p, m, x.device), r)
    # channel m (centered at +m·fs/M) picks the e^{-j2πpm/M} combination → FFT.
    # branch gain ≈ 1/M (prototype sums to 1) × FFT sum M → unity channel gain.
    y = torch.fft.fft(v, dim=-1)
    new_state = xc[r:].clone()
    return y.t().contiguous().to(torch.complex64), new_state


def pfb_synthesize(channels: torch.Tensor, taps, state: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesis bank (inverse): channels [M, N] → wideband [N·M].

    FFT across channels, branch-filter each phase, interleave. State: [P-1, M].
    """
    m, n = channels.shape
    p = state.shape[0] + 1
    # inverse of the analysis FFT: IFFT·M recovers the branch signals
    rows = torch.fft.ifft(channels.t(), dim=-1) * m          # [N, M]
    xc = torch.cat([state.to(rows.dtype), rows], dim=0)
    v = branch_fir_macs(xc, _branch_taps(taps, p, m, channels.device, m), n)
    new_state = xc[n:].clone()
    return v.reshape(-1).to(torch.complex64), new_state


def channel_center_freqs(n_channels: int, sample_rate: float) -> np.ndarray:
    """Center frequency of each channel (FFT bin convention, wraps at fs/2)."""
    return np.fft.fftfreq(n_channels, d=1.0 / sample_rate)
